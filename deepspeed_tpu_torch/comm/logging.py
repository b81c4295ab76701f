"""Communication volume logger.

Counterpart of ``deepspeed_tpu/comm/logging.py`` (the reference's
``utils/comms_logging.py:67 CommsLogger``). The JAX package records
(op, bytes, axis) when a collective is traced; the port's collectives run
eagerly, so each call records its payload's bytes when it runs, and
``log_summary`` prints the same table.

Beside the volumes it keeps ``host_staged``: every payload that the comm
layer copied through host memory because the backend (gloo) does not take
that op on CUDA tensors (comm.py ``GLOO_CUDA_OPS``). That record is kept
whether or not logging is enabled, so a run can always show that it did.
"""

from collections import defaultdict

from ..utils.logging import log_dist


class CommsLogger:
    def __init__(self):
        self.enabled = False
        self.verbose = False
        self.prof_all = True
        self.comms_dict = defaultdict(lambda: defaultdict(lambda: [0, 0]))
        self.host_staged = defaultdict(lambda: [0, 0])

    def configure(self, cfg):
        self.enabled = getattr(cfg, "enabled", False)
        self.verbose = getattr(cfg, "verbose", False)
        self.prof_all = getattr(cfg, "prof_all", True)

    def append(self, op_name, nbytes, axis_name):
        rec = self.comms_dict[op_name][str(axis_name)]
        rec[0] += 1
        rec[1] += nbytes
        if self.verbose:
            log_dist(f"comm op: {op_name} | axis: {axis_name} | bytes: "
                     f"{nbytes}", ranks=[0])

    def append_host_staged(self, op_name, nbytes):
        rec = self.host_staged[op_name]
        rec[0] += 1
        rec[1] += nbytes

    def reset(self):
        self.comms_dict.clear()
        self.host_staged.clear()

    def log_summary(self, show_straggler=False):
        log_dist("Communication summary (bytes of each call's payload):",
                 ranks=[0])
        header = f"{'Op':<20}{'Axis':<24}{'Count':>8}{'Total bytes':>16}"
        log_dist(header, ranks=[0])
        for op, axes in sorted(self.comms_dict.items()):
            for axis, (count, nbytes) in sorted(axes.items()):
                log_dist(f"{op:<20}{axis:<24}{count:>8}{nbytes:>16,}",
                         ranks=[0])
        for op, (count, nbytes) in sorted(self.host_staged.items()):
            log_dist(f"{op:<20}{'(through host memory)':<24}{count:>8}"
                     f"{nbytes:>16,}", ranks=[0])

    def total_bytes(self):
        return sum(nbytes for axes in self.comms_dict.values()
                   for (_, nbytes) in axes.values())


_LOGGER = CommsLogger()


def get_comms_logger():
    return _LOGGER
