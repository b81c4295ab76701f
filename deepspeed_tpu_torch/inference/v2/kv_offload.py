"""Paged-KV host offload: a device-resident block cache over host memory.

Own copy of ``deepspeed_tpu/inference/v2/kv_offload.py`` (ZeRO-Inference's
KV-cache offload) in PyTorch. The logical block space (what the
``BlockedAllocator`` hands out and sequences' block tables reference)
lives in HOST memory; the device holds ``device_blocks`` physical slots
per layer pool, managed as an LRU cache. Context length x concurrent
streams is then bounded by host memory, not device memory.

Mechanics:
  * The host store is ONE tensor, block-major: ``(NL, L, 2, KVH, BS, hd)``
    (every layer's K and V of one logical block contiguous, so a block
    moves in one copy). On a card it is pinned, so copies to and from it
    are asynchronous DMA.
  * ``prepare(logical_ids)`` stages the uploads of the blocks that are not
    resident: on a side CUDA stream, one H2D copy per block into a fresh
    device staging tensor, then an event. It touches no slot map.
  * ``ensure(cache, logical_ids, prepared)`` makes the blocks resident:
    LRU victims (slot 0 excluded) that are dirty are first copied back to
    the host (gathered per layer pool, then one D2H copy a block, all on
    the compute stream, so after the dispatch that wrote them), the
    compute stream waits on the upload's event, and the staging is
    scattered into each layer's pool (``index_copy_``).
  * Dispatches reference DEVICE slots: the engine translates each step's
    block tables through ``translate``; blocks a dispatch writes are
    ``mark_dirty``: their device copy is authoritative until eviction
    writes them back.
  * A side-stream upload never reads a host block before the write-back
    that filled it: each write-back records an event on the compute
    stream that the side stream waits on before its next uploads.
  * Device slot 0 is pinned to logical block 0 (the scratch block every
    padded table position points at) and never evicted.

On CPU tensors (the tests) the same code runs with synchronous copies and
no streams. ``timing = True`` records CUDA events around every upload and
write-back; ``transfer_stats()`` sums them (it synchronizes).
"""

import numpy as np
import torch

__all__ = ["OffloadKVPool"]


class OffloadKVPool:
    def __init__(self, model, num_logical, device_blocks, block_size,
                 dtype, device):
        if device_blocks < 2:
            raise ValueError("device_kv_blocks must be >= 2 (slot 0 is "
                             "the pinned scratch block)")
        cfg = model.config
        self.NL = int(num_logical)
        self.D = int(device_blocks)
        self.block_size = int(block_size)
        self.n_layer = cfg.n_layer
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        # the per-layer pools' block shape, (KVH, BS, hd) for the Llama
        # family and (H, BS, hd) for GPT-2's, probed from the model's own
        # cache as the JAX pool does (kv_offload.py:57-60)
        probe = model.init_paged_cache(1, self.block_size, dtype=dtype)
        self._blk_shape = tuple(probe["k"][0].shape[1:])
        del probe
        self.host = torch.zeros(
            (self.NL, self.n_layer, 2) + self._blk_shape, dtype=dtype,
            pin_memory=self._cuda)
        self.block_bytes = self.host[0].numel() * self.host.element_size()

        # slot maps: device slot -> logical block (or -1), and inverse
        self.logical_of = np.full((self.D,), -1, np.int64)
        self.slot_of = np.full((self.NL,), -1, np.int64)
        self.dirty = np.zeros((self.D,), bool)
        self.last_used = np.zeros((self.D,), np.int64)
        self._tick = 0
        # pin scratch
        self.logical_of[0] = 0
        self.slot_of[0] = 0

        self._side = torch.cuda.Stream(self.device) if self._cuda else None
        self._host_ready = None       # event after the last write-back
        self.timing = False
        self._timed = []              # (kind, start, end, bytes)
        self.swapped_in = 0           # blocks uploaded (stats)
        self.swapped_out = 0          # dirty blocks written back

    @property
    def pinned_bytes(self):
        """Bytes of pinned host memory the pool holds (0 on the CPU)."""
        return self.host.numel() * self.host.element_size() \
            if self._cuda else 0

    def _events(self, stream):
        if not (self._cuda and self.timing):
            return None
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        return start

    def _close(self, kind, start, stream, n):
        if start is None:
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
        self._timed.append((kind, start, end, n * self.block_bytes))

    def transfer_stats(self):
        """{"h2d" | "d2h": {"bytes", "s"}} over the timed copies since the
        last call (synchronizes the device)."""
        out = {k: {"bytes": 0, "s": 0.0} for k in ("h2d", "d2h")}
        if self._timed:
            torch.cuda.synchronize(self.device)
        for kind, start, end, nbytes in self._timed:
            out[kind]["bytes"] += nbytes
            out[kind]["s"] += start.elapsed_time(end) / 1e3
        self._timed = []
        return out

    # ------------------------------------------------------------ prefetch
    def prepare(self, logical_ids, skip_upload=()):
        """Stage the uploads of the blocks in ``logical_ids`` that are NOT
        resident (on the side stream on a card). Returns an opaque handle
        ``ensure`` accepts (None when nothing is missing); no slot map
        changes. ``skip_upload``: blocks the coming dispatch fully
        overwrites (never-written prefill / chunk destinations); they are
        left out here and get bare slots in ``ensure``."""
        skip = {int(b) for b in skip_upload}
        missing = [b for b in dict.fromkeys(int(b) for b in logical_ids)
                   if self.slot_of[b] < 0 and b not in skip]
        if not missing:
            return None
        shape = (len(missing),) + tuple(self.host.shape[1:])
        if not self._cuda:
            return missing, self.host[missing].clone(), None
        side = self._side
        if self._host_ready is not None:
            side.wait_event(self._host_ready)
        # allocated on the side stream (memory no queued compute work still
        # uses), read later on the compute stream
        with torch.cuda.stream(side):
            staging = torch.empty(shape, dtype=self.host.dtype,
                                  device=self.device)
            start = self._events(side)
            for j, b in enumerate(missing):
                staging[j].copy_(self.host[b], non_blocking=True)
            self._close("h2d", start, side, len(missing))
            done = torch.cuda.Event()
            done.record(side)
        staging.record_stream(torch.cuda.current_stream(self.device))
        return missing, staging, done

    # -------------------------------------------------------------- ensure
    def ensure(self, cache, logical_ids, prepared=None, skip_upload=()):
        """Make every block in ``logical_ids`` device-resident; returns the
        cache (its pools are updated in place). ``prepared``: the
        ``prepare`` handle of this block list (uploads already in flight).
        ``skip_upload``: see ``prepare``; such blocks get slots but no data
        transfer."""
        need = list(dict.fromkeys(int(b) for b in logical_ids))
        self._tick += 1
        if prepared is None:
            prepared = self.prepare(need, skip_upload)
        need_set = set(need)
        skip = [b for b in dict.fromkeys(int(b) for b in skip_upload)
                if self.slot_of[b] < 0 and b in need_set]
        missing, staging, done = prepared if prepared is not None \
            else ([], None, None)
        if not missing and not skip:
            self._check_resident(need)
            for b in need:
                self.last_used[self.slot_of[b]] = self._tick
            return cache
        if len(need) > self.D - 1:
            raise ValueError(
                f"dispatch references {len(need)} KV blocks but the "
                f"device pool holds only {self.D - 1} (+scratch); raise "
                f"device_kv_blocks or lower concurrency/context")

        # victims: LRU over slots not referenced by this ensure, slot 0
        # excluded
        needed_slots = {int(self.slot_of[b]) for b in need
                        if self.slot_of[b] >= 0}
        free = [s for s in range(1, self.D)
                if self.logical_of[s] < 0 and s not in needed_slots]
        evictable = sorted(
            (s for s in range(1, self.D)
             if self.logical_of[s] >= 0 and s not in needed_slots),
            key=lambda s: self.last_used[s])

        def take_slot():
            if free:
                return free.pop()
            if evictable:
                return evictable.pop(0)
            raise ValueError(
                "KV device pool exhausted mid-ensure (should be "
                "unreachable given the size check above)")

        slots = [take_slot() for _ in missing]
        skip_slots = [take_slot() for _ in skip]

        # write back dirty victims before their slots are overwritten
        dirty_slots = [s for s in slots + skip_slots
                       if self.logical_of[s] >= 0 and self.dirty[s]]
        if dirty_slots:
            self._writeback(cache, dirty_slots)
        for s in slots + skip_slots:
            old = self.logical_of[s]
            if old >= 0:
                self.slot_of[old] = -1
            self.logical_of[s] = -1
            self.dirty[s] = False

        if missing:
            if done is not None:
                torch.cuda.current_stream(self.device).wait_event(done)
            idx = torch.as_tensor(slots, dtype=torch.long,
                                  device=self.device)
            with torch.inference_mode():
                for li in range(self.n_layer):
                    cache["k"][li].index_copy_(0, idx, staging[:, li, 0])
                    cache["v"][li].index_copy_(0, idx, staging[:, li, 1])
        for b, s in zip(list(missing) + skip, slots + skip_slots):
            self.logical_of[s] = b
            self.slot_of[b] = s
        # a stale ``prepared`` handle (built for another block list) can
        # leave a needed block without a slot; translate() would route its
        # reads to the scratch slot and the dispatch would attend garbage
        self._check_resident(need)
        for b in need:
            self.last_used[self.slot_of[b]] = self._tick
        self.swapped_in += len(missing)
        return cache

    def _check_resident(self, need):
        stale = [b for b in need if self.slot_of[b] < 0]
        if stale:
            raise RuntimeError(
                f"ensure() commit left blocks {stale} without device "
                "slots — the prepared handle was built for a different "
                "block list (stale prepare()); re-prepare with the "
                "dispatch's actual blocks")

    def _writeback(self, cache, slots):
        """Copy dirty device slots back to their host blocks, in stream
        order after every dispatch already queued (the ones that wrote
        them)."""
        stream = torch.cuda.current_stream(self.device) if self._cuda \
            else None
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        wb = torch.empty((len(slots),) + tuple(self.host.shape[1:]),
                         dtype=self.host.dtype, device=self.device)
        with torch.inference_mode():
            for li in range(self.n_layer):
                wb[:, li, 0] = cache["k"][li].index_select(0, idx)
                wb[:, li, 1] = cache["v"][li].index_select(0, idx)
            start = self._events(stream)
            for j, s in enumerate(slots):
                self.host[int(self.logical_of[s])].copy_(
                    wb[j], non_blocking=self._cuda)
            self._close("d2h", start, stream, len(slots))
        for s in slots:
            self.dirty[s] = False
        if self._cuda:
            self._host_ready = torch.cuda.Event()
            self._host_ready.record(stream)
        self.swapped_out += len(slots)

    # ------------------------------------------------------------- helpers
    def translate(self, logical_ids):
        """logical block ids (any numpy shape) -> device slot ids.
        Unresident blocks map to scratch 0: callers ``ensure`` everything
        a dispatch reads or writes first."""
        ids = np.asarray(logical_ids, np.int64)
        out = self.slot_of[ids]
        return np.where(out < 0, 0, out).astype(np.int32)

    def mark_dirty(self, logical_ids):
        for b in dict.fromkeys(int(b) for b in np.asarray(
                logical_ids).reshape(-1)):
            s = self.slot_of[b]
            if s > 0:
                self.dirty[s] = True

    def release(self, logical_ids):
        """A retired sequence's blocks: drop residency, nothing to keep."""
        for b in dict.fromkeys(int(b) for b in logical_ids):
            s = self.slot_of[b]
            if s > 0:
                self.logical_of[s] = -1
                self.slot_of[b] = -1
                self.dirty[s] = False
