"""Worker processes for the port's multi-process tests; holds no tests.

``run_world(suite, world, inputs, tmpdir)`` starts ``world`` processes of

    python tests/test_torch_dist_worker.py <suite> <tmpdir>

with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` set. Each joins a gloo world on the CPU through
``deepspeed_tpu_torch.comm.init_distributed`` (``env://``), runs the suite
on the inputs the parent saved (numpy arrays), and saves its results; the
parent returns them in rank order. The workers import ``torch`` and the
port only, never ``jax`` or the JAX package (each result says whether one
got imported).

The ``*_program`` functions take a comm module and run the same calls on
either side: the parent passes ``deepspeed_tpu.comm`` inside a JAX
``shard_map`` body, the workers ``deepspeed_tpu_torch.comm`` on their
rank's block.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One intra-op thread a process, in the test processes that import this
# module and in the workers it starts. The suite runs several pytest
# processes on one host (and each imports every test module), so a pool
# of one thread a core in each of them oversubscribes the cores many
# times over; the tests' tiny shapes gain nothing from a pool.
torch.set_num_threads(1)


# ----------------------------------------------------------------- programs

def comm_program(c, x, world):
    """Every comm op over the data axes on this rank's block ``x`` (4, 6)
    float32; ``world`` > 2 lays the ranks out as data_outer=2 x data."""
    out = {
        "sum": c.all_reduce(x, "data"),
        "avg": c.all_reduce(x, "data", op="avg"),
        "max": c.all_reduce(x, "data", op="max"),
        "min": c.all_reduce(x, "data", op="min"),
        "rs0": c.reduce_scatter(x, "data", scatter_dimension=0),
        "rs1": c.reduce_scatter(x[:, :4], "data", scatter_dimension=1),
        "ag0": c.all_gather(x, "data", gather_dimension=0),
        "ag1": c.all_gather(x, "data", gather_dimension=1),
        "a2a": c.all_to_all(x, "data", 0, 1),
        "a2a_back": c.all_to_all(x[:, :4], "data", 1, 0),
        "bcast": c.broadcast(x, "data", src=1),
        "fwd": c.send_forward(x, "data"),
        "bwd": c.send_backward(x, "data"),
        "perm": c.ppermute(x, "data", [(0, 1)]),
        "index": x * 0 + c.axis_index("data"),
    }
    if world > 2:
        both = ("data_outer", "data")
        out.update({
            "sum_both": c.all_reduce(x, both),
            "ag_both": c.all_gather(x, both, gather_dimension=1),
            "rs_outer": c.reduce_scatter(x, "data_outer"),
            "index_both": x * 0 + c.axis_index(both),
        })
    return out


def quant_program(q, x, world):
    """The four quantized collectives (``q``: a ``comm.quantized``
    module) on this rank's block ``x`` (N,) float32."""
    return {
        "rs": q.quantized_reduce_scatter(x, "data"),
        "rs_avg": q.quantized_reduce_scatter(x.reshape(-1, 10), "data",
                                             average=True),
        "ag": q.quantized_all_gather(x, "data"),
        "ag_small": q.quantized_all_gather(x[:100], "data", block=64),
        "clamp": q.dcn_precision_clamp(x),
        "hier": q.all_to_all_quant_reduce(x, "data", "data_outer"),
        "hier_avg": q.all_to_all_quant_reduce(x, "data", "data_outer",
                                              average=True, block=256),
    }


# ------------------------------------------------------------------ parent

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(suite, world, inputs, tmpdir, timeout=300):
    """Run ``suite`` on ``world`` gloo ranks; returns their results."""
    import torch
    tmpdir = str(tmpdir)
    os.makedirs(tmpdir, exist_ok=True)
    torch.save(inputs, os.path.join(tmpdir, "inputs.pt"))
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=ROOT)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), suite, tmpdir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode]
    assert not bad, f"{suite} world {world}: ranks {bad} failed:\n" + \
        "\n".join(log[-3000:] for log in logs)
    outs = [torch.load(os.path.join(tmpdir, f"out_{r}.pt"),
                       weights_only=False) for r in range(world)]
    for r, o in enumerate(outs):
        assert o["isolated"], f"rank {r} imported jax or deepspeed_tpu"
    return outs


# ----------------------------------------------------------------- workers

SUITES = {}


def _suite(fn):
    SUITES[fn.__name__] = fn
    return fn


def _np(tree):
    import torch
    if torch.is_tensor(tree):
        return tree.detach().float().numpy() if tree.dtype in (
            torch.bfloat16, torch.float16) else tree.detach().numpy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return tree


def _topology(**kw):
    from deepspeed_tpu_torch.utils import groups
    groups.reset()
    return groups.initialize(groups.TopologyConfig(**kw))


@_suite
def comm(inp, rank, world):
    import torch
    from deepspeed_tpu_torch import comm as c
    from deepspeed_tpu_torch.comm import get_comms_logger
    from deepspeed_tpu_torch.runtime.config import CommsLoggerConfig
    _topology(zero_shard_size=2 if world > 2 else -1)
    lg = get_comms_logger()
    lg.reset()
    lg.configure(CommsLoggerConfig(enabled=True))
    res = comm_program(c, torch.from_numpy(inp["x"][rank]), world)
    log = {op: {ax: list(v) for ax, v in axes.items()}
           for op, axes in lg.comms_dict.items()}
    lg.configure(CommsLoggerConfig(enabled=False))
    payload = bytes([rank]) * (3 * rank)           # rank 0 sends b""
    c.barrier()
    return {"res": _np(res), "log": log,
            "ring": c.ring_exchange_bytes(payload),
            "ring2": c.ring_exchange_bytes(payload, shift=2 % world),
            "gather": c.allgather_bytes(payload),
            "rank": c.get_rank(), "world": c.get_world_size()}


@_suite
def quant(inp, rank, world):
    import torch
    from deepspeed_tpu_torch.comm import get_comms_logger
    from deepspeed_tpu_torch.comm import quantized as q
    from deepspeed_tpu_torch.runtime.config import CommsLoggerConfig
    _topology(zero_shard_size=2 if world > 2 else -1)
    lg = get_comms_logger()
    lg.reset()
    lg.configure(CommsLoggerConfig(enabled=True))
    res = quant_program(q, torch.from_numpy(inp["x"][rank]), world)
    log = {op: {ax: list(v) for ax, v in axes.items()}
           for op, axes in lg.comms_dict.items()}
    return {"res": _np(res), "log": log}


def _attn_grads(fn, q, k, v, do):
    import torch
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    o = fn(q, k, v)
    grads = torch.autograd.grad(o, (q, k, v), do)
    return {"o": o, "dq": grads[0], "dk": grads[1], "dv": grads[2]}


@_suite
def ring(inp, rank, world):
    import torch
    from deepspeed_tpu_torch.sequence import ring_attention
    from deepspeed_tpu_torch.sequence.layer import shard_sequence
    from deepspeed_tpu_torch.sequence.ring import ring_attention_sharded
    _topology(seq_parallel_size=world)
    q, k, v, do = (shard_sequence(torch.from_numpy(inp[n]))
                   for n in ("q", "k", "v", "do"))
    out = {}
    for name, kw in inp["cases"].items():
        out[name] = _attn_grads(
            lambda a, b, c: ring_attention(a, b, c, "seq", **kw), q, k, v, do)
    # the global-tensor entry: the gathered output on every rank
    g = [torch.from_numpy(inp[n]) for n in ("q", "k", "v")]
    out["sharded"] = ring_attention_sharded(*g, block_kernel=False)
    return {"res": _np(out)}


@_suite
def ulysses(inp, rank, world):
    import torch
    from deepspeed_tpu_torch.sequence import (DistributedAttention,
                                              ulysses_attention)
    from deepspeed_tpu_torch.sequence.layer import (_dense_causal_attention,
                                                    shard_sequence)
    _topology(seq_parallel_size=world)
    q, k, v, do = (shard_sequence(torch.from_numpy(inp[n]))
                   for n in ("q", "k", "v", "do"))
    dist_attn = DistributedAttention(_dense_causal_attention, "seq")
    out = {"local": _attn_grads(dist_attn, q, k, v, do),
           "sharded": ulysses_attention(
               *(torch.from_numpy(inp[n]) for n in ("q", "k", "v")))}
    return {"res": _np(out)}


def _gpt2(cfg, params):
    import torch
    from deepspeed_tpu_torch.models import (GPT2, GPT2Config,
                                            gpt2_params_from_numpy)
    model = GPT2(GPT2Config(**cfg), device="cpu")
    model.load_state_dict(gpt2_params_from_numpy(params, "cpu",
                                                 torch.float32))
    return model


@_suite
def gpt2(inp, rank, world):
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime.config import SequenceConfig
    _topology(seq_parallel_size=world)
    ids = torch.from_numpy(inp["ids"])
    out = {}
    for name, cfg in inp["models"].items():
        model = _gpt2(cfg, inp["params"])
        model._sequence_cfg = SequenceConfig(**inp["sequence"])
        loss = model.loss({"input_ids": ids}, seq_sharded=True)
        loss.backward()
        out[name] = {"loss": loss.detach(),
                     "grads": {n: p.grad for n, p in
                               model.named_parameters()}}
    for name, run in inp.get("engines", {}).items():
        model = _gpt2(run["model"], run["params"])
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=model, config=run["config"], device="cpu")
        assert engine.seq_parallel == world
        assert engine.model._sequence_cfg.block_kernel is False
        losses = [engine.train_batch(b) for b in run["batches"]]
        out[name] = {"losses": losses, "master": engine.state["master"]}
    if not inp.get("moe_dp", True):
        return {"res": _np(out)}
    # GPT2MoE over a data-parallel world of `world`: one step
    from deepspeed_tpu_torch.models import GPT2MoE, GPT2MoEConfig
    from deepspeed_tpu_torch.utils import groups
    groups.reset()
    cfg = dict(inp["models"]["dense"], num_experts=2, moe_top_k=1,
               moe_backend="ragged")
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2MoE(GPT2MoEConfig(**cfg), device="cpu"),
        config={"train_micro_batch_size_per_gpu": 1, "optimizer": {
            "type": "Adam", "params": {"lr": 1e-3}}}, device="cpu")
    out["dp_run"] = {"dp": engine.dp, "axes": engine.model._moe_dp_axes,
                     "loss": engine.train_batch(
                         {"input_ids": ids.repeat(world, 1)[:world]})}
    return {"res": _np(out)}


def _local_state(engine):
    """This rank's saved leaves (master and moment shards, scale, steps,
    rng words) as numpy."""
    st = engine.state
    out = {f"master.{n}": m.numpy().copy() for n, m in st["master"].items()}
    for k in ("m", "v"):
        out.update({f"{k}.{n}": x.numpy().copy()
                    for n, x in st["opt"][k].items()})
    out.update({f"scale.{k}": v.numpy().copy()
                for k, v in st["scale"].items()})
    out.update(step=np.asarray(st["step"]),
               opt_step=st["opt"]["step"].numpy().copy(),
               rng=np.asarray(engine.rng_data).copy())
    return out


def _ckpt_runs(inp, engines, build=None):
    """Checkpoints at this world's dp: each engine of ``inp["ckpt"]
    ["names"]`` (after its run) saves a tag, a fresh engine loads it
    (explicit tag) and both take the ``next`` batch; a fresh engine also
    loads the JAX engine's tag of that run and takes the same batch."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.utils import groups
    spec = inp["ckpt"]
    out = {}
    for name in spec["names"]:
        run, engine = inp["runs"][name], engines[name]
        d = os.path.join(spec["dir"], name)
        tag = engine.save_checkpoint(d, client_state={"run": name})
        comm.barrier()
        saved = _local_state(engine)
        # a copy: at stage 0 gathered_master() is the live master
        master = {n: m.clone() for n, m in engine.gathered_master().items()}
        loss = engine.train_batch(spec["next"])

        def fresh():
            groups.reset()
            model = (build(run) if build
                     else _gpt2(run["model"], run["params"]))
            e, *_ = deepspeed_tpu_torch.initialize(
                model=model, config=run["config"], device="cpu")
            return e
        e2 = fresh()
        path, client = e2.load_checkpoint(d, tag=tag)
        steps = (e2.global_step, e2.micro_steps)
        got = _local_state(e2)
        same = (set(got) == set(saved) and all(
            got[k].dtype == saved[k].dtype and np.array_equal(got[k], saved[k])
            for k in saved))
        resumed = e2.train_batch(spec["next"])
        e3 = fresh()
        e3.load_checkpoint(spec["jax_dirs"][name])
        from_jax = e3.train_batch(spec["next"])
        out[name] = {
            "tag": tag, "client": client, "path": path,
            "global_step": steps[0], "micro_steps": steps[1],
            "state_bitwise": same, "master": master, "next_loss": loss,
            "resumed_loss": resumed, "from_jax_loss": from_jax,
            "from_jax_master": e3.gathered_master()}
    return out


@_suite
def zero(inp, rank, world):
    """Each run of ``inp["runs"]`` through initialize -> train_batch on
    this world (the engine builds its topology from the config): the
    losses and global gradient norms, each step's clipped gradients (what
    the optimizer is given, gathered whole), the gathered fp32 master,
    this rank's master and stage-3 parameter shard shapes; then, with
    ``inp["ckpt"]``, the checkpoint runs of ``_ckpt_runs``."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.utils import groups
    out, engines = {}, {}
    for name, run in inp["runs"].items():
        groups.reset()
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=_gpt2(run["model"], run["params"]), config=run["config"],
            device="cpu")
        engines[name] = engine
        steps = []
        unscale_clip = engine._unscale_clip

        def record(grads, scale, engine=engine, unscale_clip=unscale_clip,
                   steps=steps):
            got = unscale_clip(grads, scale)
            steps.append(_whole_grads(engine, got[0]))
            return got
        engine._unscale_clip = record
        losses, norms = [], []
        for b in run["batches"]:
            losses.append(engine.train_batch(b))
            norms.append(engine.get_global_grad_norm())
        out[name] = {
            "losses": losses, "grad_norms": norms, "grads": list(steps),
            # copies: at stage 0 gathered_master() is the live master,
            # which the checkpoint runs step on
            "master": {n: m.clone()
                       for n, m in engine.gathered_master().items()},
            "dp": engine.dp,
            "shard_shapes": {n: tuple(m.shape) for n, m in
                             engine.state["master"].items()},
            "param_shards": {n: tuple(p.shape) for n, p in
                             engine.state["param_shards"].items()}}
    if inp.get("ckpt"):
        out["ckpt"] = _ckpt_runs(inp, engines)
    return {"res": _np(out)}


def _gpt2_moe(cfg, params):
    import torch
    from deepspeed_tpu_torch.models import (GPT2MoE, GPT2MoEConfig,
                                            gpt2_moe_params_from_numpy)
    model = GPT2MoE(GPT2MoEConfig(**cfg), device="cpu")
    model.load_state_dict(gpt2_moe_params_from_numpy(params, "cpu",
                                                     torch.float32))
    return model


@_suite
def moe_dp(inp, rank, world):
    """GPT2MoE over a data-parallel world: first the aux loss of this
    rank's block of ``inp["aux"]["ids"]`` with the engine's dp axes (the
    global batch's) and without them (this rank's own), then each run of
    ``inp["runs"]`` through initialize -> train_batch with the losses,
    grad norms, each step's clipped gradients (gathered whole) and the
    gathered master, as the ``zero`` suite records them."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.utils import groups
    out = {}
    groups.reset()
    aux = inp["aux"]
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=_gpt2_moe(aux["model"], aux["params"]), config=aux["config"],
        device="cpu")
    ids = torch.from_numpy(aux["ids"])
    micro = ids.shape[0] // world
    r = engine.topology.axis_index(groups.BATCH_AXES)
    mine = ids[r * micro:(r + 1) * micro]
    with torch.no_grad():
        out["aux_axes"] = engine.model._moe_dp_axes
        out["aux_global"] = engine.model.hidden_with_aux(mine)[1]
        engine.model._moe_dp_axes = None
        out["aux_local"] = engine.model.hidden_with_aux(mine)[1]
    for name, run in inp["runs"].items():
        groups.reset()
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=_gpt2_moe(run["model"], run["params"]),
            config=run["config"], device="cpu")
        steps = []
        unscale_clip = engine._unscale_clip

        def record(grads, scale, engine=engine, unscale_clip=unscale_clip,
                   steps=steps):
            got = unscale_clip(grads, scale)
            steps.append(_whole_grads(engine, got[0]))
            return got
        engine._unscale_clip = record
        losses, norms = [], []
        for b in run["batches"]:
            losses.append(engine.train_batch(b))
            norms.append(engine.get_global_grad_norm())
        out[name] = {
            "losses": losses, "grad_norms": norms, "grads": list(steps),
            "dp": engine.dp,
            "master": {n: m.clone()
                       for n, m in engine.gathered_master().items()}}
    return {"res": _np(out)}


@_suite
def moe_dense_dp(inp, rank, world):
    """The GShard capacity gate and GPT2MoE's dense backend over a
    data-parallel world: each gate of ``inp["gates"]`` on this rank's rows
    of its global logits with the batch axes (the global batch's routing),
    then each run of ``inp["runs"]`` through initialize -> train_batch
    with the losses, grad norms, key words and the gathered master."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.moe import sharded_moe as sm
    from deepspeed_tpu_torch.utils import groups, prng
    out = {}
    topo = _topology()
    axes = tuple(a for a in groups.BATCH_AXES if topo.axis_size(a) > 1)
    r = topo.axis_index(axes)
    for name, g in inp["gates"].items():
        logits = torch.from_numpy(g["logits"])
        S = logits.shape[0] // world
        mine = logits[r * S:(r + 1) * S].clone().requires_grad_()
        key = prng.key_data(g["seed"])
        if g["k"] == 1:
            got = sm.top1gating(mine, g["cf"], g["mc"], g["policy"], key,
                                True, axes)
        else:
            got = sm.top2gating(mine, g["cf"], g["mc"], key, True,
                                g["sampling"], axes)
        got.l_aux.backward()
        out.setdefault("gates", {})[name] = {"capacity": got.capacity, "experts": got.experts,
                     "locations": got.locations, "slots": got.slots,
                     "weights": got.weights.detach(),
                     "l_aux": got.l_aux.detach(),
                     "l_aux_grad": mine.grad,
                     "exp_counts": got.exp_counts}
    for name, run in inp["runs"].items():
        groups.reset()
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=_gpt2_moe(run["model"], run["params"]),
            config=run["config"], device="cpu")
        losses, norms = [], []
        for b in run["batches"]:
            losses.append(engine.train_batch(b))
            norms.append(engine.get_global_grad_norm())
        out.setdefault("runs", {})[name] = {
            "losses": losses, "grad_norms": norms, "dp": engine.dp,
            "rng_data": engine.rng_data.copy(),
            "master": {n: m.clone()
                       for n, m in engine.gathered_master().items()}}
    return {"res": _np(out)}


def _model(run):
    """The port model of a run: ``run["kind"]`` gpt2 | gpt2_moe | mixtral
    from the JAX parameter tree ``run["params"]``, fp32 on the CPU."""
    import torch
    from deepspeed_tpu_torch.models import (Mixtral, MixtralConfig,
                                            mixtral_params_from_numpy)
    kind = run.get("kind", "gpt2")
    if kind == "gpt2":
        return _gpt2(run["model"], run["params"])
    if kind == "gpt2_moe":
        return _gpt2_moe(run["model"], run["params"])
    model = Mixtral(MixtralConfig(**run["model"]), device="cpu")
    model.load_state_dict(mixtral_params_from_numpy(run["params"], "cpu",
                                                    torch.float32))
    return model


def _whole_grads(engine, grads):
    """The clipped gradients made whole: the ZeRO partitions, then the
    expert leaves' experts, all-gathered."""
    from deepspeed_tpu_torch.runtime import engine as eng
    whole = {n: g.clone() for n, g in grads.items()}
    parts = engine.plan.parts["grad"]
    for axes, names in eng._by_axes(whole, parts).items():
        whole.update(zip(names, eng.flat_all_gather(
            [whole[n] for n in names], [parts[n][0] for n in names], axes)))
    ex = engine._expert
    for axes, names in eng._by_axes(list(ex), ex).items():
        whole.update(zip(names, eng.flat_all_gather(
            [whole[n] for n in names], [ex[n][0] for n in names], axes)))
    return whole


def _ep_fn_case(case):
    """One call of an expert-parallel MoE function on this rank's rows
    ``case["rows"]`` (counts in BATCH_AXES order) of ``case["x"]`` with
    this rank's experts, and the gradients of sum(y * dy)."""
    import torch
    from deepspeed_tpu_torch.moe import sharded_moe as sm
    from deepspeed_tpu_torch.utils import groups
    topo = _topology(**case["topo"])
    eaxes = ("data_outer", "expert") if case.get("staged") else ("expert",)
    n_e, e_idx = topo.axis_size(eaxes), topo.axis_index(eaxes)
    r = topo.axis_index(groups.BATCH_AXES)
    lo = int(sum(case["rows"][:r]))
    hi = lo + int(case["rows"][r])
    x = torch.from_numpy(case["x"][lo:hi]).requires_grad_()
    dy = torch.from_numpy(case["dy"][lo:hi])
    p = {}
    for k, v in case["params"].items():
        t = torch.from_numpy(v)
        if k != "gate":
            e_loc = t.shape[0] // n_e
            t = t[e_idx * e_loc:(e_idx + 1) * e_loc]
        p[k] = t.clone().requires_grad_()
    aux = None
    if case["kind"] == "layer":
        dp_axes = tuple(a for a in groups.BATCH_AXES
                        if topo.axis_size(a) > 1)
        y, aux, counts = sm.moe_layer_ragged_ep(
            x, p["gate"], p["wi"], p["bi"], p["wo"], p["bo"], k=case["k"],
            expert_parallel_size=topo.axis_size("expert"),
            grouped_kernel=case["kernel"], dp_axes=dp_axes)
    else:
        y, counts = sm.moe_swiglu_ragged_ep(
            x, p["gate"], p["w1"], p["w3"], p["w2"], k=case["k"],
            hierarchical=case["hierarchical"],
            dcn_quantize=case["dcn_quantize"],
            grouped_kernel=case["kernel"], return_counts=True)
    (y * dy).sum().backward()
    return {"y": y, "aux": aux, "counts": counts, "e_idx": e_idx,
            "grads": {"x": x.grad, **{k: v.grad for k, v in p.items()}}}


@_suite
def moe_ep(inp, rank, world):
    """Expert parallelism: each case of ``inp["fn"]`` (``_ep_fn_case``);
    then each run of ``inp["runs"]`` through initialize -> train_batch
    (losses, grad norms, each step's clipped gradients and the master,
    made whole), the host bytes the exchanges staged, and, with
    ``inp["ckpt"]``, the checkpoint runs of ``_ckpt_runs``."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import get_comms_logger
    from deepspeed_tpu_torch.utils import groups
    out = {"fn": {name: _ep_fn_case(case)
                  for name, case in inp["fn"].items()}}
    engines = {}
    for name, run in inp["runs"].items():
        groups.reset()
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=_model(run), config=run["config"], device="cpu")
        engines[name] = engine
        steps = []
        unscale_clip = engine._unscale_clip

        def record(grads, scale, engine=engine, unscale_clip=unscale_clip,
                   steps=steps):
            got = unscale_clip(grads, scale)
            steps.append(_whole_grads(engine, got[0]))
            return got
        engine._unscale_clip = record
        losses, norms = [], []
        for b in run["batches"]:
            losses.append(engine.train_batch(b))
            norms.append(engine.get_global_grad_norm())
        out[name] = {
            "losses": losses, "grad_norms": norms, "grads": list(steps),
            "dp": engine.dp, "ep": engine.topology.axis_size("expert"),
            "expert_leaves": sorted(engine._expert),
            "shard_shapes": {n: tuple(m.shape) for n, m in
                             engine.state["master"].items()},
            "master": {n: m.clone()
                       for n, m in engine.gathered_master().items()}}
        engine._unscale_clip = unscale_clip
    out["host_staged"] = dict(get_comms_logger().host_staged)
    if inp.get("ckpt"):
        out["ckpt"] = _ckpt_runs(inp, engines, lambda run: _model(run))
    return {"res": _np(out)}


@_suite
def kv_handoff(inp, rank, world):
    """An ``inp["ring_bytes"]`` payload through ring_exchange_bytes, then
    a KV handoff of ``inp["prompt"]`` from rank 0's engine into rank 1's
    through DcnRingTransport (rank 1 sends an empty payload back)."""
    import dataclasses
    import hashlib

    import numpy as np
    import torch
    from deepspeed_tpu_torch import InferenceEngineV2, Llama
    from deepspeed_tpu_torch import comm as c
    from deepspeed_tpu_torch.inference.v2 import kv_transfer
    from deepspeed_tpu_torch.models import (LLAMA_TINY,
                                            llama_params_from_numpy)
    data = np.random.RandomState(rank).bytes(inp["ring_bytes"])
    got, origin = c.ring_exchange_bytes(data)
    model = Llama(dataclasses.replace(LLAMA_TINY, dtype="float32"),
                  device="cpu", dtype=torch.float32)
    model.load_state_dict(llama_params_from_numpy(inp["params"], "cpu",
                                                  torch.float32))
    eng = InferenceEngineV2(model, dict(inp["base"]), device="cpu")
    payload, uid = b"", 5
    if rank == 0:
        eng.put(inp["prompt"], max_new_tokens=inp["new"], uid=uid)
        eng.hold_decode(uid)
        seqs = eng.state_mgr._seqs
        while uid not in seqs or not seqs[uid].generated:
            eng.step()
        payload = kv_transfer.export_sequence(eng, uid)
    transport = kv_transfer.DcnRingTransport()
    transport.send(payload)
    received = transport.recv()
    out = {"ring_len": len(got), "ring_origin": origin,
           "ring_sha": hashlib.sha256(got).hexdigest(),
           "sent_len": len(payload),
           "sent_sha": hashlib.sha256(payload).hexdigest(),
           "received_len": len(received),
           "received_sha": hashlib.sha256(received).hexdigest()}
    if rank == 0:
        eng.release_handoff(uid)
    else:
        kv_transfer.import_sequence(eng, received)
        while not eng.is_done(uid):
            eng.step()
        out["tokens"] = np.asarray(eng.get(uid))
    alloc = eng.state_mgr.allocator
    out["pool_closed"] = alloc.free_blocks == alloc.total_blocks
    return out


_CONVERT = {"llama": "llama_params_from_numpy",
            "mixtral": "mixtral_params_from_numpy",
            "gpt2": "gpt2_params_from_numpy"}


def _serve_model(spec):
    """A port model from ``spec``: ``cls`` (a class of
    ``deepspeed_tpu_torch.models``), ``cfg`` (its config's fields),
    ``conv`` (llama | mixtral | gpt2) and ``tree`` (the JAX parameter
    tree as numpy), fp32 on the CPU."""
    import torch
    from deepspeed_tpu_torch import models
    cls = getattr(models, spec["cls"])
    cfg = getattr(models, spec["cls"] + "Config")(**spec["cfg"])
    model = cls(cfg, device="cpu", dtype=torch.float32)
    conv = getattr(models, _CONVERT[spec["conv"]])
    model.load_state_dict(conv(spec["tree"], "cpu", torch.float32))
    return model


@_suite
def serve(inp, rank, world):
    """Multi-rank serving: each run of ``inp["runs"]`` builds the whole
    model on every rank (``_serve_model``), an ``InferenceEngineV2`` at
    the run's ``conf`` (tensor_parallel / expert_parallel) on the CPU,
    with the run's draft model (``"self"`` for the model itself; with
    ``seed_by_rank`` the sampler's seed is the config's plus the rank), and
    serves ``prompts`` in ``waves`` (each wave one ``generate_all``).
    Returns the streams, the forward counts, the rank's leaf shapes, KV
    pool shape, prefix-cache and offload stats, and the host bytes the
    collectives staged."""
    import torch
    from deepspeed_tpu_torch import InferenceEngineV2
    from deepspeed_tpu_torch.autotuning import kernel_dispatch
    from deepspeed_tpu_torch.utils import groups
    out = {}
    for name, run in inp["runs"].items():
        groups.reset()
        kernel_dispatch.reset()
        model = _serve_model(run)
        draft = run.get("draft")
        if draft == "self":
            draft = model
        elif draft is not None:
            draft = _serve_model(draft)
        conf = dict(run["conf"])
        if run.get("seed_by_rank"):     # each rank's sampler its own seed
            conf["seed"] = conf.get("seed", 0) + rank
        eng = InferenceEngineV2(model, conf, device="cpu",
                                draft_model=draft)
        torch.manual_seed(1000 + rank)       # no rank agrees by accident
        streams = []
        for wave in run["waves"]:
            streams.extend(eng.generate_all(
                [run["prompts"][i] for i in wave],
                max_new_tokens=run["new"]))
        res = {"streams": [list(map(int, t)) for t in streams],
               "forward_counts": dict(eng.forward_counts),
               "draft_forward_counts": dict(eng.draft_forward_counts),
               "shapes": {k: tuple(v.shape) for k, v in
                          {**dict(model.blocks.named_parameters()),
                           **model.qblocks}.items()},
               "pool": tuple(eng.cache["k"][0].shape),
               "tp": model._tp, "tp_index": model._tp_index,
               "ep": getattr(model, "_moe_ep", 1),
               "multi_rank": eng.multi_rank,
               "agreement": eng.agreement()}
        if eng.prefix_cache is not None:
            res["prefix"] = dict(eng.prefix_cache.stats())
        if eng.kv_pool is not None:
            res["offload"] = (eng.kv_pool.swapped_in,
                              eng.kv_pool.swapped_out)
        out[name] = res
    return {"res": out}


def main():
    suite, tmpdir = sys.argv[1], sys.argv[2]
    sys.path.insert(0, ROOT)
    from deepspeed_tpu_torch import comm
    comm.init_distributed(device="cpu", verbose=False)
    rank, world = comm.get_rank(), comm.get_world_size()
    inputs = torch.load(os.path.join(tmpdir, "inputs.pt"),
                        weights_only=False)
    out = SUITES[suite](inputs, rank, world)
    out["isolated"] = not any(m.split(".")[0] in ("jax", "jaxlib",
                                                   "deepspeed_tpu")
                              for m in sys.modules)
    torch.save(out, os.path.join(tmpdir, f"out_{rank}.pt"))
    comm.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
