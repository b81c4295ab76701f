"""The port's expert-parallel MoE functions (deepspeed_tpu_torch/moe/
sharded_moe.py ``moe_layer_ragged_ep``, ``moe_swiglu_ragged_ep``,
``resolve_hierarchical_a2a``; comm.exchange) in gloo worlds of 2 and 4 CPU
processes (spawned once each), held against the JAX EP functions under
``shard_map`` on the virtual CPU mesh, fp32:

- the flat exchange at ep = 2 (GPT2MoE's layer with its aux loss and
  counts, Mixtral's SwiGLU experts), the layer at data 2 x expert 2, and
  the staged exchange at data_outer 2 x expert 2 (experts over the
  combined grid): y, the aux loss, the global counts and the gradients of
  sum(y * dy) with respect to the tokens, the router and every expert
  leaf (summed over the ranks that hold them), with the grouped kernels'
  plain versions and with the ragged math;
- odd token counts: the JAX function pads the global token dim, each
  rank here routes its own rows; the same rows split unevenly over the
  ranks give every token the same result (routing is per token);
- ``dcn_quantize``: bitwise a no-op on a flat mesh, bounded on the staged
  one, where y is the JAX clamp's result. The port's clamp is
  straight-through in the backward, a deliberate departure (ROADMAP.md,
  open divergences): the JAX clamp defines no gradient of its own, so
  ``jax.grad`` differentiates the round trip's arithmetic, which passes a
  gradient only through each block's absmax. The port's gradients are
  held against ``jax.grad`` of the staged function with the JAX clamp
  made straight-through, and shown to differ from its own.

Tolerances: y and the aux loss at rtol 1e-5 / atol 1e-6, gradients at a
relative error norm of 1e-5 (the same products summed in other orders)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.moe import sharded_moe as tsm
from test_torch_dist_worker import run_world

M, F, E = 16, 24, 8
Y_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL_NORM = 1e-5
LAYER_KEYS = ("gate", "wi", "bi", "wo", "bo")
SWIGLU_KEYS = ("gate", "w1", "w3", "w2")


def _layer_params(seed):
    rs = np.random.RandomState(seed)
    return {"gate": rs.randn(M, E).astype(np.float32) * 0.3,
            "wi": rs.randn(E, M, F).astype(np.float32) * 0.2,
            "bi": rs.randn(E, F).astype(np.float32) * 0.1,
            "wo": rs.randn(E, F, M).astype(np.float32) * 0.2,
            "bo": rs.randn(E, M).astype(np.float32) * 0.1}


def _swiglu_params(seed):
    rs = np.random.RandomState(seed)
    return {"gate": rs.randn(M, E).astype(np.float32) * 0.3,
            "w1": rs.randn(E, M, F).astype(np.float32) * 0.2,
            "w3": rs.randn(E, M, F).astype(np.float32) * 0.2,
            "w2": rs.randn(E, F, M).astype(np.float32) * 0.2}


def _tokens(S, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(S, M).astype(np.float32) * 0.5,
            rs.randn(S, M).astype(np.float32))


# name -> (world, port topology, JAX topology, the case)
FLAT2 = dict(expert_parallel_size=2)
DP2_EP2 = dict(expert_parallel_size=2)
STAGED = dict(expert_parallel_size=2, zero_shard_size=1)
JSTAGED = dict(data_parallel_size=2, zero_shard_size=1,
               expert_parallel_size=2)
FLAT4 = dict(expert_parallel_size=4)


def _cases():
    out = {}

    def add(name, world, topo, jtopo, kind, S, rows, seed, **kw):
        x, dy = _tokens(S, seed)
        params = (_layer_params if kind == "layer" else _swiglu_params)(
            seed + 1)
        out[name] = (world, jtopo, dict(kind=kind, topo=topo, x=x, dy=dy,
                                        params=params, rows=rows, k=2, **kw))
    add("layer_ep2", 2, FLAT2, FLAT2, "layer", 14, [7, 7], 0, kernel=True)
    add("layer_ep2_uneven", 2, FLAT2, FLAT2, "layer", 14, [3, 11], 0,
        kernel=False)
    sw = dict(hierarchical="auto", dcn_quantize=False)
    add("swiglu_ep2_odd", 2, FLAT2, FLAT2, "swiglu", 15, [8, 7], 2,
        kernel=True, **sw)
    add("swiglu_ep2_uneven", 2, FLAT2, FLAT2, "swiglu", 15, [5, 10], 2,
        kernel=False, **sw)
    add("layer_dp2_ep2", 4, DP2_EP2, DP2_EP2, "layer", 16, [4] * 4, 4,
        kernel=True)
    add("swiglu_staged_odd", 4, STAGED, JSTAGED, "swiglu", 15, [4, 4, 4, 3],
        6, kernel=True, staged=True, **sw)
    add("swiglu_staged_uneven", 4, STAGED, JSTAGED, "swiglu", 15,
        [1, 6, 2, 6], 6, kernel=False, staged=True, **sw)
    add("swiglu_staged_dcn", 4, STAGED, JSTAGED, "swiglu", 16, [4] * 4, 8,
        kernel=True, staged=True, hierarchical="auto", dcn_quantize=True)
    add("swiglu_staged_nodcn", 4, STAGED, JSTAGED, "swiglu", 16, [4] * 4, 8,
        kernel=True, staged=True, **sw)
    for q in (True, False):
        add(f"swiglu_flat4_dcn_{q}", 4, FLAT4, FLAT4, "swiglu", 16, [4] * 4,
            10, kernel=True, hierarchical="auto", dcn_quantize=q)
    return out


CASES = _cases()


def _jax_case(jtopo, world, case):
    """The JAX EP function's (y, aux, counts, grads) on the virtual mesh."""
    jgroups.reset()
    topo = jgroups.initialize(jgroups.TopologyConfig(**jtopo),
                              devices=jax.devices()[:world])
    keys = LAYER_KEYS if case["kind"] == "layer" else SWIGLU_KEYS
    args = [jnp.asarray(case["x"])] + [jnp.asarray(case["params"][k])
                                       for k in keys]
    dy = jnp.asarray(case["dy"])

    def fn(*a):
        if case["kind"] == "layer":
            return jsm.moe_layer_ragged_ep(a[0], *a[1:], k=case["k"],
                                           grouped_kernel=False)
        y, counts = jsm.moe_swiglu_ragged_ep(
            a[0], *a[1:], k=case["k"], hierarchical=case["hierarchical"],
            dcn_quantize=case["dcn_quantize"], grouped_kernel=False,
            return_counts=True)
        return y, None, counts

    with jax.set_mesh(topo.mesh):
        y, aux, counts = jax.jit(fn)(*args)
        grads = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a)[0] * dy),
                                 argnums=tuple(range(len(args)))))(*args)
    jgroups.reset()
    return {"y": np.asarray(y), "aux": None if aux is None else float(aux),
            "counts": np.asarray(counts),
            "grads": dict(zip(("x",) + keys, map(np.asarray, grads)))}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for world in (2, 4):
        fn = {n: c for n, (w, _, c) in CASES.items() if w == world}
        out[world] = run_world("moe_ep", world, {"fn": fn, "runs": {}},
                               tmp_path_factory.mktemp(f"moe_ep{world}"))
    return out


def _jax_case_straight_through(jtopo, world, case):
    """``_jax_case`` with the JAX clamp's backward made the identity (its
    forward unchanged), restored after."""
    from deepspeed_tpu.comm import quantized as jq
    clamp = jq.dcn_precision_clamp

    @jax.custom_vjp
    def straight(x):
        return clamp(x)
    straight.defvjp(lambda x: (clamp(x), None), lambda _, g: (g,))
    jq.dcn_precision_clamp = straight
    try:
        return _jax_case(jtopo, world, case)
    finally:
        jq.dcn_precision_clamp = clamp


@pytest.fixture(scope="module")
def jax_cases():
    out = {n: _jax_case(jt, w, c) for n, (w, jt, c) in CASES.items()
           if not n.startswith("swiglu_flat4")}
    w, jt, c = CASES["swiglu_staged_dcn"]
    out["swiglu_staged_dcn_straight"] = _jax_case_straight_through(jt, w, c)
    return out


def _gathered(outs, name):
    """The ranks' results of one case made global: y and dx by rows in
    BATCH_AXES order (rank order here), the router's gradient summed over
    the ranks, each expert leaf's summed over the ranks that hold the same
    experts and concatenated in expert-shard order."""
    res = [o["res"]["fn"][name] for o in outs]
    y = np.concatenate([r["y"] for r in res])
    grads = {"x": np.concatenate([r["grads"]["x"] for r in res]),
             "gate": sum(r["grads"]["gate"] for r in res)}
    shards = sorted({int(r["e_idx"]) for r in res})
    for k in res[0]["grads"]:
        if k in ("x", "gate"):
            continue
        grads[k] = np.concatenate([
            sum(r["grads"][k] for r in res if int(r["e_idx"]) == e)
            for e in shards])
    return y, grads, res


def _rel_norm(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", [n for n in CASES
                                  if not n.startswith("swiglu_flat4")
                                  and n != "swiglu_staged_dcn"])
def test_ep_function_matches_jax(worlds, jax_cases, name):
    world, _, case = CASES[name]
    want = jax_cases[name]
    y, grads, res = _gathered(worlds[world], name)
    np.testing.assert_allclose(y, want["y"], **Y_TOL)
    for r in res:
        np.testing.assert_array_equal(r["counts"],
                                      want["counts"].astype(np.int32))
        if want["aux"] is not None:
            np.testing.assert_allclose(float(r["aux"]), want["aux"],
                                       rtol=1e-5)
    assert set(grads) == set(want["grads"])
    for k, g in grads.items():
        assert _rel_norm(g, want["grads"][k]) <= GRAD_REL_NORM, \
            (name, k, _rel_norm(g, want["grads"][k]))


@pytest.mark.parametrize("even,uneven", [
    ("layer_ep2", "layer_ep2_uneven"),
    ("swiglu_ep2_odd", "swiglu_ep2_uneven"),
    ("swiglu_staged_odd", "swiglu_staged_uneven")])
def test_a_token_s_result_does_not_depend_on_its_rank(worlds, even, uneven):
    """The same tokens split over the ranks in other counts (one backend
    each: the kernels' plain versions and the ragged math): every token's
    output is the same."""
    world = CASES[even][0]
    y_even = _gathered(worlds[world], even)[0]
    y_uneven = _gathered(worlds[world], uneven)[0]
    np.testing.assert_allclose(y_uneven, y_even, **Y_TOL)


def test_dcn_quantize_is_a_no_op_on_a_flat_mesh(worlds):
    on = _gathered(worlds[4], "swiglu_flat4_dcn_True")[0]
    off = _gathered(worlds[4], "swiglu_flat4_dcn_False")[0]
    assert np.array_equal(on, off)


def test_dcn_quantize_is_bounded_on_the_staged_mesh(worlds, jax_cases):
    """The int8 round trip on the data_outer legs perturbs y a little (the
    JAX bound: 0 < max |err| < 0.05 against the exact exchange), as the
    JAX clamp does: y is the JAX function's. Its backward is
    straight-through, so the gradients are the exact exchange's within
    the same bound (relative error norm)."""
    q, gq, _ = _gathered(worlds[4], "swiglu_staged_dcn")
    exact, ge, _ = _gathered(worlds[4], "swiglu_staged_nodcn")
    err = np.abs(q - exact).max()
    assert 0 < err < 0.05, err
    np.testing.assert_allclose(q, jax_cases["swiglu_staged_dcn"]["y"],
                               **Y_TOL)
    for k in gq:
        assert 0 < _rel_norm(gq[k], ge[k]) < 0.05, k


def test_dcn_quantize_gradient_is_straight_through(worlds, jax_cases):
    """The port's gradients with dcn_quantize are ``jax.grad`` of the JAX
    staged function whose clamp passes the gradient unchanged, at the
    tolerance of the exact cases; ``jax.grad`` of the JAX function as it
    is differs in every leaf the clamp's backward reaches (the tokens and
    the experts; the router's gradient does not pass through it)."""
    _, grads, _ = _gathered(worlds[4], "swiglu_staged_dcn")
    want = jax_cases["swiglu_staged_dcn_straight"]["grads"]
    own = jax_cases["swiglu_staged_dcn"]["grads"]
    assert set(grads) == set(want)
    for k, g in grads.items():
        assert _rel_norm(g, want[k]) <= GRAD_REL_NORM, \
            (k, _rel_norm(g, want[k]))
        if k != "gate":
            assert _rel_norm(g, own[k]) > 0.5, (k, _rel_norm(g, own[k]))


def test_resolve_hierarchical_a2a_matches_jax():
    for args in (("auto", 2, 8, 2), ("auto", 1, 8, 2), ("auto", 2, 6, 2),
                 (False, 2, 8, 2), (True, 1, 8, 2), (True, 2, 8, 2)):
        assert tsm.resolve_hierarchical_a2a(*args) == \
            jsm.resolve_hierarchical_a2a(*args), args
    for mod in (tsm, jsm):
        with pytest.raises(ValueError, match="divisible"):
            mod.resolve_hierarchical_a2a(True, 2, 6, 2)
    assert tsm.resolve_dcn_quantize("auto") is False
    with pytest.raises(ValueError, match="dcn_quantize"):
        tsm.resolve_dcn_quantize("yes")


def test_ep_needs_an_expert_axis():
    x = np.zeros((4, M), np.float32)
    p = _swiglu_params(0)
    import torch
    from deepspeed_tpu_torch.utils import groups as tgroups
    tgroups.reset()
    with pytest.raises(ValueError, match="expert axis > 1"):
        tsm.moe_swiglu_ragged_ep(torch.from_numpy(x),
                                 *(torch.from_numpy(p[k])
                                   for k in SWIGLU_KEYS))
