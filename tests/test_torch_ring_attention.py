"""The port's zigzag ring attention (deepspeed_tpu_torch/sequence/ring.py)
and its K10 block step (ops/cuda/flash_attention.py ``flash_block_*``)
held against the JAX package on CPU.

- ``flash_block_fwd`` / ``flash_block_finalize`` / ``flash_block_bwd``,
  plain versions, against the JAX Pallas kernels in interpret mode on the
  same fp32 inputs, at rtol = atol = 1e-5 (fp32 sums over a chunk in
  another order);
- ``ring_attention`` zigzag (K10 / K2 steps and einsum steps, double
  buffered and not, the rotation split in two), full (non-causal) and
  contiguous at R = 1 (in process) and R = 2, 4 (gloo worlds spawned once
  each), forward and gradients, against JAX ``ring_attention_sharded``
  (einsum steps) on the virtual mesh and against dense attention, at the
  tolerances of tests/unit/test_ring_zigzag.py: forward rtol 2e-5 / atol
  2e-6, gradients rtol 3e-4 / atol 3e-5;
- ``ring_attention_sharded`` (the global-tensor entry) and
  ``ring_flops_info`` equal to JAX's."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu.sequence import ring_attention_sharded as jring_sharded
from deepspeed_tpu.sequence.ring import ring_flops_info as jflops
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.ops.cuda import flash_attention as tfa
from deepspeed_tpu_torch.sequence import ring_attention
from deepspeed_tpu_torch.sequence.ring import ring_flops_info
from deepspeed_tpu_torch.utils import groups
from test_torch_dist_worker import run_world

FWD_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=3e-4, atol=3e-5)
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
B, T, H, D = 2, 32, 4, 8
CASES = {
    "zigzag_kernel": dict(causal=True, layout="zigzag", block_kernel=True),
    "zigzag_einsum": dict(causal=True, layout="zigzag", block_kernel=False),
    "zigzag_serial": dict(causal=True, layout="zigzag", block_kernel=True,
                          double_buffer=False, rotate_chunks=2),
    "full_kernel": dict(causal=False, block_kernel=True),
    "contiguous": dict(causal=True, layout="contiguous"),
}


def _qkv(seed=0):
    rs = np.random.RandomState(seed)
    return {n: rs.standard_normal((B, T, H, D)).astype(np.float32)
            for n in ("q", "k", "v", "do")}


def _dense(q, k, v, causal):
    s = jnp.einsum("bthd,bshd->bhts", q, k) / math.sqrt(q.shape[-1])
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((T, T), bool))[None, None], s, -1e30)
    return jnp.einsum("bhts,bshd->bthd", jax.nn.softmax(s, axis=-1), v)


def _jax_fwd_grads(fn, x):
    q, k, v, do = (jnp.asarray(x[n]) for n in ("q", "k", "v", "do"))
    o, vjp = jax.vjp(fn, q, k, v)
    return {"o": np.asarray(o),
            **dict(zip(("dq", "dk", "dv"), map(np.asarray, vjp(do))))}


def _jax_ring(R, kw, x):
    jgroups.reset()
    topo = jgroups.initialize(jgroups.TopologyConfig(seq_parallel_size=R),
                              devices=jax.devices()[:R])
    kw = {k: v for k, v in kw.items() if k in ("causal", "layout")}
    with jax.set_mesh(topo.mesh):
        return _jax_fwd_grads(jax.jit(lambda a, b, c: jring_sharded(
            a, b, c, topo.mesh, block_kernel=False, **kw)), x)


def _check(got, want, what):
    np.testing.assert_allclose(got["o"], want["o"], err_msg=f"{what} o",
                               **FWD_TOL)
    for g in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[g], want[g], err_msg=f"{what} {g}",
                                   **GRAD_TOL)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    x = _qkv()
    return {R: run_world("ring", R, {**x, "cases": CASES},
                         tmp_path_factory.mktemp(f"ring{R}"))
            for R in (2, 4)}


@pytest.fixture(scope="module")
def dense():
    x = _qkv()
    return {c: _jax_fwd_grads(lambda a, b, cc: _dense(a, b, cc, c), x)
            for c in (True, False)}


def _gathered(outs, name):
    """The ranks' local results concatenated along the sequence."""
    return {k: np.concatenate([o["res"][name][k] for o in outs], axis=1)
            for k in ("o", "dq", "dk", "dv")}


@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_ring_matches_jax_ring_and_dense(worlds, dense, R, case):
    got = _gathered(worlds[R], case)
    _check(got, _jax_ring(R, CASES[case], _qkv()), f"R={R} {case} vs jax")
    _check(got, dense[CASES[case]["causal"]], f"R={R} {case} vs dense")


@pytest.mark.parametrize("case", list(CASES))
def test_ring_of_one_matches_jax_and_dense(dense, case):
    groups.reset()
    x = _qkv()
    q, k, v = (torch.from_numpy(x[n]).requires_grad_()
               for n in ("q", "k", "v"))
    o = ring_attention(q, k, v, "seq", **CASES[case])
    grads = torch.autograd.grad(o, (q, k, v), torch.from_numpy(x["do"]))
    got = {"o": o.detach().numpy(),
           **{n: g.numpy() for n, g in zip(("dq", "dk", "dv"), grads)}}
    _check(got, _jax_ring(1, CASES[case], x), f"R=1 {case} vs jax")
    _check(got, dense[CASES[case]["causal"]], f"R=1 {case} vs dense")


@pytest.mark.parametrize("R", [2, 4])
def test_ring_attention_sharded_matches_jax(worlds, R):
    want = _jax_ring(R, CASES["zigzag_einsum"], _qkv())["o"]
    for o in worlds[R]:
        np.testing.assert_allclose(o["res"]["sharded"], want, **FWD_TOL)


@pytest.mark.parametrize("R", [1, 2, 4, 8])
@pytest.mark.parametrize("causal,layout", [(True, "zigzag"),
                                           (True, "contiguous"),
                                           (False, "zigzag")])
def test_ring_flops_info_matches_jax(R, causal, layout):
    assert ring_flops_info(R, 16, causal, layout) == \
        jflops(R, 16, causal, layout)


def _block_inputs(BH, C, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal((BH, C, d)).astype(np.float32) * s
            for s in (0.3, 1, 1, 1, 1, 1)]


@pytest.mark.parametrize("BH,C,d", [(4, 64, 32), (3, 100, 64),
                                    (2, 130, 16)])
def test_flash_block_steps_match_jax_pallas(BH, C, d):
    """Two chained pairs (the diagonal-causal one, then a full one with
    another kv chunk) from a fresh state, finalize, then each pair's
    backward from the global o and lse."""
    q, k1, v1, k2, v2, do = _block_inputs(BH, C, d, seed=C)
    st = tfa.flash_block_state(BH, C, d)
    jst = jfa.flash_block_state(BH, C, d)
    for k, v, causal in ((k1, v1, True), (k2, v2, False)):
        out = tfa.flash_block_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                  st, causal=causal)
        assert out is st                     # updated in place
        jst = jfa.flash_block_fwd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jst, causal=causal,
                                  interpret=True)
        for a, b in zip(st, jst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       **BLOCK_TOL)
    o, lse = tfa.flash_block_finalize(st)
    jo, jlse = jfa.flash_block_finalize(jst)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **BLOCK_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **BLOCK_TOL)
    for k, v, causal in ((k1, v1, True), (k2, v2, False)):
        got = tfa.flash_block_bwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                  o, lse, torch.from_numpy(do),
                                  causal=causal)
        want = jfa.flash_block_bwd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jo, jlse,
                                   jnp.asarray(do), causal=causal,
                                   interpret=True)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       **BLOCK_TOL)


def test_flash_block_fwd_updates_views_of_one_state():
    """The ring updates the early and late halves of one state in place:
    stepping each half through its view equals stepping a separate
    state."""
    q, k, v, *_ = _block_inputs(2, 64, 32, seed=1)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    st = tfa.flash_block_state(2, 64, 32)
    late = tuple(x[:, 32:] for x in st)
    tfa.flash_block_fwd(tq[:, 32:], tk[:, :32], tv[:, :32], late)
    ref = tfa.flash_block_fwd_reference(
        tq[:, 32:], tk[:, :32], tv[:, :32],
        tfa.flash_block_state(2, 32, 32))
    for a, b in zip(late, ref):
        assert torch.equal(a, b)
    assert torch.equal(st[1][:, :32], torch.zeros(2, 32))
    with pytest.raises(ValueError, match="equal chunk"):
        tfa.flash_block_fwd(tq, tk[:, :32], tv[:, :32], st)


@pytest.mark.parametrize("dtype,T,d,view,want", [
    (torch.bfloat16, 2048, 64, "whole", "sm90"),
    (torch.bfloat16, 200, 128, "whole", "sm90"),
    (torch.bfloat16, 256, 64, "late half", "sm90"),   # a zigzag half
    (torch.bfloat16, 256, 32, "whole", "mma_sync"),   # d = 32
    (torch.bfloat16, 64, 64, "t stride 68", "mma_sync"),
    (torch.float32, 256, 64, "whole", "fp32"),
])
def test_block_design_rule(dtype, T, d, view, want):
    """``_block_design`` on K10's folded (BH, 1, T, d) views: K1's rule
    (bf16 at d = 64 / 128 that TMA can address -> sm90)."""
    if view == "late half":
        x = torch.zeros(4, 2 * T, d, dtype=dtype)[:, T:]
    elif view == "t stride 68":
        x = torch.zeros(4, T, 68, dtype=dtype)[..., :d]
    else:
        x = torch.zeros(4, T, d, dtype=dtype)
    v = x.unsqueeze(1)
    assert tfa._block_design(v, v, v) == want
