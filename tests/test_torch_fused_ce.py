"""The port's fused CE (ops/cuda/fused_ce.unembed_logits_stats and the
models/common fused heads) held against the JAX package's on CPU tensors:
the port's plain version against the JAX Pallas kernel in interpret mode,
and the fused loss heads' value and gradients against JAX autodiff, in
fp32.

Tolerances: the unembed stats at rtol=atol=1e-5 (fp32 dot products of
length D taken in another order); losses at 1e-5 and gradients at 1e-4
(the JAX chunked-loss tests' own, test_gpt2.py:125-134)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import common as jcommon
from deepspeed_tpu.ops.pallas import fused_ce as jce
from deepspeed_tpu.ops.pallas.layernorm import _ln_jnp
from deepspeed_tpu_torch.models import common as tcommon
from deepspeed_tpu_torch.models.gpt2 import layernorm
from deepspeed_tpu_torch.ops.cuda import fused_ce as tce

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def test_unembed_stats_match_jax_kernel_ragged_vocab():
    rs = np.random.RandomState(0)
    N, D, V = 64, 32, 200
    h = rs.standard_normal((N, D)).astype(np.float32)
    w = (rs.standard_normal((V, D)) * 0.3).astype(np.float32)
    t = rs.randint(0, V, N).astype(np.int32)
    t[:6] = [-1, -7, V, V + 3, V + 100, 0]     # outside [0, V) -> gold 0
    got = tce.unembed_logits_stats(*map(torch.from_numpy, (h, w, t)))
    want = jce.unembed_logits_stats(*map(jnp.asarray, (h, w, t)),
                                    block_m=32, block_n=128, interpret=True)
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **TOL)
    assert (got[2][:5] == 0).all()
    tce.reset_launch_counts()
    tce.unembed_logits_stats(*map(torch.from_numpy, (h, w, t)))
    assert tce.LAUNCHES == {"fused_ce": 0}          # CPU: the plain version


def test_unembed_stats_rejects_bad_operands():
    h = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        tce.unembed_logits_stats(h, torch.zeros(5, 7), torch.zeros(4).long())
    with pytest.raises(TypeError):
        tce.unembed_logits_stats(h, torch.zeros(5, 8).double(),
                                 torch.zeros(4).long())
    with pytest.raises(TypeError):
        tce.unembed_logits_stats(h, torch.zeros(5, 8), torch.zeros(4))


def _head_case(seed=0, B=2, T=45, D=32, V=200):
    rs = np.random.RandomState(seed)
    hidden = rs.standard_normal((B, T, D)).astype(np.float32)
    targets = rs.randint(0, V, (B, T)).astype(np.int32)
    w = (rs.standard_normal((V, D)) * 0.1).astype(np.float32)
    scale = (1 + 0.1 * rs.standard_normal(D)).astype(np.float32)
    bias = (0.1 * rs.standard_normal(D)).astype(np.float32)
    return hidden, targets, w, scale, bias


def _jax_dense_loss(w, scale, bias, hidden, targets):
    h = _ln_jnp(hidden, scale, bias, 1e-5)
    logits = jnp.einsum("btd,vd->btv", h, w)
    logz = jax.nn.logsumexp(logits, axis=-1)
    gold = jnp.take_along_axis(logits, targets[..., None], axis=-1)[..., 0]
    return jnp.mean(logz - gold)


def _port_head_loss(kernel, chunk, w, scale, bias, hidden, targets):
    if kernel:
        return tcommon.fused_linear_xent_kernel(
            lambda ps, x: layernorm(x, ps[0], ps[1]), chunk,
            {"s": scale, "b": bias}, w, hidden, targets)
    return tcommon.fused_linear_xent(
        lambda ps, x: tcommon.mm_f32(
            layernorm(x, ps[1], ps[2]).reshape(-1, x.shape[-1]),
            ps[0].t()).reshape(*x.shape[:-1], -1),
        chunk, {"w": w, "s": scale, "b": bias}, hidden, targets)


@pytest.mark.parametrize("kernel", [False, True])
def test_fused_heads_match_jax(kernel):
    """fused_linear_xent(_kernel) loss and grads against the JAX fused
    head (Pallas kernel in interpret mode) and the JAX dense loss."""
    hidden, targets, w, scale, bias = _head_case(seed=1 + kernel)
    chunk = 16                                   # 45 = 2 full + 1 ragged
    jargs = tuple(map(jnp.asarray, (w, scale, bias, hidden)))
    jt = jnp.asarray(targets)
    if kernel:
        def jfused(w, s, b, x):
            return jcommon.fused_linear_xent_kernel(
                lambda p, x: _ln_jnp(x, p["s"], p["b"], 1e-5), chunk,
                {"s": s, "b": b}, w, x, jt)
    else:
        def jfused(w, s, b, x):
            return jcommon.fused_linear_xent(
                lambda p, x: jnp.einsum(
                    "btd,vd->btv", _ln_jnp(x, p["s"], p["b"], 1e-5), p["w"]),
                chunk, {"w": w, "s": s, "b": b}, x, jt)
    jl, jg = jax.value_and_grad(jfused, argnums=(0, 1, 2, 3))(*jargs)
    dl, dg = jax.value_and_grad(_jax_dense_loss, argnums=(0, 1, 2, 3))(
        *jargs, jt)
    np.testing.assert_allclose(float(jl), float(dl), **TOL)

    tw, ts, tb, tx = (torch.from_numpy(a).requires_grad_()
                      for a in (w, scale, bias, hidden))
    tt = torch.from_numpy(targets)
    loss = _port_head_loss(kernel, chunk, tw, ts, tb, tx, tt)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    for got, want in zip((tw.grad, ts.grad, tb.grad, tx.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
    # the eval (no-grad) path computes the loss alone, to the same value
    with torch.no_grad():
        le = _port_head_loss(kernel, chunk, tw, ts, tb, tx, tt)
    np.testing.assert_allclose(float(le), float(jl), **TOL)


def test_chunked_softmax_xent_matches_dense():
    hidden, targets, w, scale, bias = _head_case(seed=5)
    jl, jg = jax.value_and_grad(_jax_dense_loss, argnums=(0, 3))(
        *map(jnp.asarray, (w, scale, bias, hidden)), jnp.asarray(targets))
    tw, tx = (torch.from_numpy(a).requires_grad_() for a in (w, hidden))
    ts, tb = torch.from_numpy(scale), torch.from_numpy(bias)

    def head(x):
        return tcommon.mm_f32(layernorm(x, ts, tb).reshape(-1, x.shape[-1]),
                              tw.t()).reshape(*x.shape[:-1], -1)

    loss = tcommon.chunked_softmax_xent(head, tx, torch.from_numpy(targets),
                                        16)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    for got, want in zip((tw.grad, tx.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("ragged", [False, True], ids=["whole", "ragged"])
@pytest.mark.parametrize("block_v", [64, 128, 256])
def test_tiled_partials_merge_matches_jax(block_v, ragged):
    """The bf16 Hopper design's two passes in plain PyTorch (per-vocab-tile
    partials, then their merge in tile order) against the JAX kernel in
    interpret mode and the one-pass plain version: logz and gold at 1e-5,
    logits bitwise the plain version's; each tile's partials against the
    plain scores of its columns."""
    rs = np.random.RandomState(block_v + ragged)
    N, D = 40, 32
    V = 2 * block_v + (37 if ragged else 0)
    h = rs.standard_normal((N, D)).astype(np.float32)
    w = (rs.standard_normal((V, D)) * 0.3).astype(np.float32)
    t = rs.randint(0, V, N).astype(np.int32)
    t[:4] = [-1, V, V + 9, -block_v]            # outside [0, V): gold 0
    t[4:8] = V - 1 - np.arange(4)               # in the last vocab tile
    th, tw, tt = map(torch.from_numpy, (h, w, t))
    got = tce.unembed_logits_stats_tiled_reference(th, tw, tt, block_v)
    plain = tce.unembed_logits_stats_reference(th, tw, tt)
    want = jce.unembed_logits_stats(*map(jnp.asarray, (h, w, t)),
                                    block_m=8, block_n=128, interpret=True)
    assert torch.equal(got[0], plain[0])
    for g, p, j in zip(got[1:], plain[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **TOL)
        np.testing.assert_allclose(g.numpy(), p.numpy(), **TOL)
    assert (got[2][:4] == 0).all()

    s = th @ tw.t()
    parts = tce.ce_tile_partials(s, tt, block_v)
    n_vt = -(-V // block_v)
    assert parts.shape == (N, n_vt, 3)
    for k in range(n_vt):
        cols = s[:, k * block_v:(k + 1) * block_v]
        m = cols.amax(dim=1)
        np.testing.assert_allclose(parts[:, k, 0].numpy(), m.numpy(), **TOL)
        np.testing.assert_allclose(
            parts[:, k, 1].numpy(),
            torch.exp(cols - m[:, None]).sum(dim=1).numpy(), **TOL)
        here = (tt >= k * block_v) & (tt < min(V, (k + 1) * block_v))
        gold = torch.where(here, s[torch.arange(N), tt.clamp(0, V - 1)], 0.)
        np.testing.assert_allclose(parts[:, k, 2].numpy(), gold.numpy(),
                                   **TOL)
