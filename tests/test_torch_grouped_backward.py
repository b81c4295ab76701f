"""K8's backward in the port (deepspeed_tpu_torch/ops/cuda/grouped_matmul.py:
``grouped_tgmm`` and the ``grouped_matmul`` / ``grouped_swiglu`` autograd)
and the dropless MoE layer (moe/sharded_moe.py ``topk_routing``,
``moe_layer_ragged``; moe/layer.py ``MoE``) held against the JAX package on
CPU on the same numpy-seeded inputs: the plain versions (what a CPU tensor
takes) against the JAX Pallas kernels in interpret mode and against
``lax.ragged_dot``. Dims are multiples of 128 so JAX keeps its Pallas path
(``_blocks_fit``). Tolerances (fp32): 1e-5 for one grouped product and its
gradients, 1e-4 for the SwiGLU chain and the MoE layer (the JAX tests'
own)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.moe import sharded_moe as jmoe
from deepspeed_tpu.ops.pallas import grouped_matmul as jgm
from deepspeed_tpu_torch.moe import MoE
from deepspeed_tpu_torch.moe import sharded_moe as moe
from deepspeed_tpu_torch.ops.cuda import grouped_matmul as gm

GMM_TOL = dict(rtol=1e-5, atol=1e-5)
CHAIN_TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(rs, shape, s=1.0):
    return (rs.standard_normal(shape) * s).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("sizes", [
    [50, 0, 120, 22],          # an empty group and a 64-row tail
    [256, 0, 0, 0],            # every row on one expert
    [0, 0, 0, 0],              # every group empty: zeros
    [1, 63, 100, 28],
])
def test_tgmm_matches_jax_kernel(sizes):
    """grouped_tgmm's plain version against the JAX ``_tgmm`` Pallas kernel
    (interpret mode) with the rows padded to its m-tile."""
    rs = np.random.RandomState(0)
    M, K, N = 256, 128, 256
    x, dy = _rand(rs, (M, K), 0.3), _rand(rs, (M, N), 0.3)
    gs = np.asarray(sizes, np.int32)
    got = gm.grouped_tgmm(*_t(x, dy, gs)).numpy()
    want = np.asarray(jgm._tgmm(jnp.asarray(x), jnp.asarray(dy),
                                jnp.asarray(gs), len(sizes), tm=64, tn=128,
                                tk=128, out_dtype=jnp.float32,
                                interpret=True))
    np.testing.assert_allclose(got, want, **GMM_TOL)
    for e, n in enumerate(sizes):
        if n == 0:
            assert np.all(got[e] == 0.0)


def test_tgmm_reference_is_the_per_group_product():
    """Rows past sum(group_sizes) contribute nothing; sizes past the rows
    are clipped, as the kernel clips them."""
    rs = np.random.RandomState(1)
    x, dy = _rand(rs, (40, 16)), _rand(rs, (40, 24))
    got = gm.grouped_tgmm(*_t(x, dy, np.array([10, 0, 20], np.int32)))
    np.testing.assert_allclose(got[0].numpy(), x[:10].T @ dy[:10], **GMM_TOL)
    np.testing.assert_allclose(got[2].numpy(), x[10:30].T @ dy[10:30],
                               **GMM_TOL)
    assert torch.all(got[1] == 0)
    clipped = gm.grouped_tgmm(*_t(x, dy, np.array([30, 30], np.int32)))
    np.testing.assert_allclose(clipped[1].numpy(), x[30:].T @ dy[30:],
                               **GMM_TOL)


def _jax_gmm_grads(fn, x, w, gs, cot):
    loss = lambda x, w: jnp.sum(fn(x, w, jnp.asarray(gs)) * cot)
    return [np.asarray(g) for g in jax.grad(loss, (0, 1))(
        jnp.asarray(x), jnp.asarray(w))]


@pytest.mark.parametrize("sizes", [[50, 0, 120, 22], [192, 0, 0, 0],
                                   [3, 77, 1, 111]])
def test_gmm_grads_match_jax(sizes):
    """dx (the transposed-weight product) and dw (tgmm) of the port's
    grouped_matmul against jax.grad of the JAX grouped_matmul (Pallas,
    interpret) and of lax.ragged_dot; group_sizes gets no gradient."""
    rs = np.random.RandomState(2)
    S, K, N, E = 256, 128, 256, 4
    x, w = _rand(rs, (S, K), 0.3), _rand(rs, (E, K, N), 0.1)
    cot = _rand(rs, (S, N))
    gs = np.asarray(sizes, np.int32)
    xt, wt = (t.requires_grad_() for t in _t(x, w))
    out = gm.grouped_matmul(xt, wt, torch.from_numpy(gs))
    dx, dw = torch.autograd.grad(out, (xt, wt), torch.from_numpy(cot))
    kern = _jax_gmm_grads(lambda x, w, g: jgm.grouped_matmul(
        x, w, g, block_m=64), x, w, gs, cot)
    ragged = _jax_gmm_grads(jax.lax.ragged_dot, x, w, gs, cot)
    for got, want in ((dx, kern[0]), (dw, kern[1]), (dx, ragged[0]),
                      (dw, ragged[1])):
        np.testing.assert_allclose(got.numpy(), want, **GMM_TOL)
    assert np.all(dx.numpy()[sum(sizes):] == 0.0)


@pytest.mark.parametrize("sizes", [[60, 0, 89, 11], [3, 77, 1, 79]])
def test_swiglu_grads_match_jax(sizes):
    """The grouped_swiglu backward (remat of g and u, five gmm, three tgmm)
    against jax.grad of the JAX grouped_swiglu (Pallas, interpret) and of
    the three-ragged_dot chain."""
    rs = np.random.RandomState(3)
    S, K, Fd, E = 160, 128, 256, 4
    x = _rand(rs, (S, K), 0.3)
    w1, w3 = _rand(rs, (E, K, Fd), 0.1), _rand(rs, (E, K, Fd), 0.1)
    w2 = _rand(rs, (E, Fd, K), 0.1)
    cot = _rand(rs, (S, K))
    gs = np.asarray(sizes, np.int32)
    ps = [t.requires_grad_() for t in _t(x, w1, w3, w2)]
    out = gm.grouped_swiglu(*ps, torch.from_numpy(gs))
    got = torch.autograd.grad(out, ps, torch.from_numpy(cot))

    def ragged(x, w1, w3, w2, g):
        gg = jax.lax.ragged_dot(x, w1, g)
        uu = jax.lax.ragged_dot(x, w3, g)
        return jax.lax.ragged_dot(jax.nn.silu(gg) * uu, w2, g)

    for fn in (lambda *a: jgm.grouped_swiglu(*a, block_m=64), ragged):
        want = jax.grad(lambda *a: jnp.sum(fn(*a, jnp.asarray(gs)) * cot),
                        (0, 1, 2, 3))(*map(jnp.asarray, (x, w1, w3, w2)))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **CHAIN_TOL)
    ref = gm.grouped_swiglu_backward_reference(
        *(p.detach() for p in ps), torch.from_numpy(gs),
        torch.from_numpy(cot))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_swiglu_up_alone_has_no_backward():
    x = torch.zeros(8, 16, requires_grad=True)
    w = torch.zeros(2, 16, 24)
    with pytest.raises(RuntimeError, match="grouped_swiglu"):
        gm.grouped_swiglu_up(x, w, w, torch.tensor([4, 4]))
    with torch.no_grad():
        assert gm.grouped_swiglu_up(x, w, w, torch.tensor([4, 4])).shape == \
            (8, 24)


def test_tgmm_design_rule():
    """``_tgmm_design`` on the operands a launch reads (contiguous x (M, K),
    dy (M, N), out (E, K, N), built on CPU tensors): both GPT2-MoE 350M
    expert products (49152 routed rows, E = 4, (K, N) = (1024, 4096) and
    (4096, 1024)) in bf16 take the sm90 design; the expert-bias row sums
    (x = ones (M, 1)), an odd K, an unaligned base and no rows take
    mma_sync; fp32 takes fp32."""
    bf = torch.bfloat16

    def design(M, K, N, E=4, dtype=bf, x=None):
        x = torch.empty(M, K, dtype=dtype) if x is None else x
        return gm._tgmm_design(x, torch.empty(M, N, dtype=dtype),
                               torch.empty(E, K, N, dtype=dtype))

    for K, N in ((1024, 4096), (4096, 1024)):
        assert design(49152, K, N) == "sm90"
    assert design(300, 136, 72) == "sm90"           # ragged tiles, 16-byte rows
    assert design(49152, 1, 1024) == "mma_sync"     # ones (M, 1): 2-byte rows
    assert design(49152, 1, 4096) == "mma_sync"
    assert design(256, 100, 128) == "mma_sync"      # K = 100: 200-byte rows
    assert design(256, 127, 128) == "mma_sync"      # odd K
    assert design(256, 128, 100) == "mma_sync"      # N = 100
    x = torch.empty(256 * 128 + 1, dtype=bf)[1:].view(256, 128)  # base + 2 B
    assert design(256, 128, 128, x=x) == "mma_sync"
    assert design(0, 128, 128) == "mma_sync"        # no rows
    assert design(256, 128, 128, dtype=torch.float32) == "fp32"
    assert design(256, 1, 128, dtype=torch.float32) == "fp32"


def test_gmm_design_rule():
    """``_gmm_design`` on the operands a launch reads (contiguous x (M, K),
    w (E, K, N) through its strides, built on CPU tensors): the GPT2-MoE
    350M forward (49152 routed rows, E = 4, (K, N) = (1024, 4096) and
    (4096, 1024), w with a unit n stride) and its dx product on w's
    transposed view (a unit k stride) in bf16 take the sm90 design, as do
    Mixtral-8x7B's 512-row chunk and 16-row decode; no rows, an odd K, a w
    with neither unit stride and an unaligned base take mma_sync; fp32
    takes fp32."""
    bf = torch.bfloat16

    def design(M, K, N, E=4, dtype=bf, x=None, w=None):
        x = torch.empty(M, K, dtype=dtype) if x is None else x
        w = torch.empty(E, K, N, dtype=dtype) if w is None else w
        return gm._gmm_design(x, w)

    def wt(E, K, N):           # the dx product's (E, K, N) view of (E, N, K)
        return torch.empty(E, N, K, dtype=bf).transpose(1, 2)

    for K, N in ((1024, 4096), (4096, 1024)):
        assert design(49152, K, N) == "sm90"
        assert design(49152, K, N, w=wt(4, K, N)) == "sm90"
    assert design(512, 14336, 4096, E=8) == "sm90"      # Mixtral chunk
    assert design(16, 14336, 4096, E=8) == "sm90"       # Mixtral decode
    assert design(1, 128, 256) == "sm90"                # one row
    assert design(0, 128, 256) == "mma_sync"            # no rows
    assert design(300, 136, 72) == "sm90"           # ragged tiles, 16-byte rows
    assert design(300, 100, 128) == "mma_sync"      # K = 100: 200-byte x rows
    assert design(300, 128, 100) == "mma_sync"      # N = 100: 200-byte w rows
    # the dx view reads w along k: N = 100 is only the output's width, but
    # K = 100 makes 200-byte w lines
    assert design(300, 128, 100, w=wt(4, 128, 100)) == "sm90"
    assert design(300, 100, 128, w=wt(4, 100, 128)) == "mma_sync"
    every_other = torch.empty(4, 256, 256, dtype=bf)[:, :, ::2]  # no unit stride
    assert design(300, 256, 128, w=every_other) == "mma_sync"
    x = torch.empty(300 * 128 + 1, dtype=bf)[1:].view(300, 128)  # base + 2 B
    assert design(300, 128, 128, x=x) == "mma_sync"
    assert design(49152, 1024, 4096, dtype=torch.float32) == "fp32"
    assert design(16, 64, 64, dtype=torch.float32) == "fp32"


def test_tgmm_bad_inputs_raise():
    x, dy = torch.zeros(8, 16), torch.zeros(8, 24)
    with pytest.raises(ValueError, match="want x"):
        gm.grouped_tgmm(x, torch.zeros(7, 24), torch.tensor([4, 4]))
    with pytest.raises(ValueError, match="group_sizes"):
        gm.grouped_tgmm(x, dy, torch.tensor([4.0, 4.0]))
    with pytest.raises(TypeError, match="dtype"):
        gm.grouped_tgmm(x, dy.to(torch.bfloat16), torch.tensor([4, 4]))


# ------------------------------------------------------------ the MoE layer


def _moe_data(seed, S=64, M=128, Fd=256, E=4):
    rs = np.random.RandomState(seed)
    return dict(tokens=_rand(rs, (2, S // 2, M)), gate_w=_rand(rs, (M, E)),
                wi=_rand(rs, (E, M, Fd), 0.1), bi=_rand(rs, (E, Fd), 0.1),
                wo=_rand(rs, (E, Fd, M), 0.1), bo=_rand(rs, (E, M), 0.1))


@pytest.mark.parametrize("k", [1, 2])
def test_topk_routing_matches_jax(k):
    rs = np.random.RandomState(4)
    logits = _rand(rs, (37, 8), 2.0)
    got = moe.topk_routing(torch.from_numpy(logits), k)
    want = jmoe.topk_routing(jnp.asarray(logits), k)
    names = ("weights", "experts", "l_aux", "counts")
    for name, a, b in zip(names, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    assert got[1].dtype == torch.int32 and got[3].dtype == torch.float32


@pytest.mark.parametrize("grouped_kernel", [True, False])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_layer_ragged_matches_jax(k, grouped_kernel):
    """Output, aux loss, counts and every gradient (tokens, router, experts,
    biases) of moe_layer_ragged against the JAX layer with the same
    grouped_kernel knob (True: the Pallas kernels in interpret mode)."""
    d = _moe_data(5 + k)
    names = list(d)
    cot = np.random.RandomState(9).standard_normal(
        d["tokens"].shape).astype(np.float32)

    def jax_fn(*a):
        y, aux, counts = jmoe.moe_layer_ragged(
            *a, k=k, grouped_kernel=grouped_kernel)
        return jnp.sum(y * cot) + aux, (y, aux, counts)

    (_, (jy, jaux, jcounts)), jgrads = jax.value_and_grad(
        jax_fn, argnums=tuple(range(6)), has_aux=True)(
            *map(jnp.asarray, d.values()))
    ps = [t.requires_grad_() for t in _t(*d.values())]
    y, aux, counts = moe.moe_layer_ragged(*ps, k=k,
                                          grouped_kernel=grouped_kernel)
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum() + aux, ps)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               **CHAIN_TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert counts.dtype == torch.int32
    for name, a, b in zip(names, grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **CHAIN_TOL)


def test_expert_bias_gradient_is_the_group_row_sum():
    """The kernel backend's bias gather takes its gradient as grouped_tgmm
    of ones: the same values as the index-add of the plain gather."""
    rs = np.random.RandomState(7)
    b = torch.from_numpy(_rand(rs, (4, 24))).requires_grad_()
    experts = torch.tensor([0, 0, 0, 2, 2, 3, 3, 3, 3])
    sizes = torch.tensor([3, 0, 2, 4], dtype=torch.int32)
    dy = torch.from_numpy(_rand(rs, (9, 24)))
    got = torch.autograd.grad(moe._expert_bias(
        b, experts, sizes, {"backend": "kernel"}), b, dy)[0]
    want = torch.autograd.grad(moe._expert_bias(
        b, experts, sizes, {"backend": "ragged"}), b, dy)[0]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_moe_module_checks_and_init():
    """The constructor's checks as JAX's MoE (ragged + noisy gating and
    k < 1 raise ValueError, a bad knob raises); the dense GShard backend
    raises naming its ROADMAP item; init gives the JAX names and shapes,
    the router in fp32; EP > 1 raises naming its item."""
    with pytest.raises(ValueError, match="noisy_gate_policy"):
        MoE(32, num_experts=4, k=2, backend="ragged",
            noisy_gate_policy="RSample")
    with pytest.raises(ValueError, match="k must be"):
        MoE(32, num_experts=4, k=0, backend="ragged")
    with pytest.raises(ValueError, match="grouped_kernel"):
        MoE(32, backend="ragged", grouped_kernel="yes")
    with pytest.raises(NotImplementedError, match="GShard capacity"):
        MoE(32, num_experts=4, k=2)          # backend defaults to 'dense'
    layer = MoE(32, ffn_hidden_size=48, num_experts=4, k=2,
                backend="ragged", dtype=torch.float32)
    params = layer.init(stack=3, out_std=0.01,
                        generator=torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        "gate_w": (3, 32, 4), "wi": (3, 4, 32, 48), "bi": (3, 4, 48),
        "wo": (3, 4, 48, 32), "bo": (3, 4, 32)}
    assert params["gate_w"].dtype == torch.float32
    assert float(params["bi"].abs().max()) == 0.0
    x = torch.randn(2, 5, 32)
    one = {k: v[0] for k, v in params.items()}
    y, aux, counts = layer.apply(one, x)
    assert y.shape == x.shape and int(counts.sum()) == 2 * 10
    with pytest.raises(NotImplementedError, match="expert parallel"):
        moe.moe_layer_ragged_ep(x, *one.values(), k=2,
                                expert_parallel_size=2)
