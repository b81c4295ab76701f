"""The port's block-sparse attention (ops/sparse_attention/ and the K11
wrapper ops/cuda/block_sparse_attention.py) held against the JAX
package's on CPU.

Layouts of every sparsity config and the kernels' block lists must come
out bitwise equal (pure numpy on both sides, BigBird's
``np.random.RandomState(seed)`` draws included). The op's forward and
gradients run through the K11 kernels' plain versions (CPU tensors) and
are held against the JAX Pallas kernels in interpret mode and against the
masked-dense op at tests/unit/test_pallas_ops.py:460-510's shapes (B=2,
T=256, H=4, d=32) and tolerances: the Fixed layout 2e-5, BigBird's
gradients 1e-4 (fp32 sums over another set of blocks in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.pallas import block_sparse_attention as jbsa
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as tbsa

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)

# (class name, kwargs, seq_len): tests/unit/test_misc_runtime.py:25-60's
# configs, plus per-head layouts and two more BigBird seeds
LAYOUT_CASES = [
    ("DenseSparsityConfig", dict(num_heads=2, block=16), 64),
    ("FixedSparsityConfig", dict(num_heads=1, block=16, num_local_blocks=2,
                                 num_global_blocks=1,
                                 attention="unidirectional"), 128),
    ("FixedSparsityConfig", dict(num_heads=4, block=16), 256),
    ("FixedSparsityConfig", dict(num_heads=2, block=16,
                                 horizontal_global_attention=True), 256),
    ("FixedSparsityConfig", dict(num_heads=3, block=16, num_local_blocks=3,
                                 num_global_blocks=2,
                                 different_layout_per_head=True), 160),
    ("BigBirdSparsityConfig", dict(num_heads=1, block=16,
                                   num_sliding_window_blocks=3,
                                   num_global_blocks=1,
                                   num_random_blocks=1), 128),
    ("BigBirdSparsityConfig", dict(num_heads=4, block=16,
                                   different_layout_per_head=True,
                                   num_random_blocks=2, seed=1), 256),
    ("BigBirdSparsityConfig", dict(num_heads=2, block=32,
                                   attention="unidirectional", seed=7), 512),
    ("BSLongformerSparsityConfig", dict(num_heads=1, block=16,
                                        global_block_indices=(2,)), 128),
    ("BSLongformerSparsityConfig", dict(num_heads=2, block=16,
                                        different_layout_per_head=True,
                                        global_block_indices=(0, 5),
                                        attention="unidirectional"), 128),
]
_IDS = [f"{c[0].replace('SparsityConfig', '')}{i}"
        for i, c in enumerate(LAYOUT_CASES)]


@pytest.mark.parametrize("name,kw,T", LAYOUT_CASES, ids=_IDS)
def test_layouts_bitwise_equal_jax(name, kw, T):
    got = getattr(tsa, name)(**kw).make_layout(T)
    want = getattr(jsa, name)(**kw).make_layout(T)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_indivisible_seq_raises():
    with pytest.raises(ValueError):
        tsa.FixedSparsityConfig(num_heads=1, block=16).make_layout(100)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name,kw,T", LAYOUT_CASES, ids=_IDS)
def test_layout_lists_equal_jax(name, kw, T, causal):
    lay = getattr(tsa, name)(**kw).make_layout(T)
    n = T // kw["block"]
    got = tbsa.layout_lists(lay, causal, n, n)
    want = jbsa.layout_lists(lay, causal, n, n)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _qkv(B=2, T=256, H=4, d=32, seed=0):
    """test_pallas_ops.py TestBlockSparseAttention._qkv."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, T, H, d) * 0.3).astype(np.float32)
            for _ in range(3)]


def _port(op, arrays, grads):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    o = op(q, k, v)
    if not grads:
        return [o.detach().numpy()]
    g = torch.autograd.grad((o ** 2).sum(), (q, k, v))
    return [o.detach().numpy()] + [x.numpy() for x in g]


def _jax(op, arrays, grads):
    args = [jnp.asarray(a) for a in arrays]
    o = np.asarray(op(*args))
    if not grads:
        return [o]
    g = jax.grad(lambda *a: jnp.sum(op(*a) ** 2), argnums=(0, 1, 2))(*args)
    return [o] + [np.asarray(x) for x in g]


@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("kind,causal", [("fixed", True), ("fixed", False),
                                         ("bigbird", True)])
def test_op_matches_jax_kernel_and_masked_dense(kind, causal, block,
                                                monkeypatch):
    """Forward and gradients through the K11 plain versions against the
    JAX Pallas kernels (interpret mode) and the port's masked-dense op."""
    cfg_name = {"fixed": "FixedSparsityConfig",
                "bigbird": "BigBirdSparsityConfig"}[kind]
    tcfg = getattr(tsa, cfg_name)(num_heads=4, block=block)
    jcfg = getattr(jsa, cfg_name)(num_heads=4, block=block)
    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    for key, fn in (("fwd", "bsa_forward_reference"),
                    ("dq", "bsa_dq_reference"), ("dkv", "bsa_dkv_reference")):
        real = getattr(tbsa, fn)

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(tbsa, fn, counted)
    arrays = _qkv()
    op = tsa.SparseSelfAttention(tcfg, causal=causal)
    assert op.density(256) < 1.0
    got = _port(op, arrays, grads=True)
    assert calls == {"fwd": 1, "dq": 1, "dkv": 1}
    want = _jax(jsa.SparseSelfAttention(jcfg, causal=causal,
                                        use_kernel=True), arrays, grads=True)
    dense = _port(tsa.SparseSelfAttention(tcfg, causal=causal,
                                          use_kernel=False), arrays,
                  grads=True)
    assert calls == {"fwd": 1, "dq": 1, "dkv": 1}   # masked-dense: none
    tol = GRAD_TOL if kind == "bigbird" else FWD_TOL
    for i, (g, w, dd) in enumerate(zip(got, want, dense)):
        name = ("o", "dq", "dk", "dv")[i]
        np.testing.assert_allclose(g, w, err_msg=f"{name} vs JAX", **tol)
        np.testing.assert_allclose(g, dd, err_msg=f"{name} vs dense", **tol)


def test_masked_dense_op_matches_jax():
    arrays = _qkv(T=128)
    lay = tsa.BigBirdSparsityConfig(num_heads=4, block=16).make_layout(128)
    for causal in (True, False):
        got = tsa.sparse_attention(*map(torch.from_numpy, arrays), lay, 16,
                                   causal=causal).numpy()
        want = np.asarray(jsa.sparse_attention(*map(jnp.asarray, arrays),
                                               lay, 16, causal=causal))
        np.testing.assert_allclose(got, want, **FWD_TOL)


@pytest.mark.parametrize("block", [16, 32])
def test_fully_masked_rows_zero(block):
    """Rows whose every block is absent output exactly zero and get zero
    dq (masked-dense semantics), as the JAX kernel."""
    arrays = _qkv(T=4 * block)
    layout = np.zeros((4, 4, 4), bool)
    layout[:, 1:, :] = True             # rows in block 0 fully masked
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    out = tbsa.block_sparse_attention(q, k, v, layout, block, causal=False)
    (dq,) = torch.autograd.grad((out ** 2).sum(), (q,))
    assert torch.count_nonzero(out[:, :block]) == 0
    assert torch.count_nonzero(dq[:, :block]) == 0
    assert float(out[:, block:].detach().abs().max()) > 0
    want = np.asarray(jbsa.block_sparse_attention(
        *map(jnp.asarray, arrays), layout, block, causal=False))
    np.testing.assert_array_equal(want[:, :block], 0.0)
    np.testing.assert_allclose(out.detach().numpy(), want, **FWD_TOL)


def test_lists_cached_on_device_once():
    """SparseSelfAttention uploads each (T, device)'s lists once; a call
    passes the cached int32 tensors, so the kernels read them in place."""
    op = tsa.SparseSelfAttention(tsa.FixedSparsityConfig(num_heads=4,
                                                         block=16))
    arrays = _qkv(T=64)
    op(*map(torch.from_numpy, arrays))
    first = op.lists(64, "cpu")
    op(*map(torch.from_numpy, arrays))
    assert op.lists(64, "cpu") is first
    assert all(t.dtype == torch.int32 for t in first.values())
    assert list(op._lists) == [(64, "cpu")]
    with pytest.raises(ValueError, match="heads"):
        tbsa.block_sparse_attention(
            *map(torch.from_numpy, _qkv(T=64, H=2)),
            op.layout(64), 16)


# ------------------------------------- the Hopper forward's rule and walk

# (config, causal, T): the SparseSelfAttention cells (a) Fixed causal and
# (b) BigBird at T=8192, block 64, and the per-head block-16 layout
UNION_CASES = {
    "a": (tsa.FixedSparsityConfig(num_heads=16, block=64, num_local_blocks=4,
                                  num_global_blocks=1,
                                  attention="unidirectional"), True, 8192),
    "b": (tsa.BigBirdSparsityConfig(num_heads=16, block=64), False, 8192),
    "block16": (tsa.BigBirdSparsityConfig(num_heads=16, block=16,
                                          different_layout_per_head=True,
                                          num_random_blocks=2), True, 2048),
}


@pytest.mark.parametrize("case", sorted(UNION_CASES))
def test_union_lists_bitwise_numpy(case):
    """The union walk (urows, ubits, ucnt) against a numpy construction
    straight from the layout: per head and query-block pair, the key blocks
    either row holds (after the causal cut), ascending, with bit 0 / bit 1
    for the even / odd row."""
    cfg, causal, T = UNION_CASES[case]
    lay = cfg.make_layout(T)
    n = T // cfg.block
    if causal:
        lay = lay & np.tril(np.ones((n, n), bool))[None]
    lists = tbsa.lists_on(tbsa.layout_lists(lay, causal, n, n), "cpu")
    H, n2 = lay.shape[0], (n + 1) // 2
    assert tuple(lists["ucnt"].shape) == (H, n2)
    for key in ("urows", "ubits", "ucnt", "uorder"):
        assert lists[key].dtype == torch.int32, key
    for h in range(H):
        for p in range(n2):
            even = lay[h, 2 * p]
            odd = lay[h, 2 * p + 1] if 2 * p + 1 < n else np.zeros(n, bool)
            ids = np.nonzero(even | odd)[0]
            bits = even[ids].astype(np.int32) | (odd[ids].astype(np.int32)
                                                 << 1)
            c = int(lists["ucnt"][h, p])
            assert c == len(ids), (h, p)
            np.testing.assert_array_equal(lists["urows"][h, p, :c].numpy(),
                                          ids)
            np.testing.assert_array_equal(lists["ubits"][h, p, :c].numpy(),
                                          bits)
            assert not lists["urows"][h, p, c:].any()
            assert not lists["ubits"][h, p, c:].any()


@pytest.mark.parametrize("case", sorted(UNION_CASES))
def test_union_item_order(case):
    """uorder: every (head, pair) once, the longest union first, ties in
    index order (a stable sort), so the persistent kernel starts the long
    walks of every instance first and the short ones fill the tail."""
    cfg, causal, T = UNION_CASES[case]
    lists = tsa.SparseSelfAttention(cfg, causal=causal).lists(T, "cpu")
    order = lists["uorder"].numpy()
    cnt = lists["ucnt"].numpy().reshape(-1)
    np.testing.assert_array_equal(np.sort(order), np.arange(cnt.size))
    assert np.all(np.diff(cnt[order]) <= 0)
    for c in np.unique(cnt):
        same = order[cnt[order] == c]
        assert np.all(np.diff(same) > 0), c
    # the union never holds fewer blocks than either row, nor more than both
    rows = lists["row_cnt"].numpy()
    H, n = rows.shape
    pad = np.zeros((H, 2 * ((n + 1) // 2)), rows.dtype)
    pad[:, :n] = rows
    pair = pad.reshape(H, -1, 2)
    u = lists["ucnt"].numpy()
    assert np.all(u >= pair.max(-1)) and np.all(u <= pair.sum(-1))


@pytest.mark.parametrize("dtype,d,block,BH,offset,want", [
    (torch.bfloat16, 64, 64, 64, 0, "sm90"),       # (a), (b): B=4, H=16
    (torch.bfloat16, 128, 64, 64, 0, "sm90"),
    (torch.bfloat16, 32, 64, 64, 0, "mma_sync"),   # d = 32
    (torch.bfloat16, 64, 16, 64, 0, "mma_sync"),   # the block-16 cell
    (torch.bfloat16, 64, 32, 64, 0, "mma_sync"),
    (torch.bfloat16, 64, 128, 64, 0, "mma_sync"),
    (torch.bfloat16, 64, 64, 40, 0, "mma_sync"),   # BH not a multiple of H
    (torch.bfloat16, 64, 64, 64, 1, "mma_sync"),   # q off 16 bytes
    (torch.float32, 64, 64, 64, 0, "fp32"),
    (torch.float32, 32, 16, 64, 0, "fp32"),
])
def test_bsa_fwd_design_rule(dtype, d, block, BH, offset, want):
    """``_bsa_fwd_design``: dtype, head dim, block, BH against the layout's
    heads (16) and TMA addressability only."""
    T = 4 * block
    q = (torch.zeros(1 + BH * T * d, dtype=dtype)[1:].view(BH, T, d)
         if offset else torch.zeros(BH, T, d, dtype=dtype))
    k = torch.zeros(BH, T, d, dtype=dtype)
    assert tbsa._bsa_fwd_design(q, k, k, block, heads=16) == want


def test_bsa_launch_refuses_an_unknown_design():
    """A design name bsa_launch does not know raises before anything
    launches (the C launcher refuses an unknown code, and sm90 for a
    backward pass: the card test)."""
    cfg, causal, T = UNION_CASES["a"]
    lists = tsa.SparseSelfAttention(cfg, causal=causal).lists(512, "cpu")
    q = torch.zeros(16, 512, 64, dtype=torch.bfloat16)
    o = torch.empty_like(q)
    lse = torch.empty(16, 512)
    tbsa.reset_launch_counts()
    with pytest.raises(ValueError, match="unknown design"):
        tbsa._launch(0, "bsa_forward", 64, True, lists, "wgmma", q=q, k=q,
                     v=q, o=o, lse=lse)
    assert tbsa.DESIGN_LAUNCHES["bsa_fwd"] == {"sm90": 0, "mma_sync": 0,
                                               "fp32": 0}


@pytest.mark.parametrize("dtype,d,block,BH,offset,want", [
    (torch.bfloat16, 64, 64, 64, 0, "sm90"),       # (a), (b): B=4, H=16
    (torch.bfloat16, 128, 64, 64, 0, "sm90"),
    (torch.bfloat16, 64, 64, 16, 0, "sm90"),       # one instance a head
    (torch.bfloat16, 32, 64, 64, 0, "mma_sync"),   # d = 32
    (torch.bfloat16, 64, 16, 64, 0, "mma_sync"),   # the block-16 cell
    (torch.bfloat16, 64, 32, 64, 0, "mma_sync"),
    (torch.bfloat16, 128, 128, 64, 0, "mma_sync"),
    (torch.bfloat16, 64, 64, 40, 0, "mma_sync"),   # BH not a multiple of H
    (torch.bfloat16, 64, 64, 64, 1, "mma_sync"),   # q off 16 bytes
    (torch.bfloat16, 64, 64, 64, 2, "mma_sync"),   # do off 16 bytes
    (torch.bfloat16, 64, 64, 64, 3, "mma_sync"),   # o off 16 bytes (dq)
    (torch.float32, 64, 64, 64, 0, "fp32"),
    (torch.float32, 32, 16, 64, 0, "fp32"),
])
def test_bsa_bwd_design_rule(dtype, d, block, BH, offset, want):
    """``_bsa_bwd_design``: dtype, head dim, block, BH against the layout's
    heads (16) and TMA addressability of q, k, v, do (and o where given)
    only; ``offset`` moves one of them off 16 bytes."""
    T = 4 * block

    def operand(moved):
        if moved:
            return torch.zeros(1 + BH * T * d, dtype=dtype)[1:].view(BH, T, d)
        return torch.zeros(BH, T, d, dtype=dtype)

    q, k, do, o = (operand(offset == i) for i in (1, -1, 2, 3))
    assert tbsa._bsa_bwd_design(q, k, k, do, block, 16, o) == want
    if offset != 3:
        assert tbsa._bsa_bwd_design(q, k, k, do, block, heads=16) == want


@pytest.mark.parametrize("case", sorted(UNION_CASES))
def test_row_col_orders_bitwise_numpy(case):
    """rorder / corder (the Hopper backward's item orders, built with the
    lists): a stable numpy argsort of -count over the (head, block) entries
    of the row and of the column lists; each entry's instances run side by
    side in the kernel, so every (instance, block) item is visited once."""
    cfg, causal, T = UNION_CASES[case]
    lists = tsa.SparseSelfAttention(cfg, causal=causal).lists(T, "cpu")
    for key, cnt in (("rorder", "row_cnt"), ("corder", "col_cnt")):
        order = lists[key]
        assert order.dtype == torch.int32 and order.is_contiguous(), key
        c = lists[cnt].numpy().reshape(-1)
        np.testing.assert_array_equal(
            order.numpy(), np.argsort(-c, kind="stable").astype(np.int32))
        # the kernel's item w of BH * H * n (B = 4 instances a head)
        H, n, reps = lists[cnt].shape[0], lists[cnt].shape[1], 4
        w = np.arange(H * n * reps)
        hb = order.numpy()[w // reps]
        bh = (w % reps) * H + hb // n
        items = set(zip(bh.tolist(), (hb % n).tolist()))
        assert len(items) == H * n * reps
        assert np.all(np.diff(c[hb]) <= 0)


def test_bsa_backward_launch_refuses_an_unknown_design():
    """A design name bsa_launch does not know raises for the dq and the
    dk/dv passes before anything launches, and counts nothing (the C
    launcher's refusals: the card test)."""
    cfg, causal, T = UNION_CASES["a"]
    lists = tsa.SparseSelfAttention(cfg, causal=causal).lists(512, "cpu")
    q = torch.zeros(16, 512, 64, dtype=torch.bfloat16)
    lse = torch.zeros(16, 512)
    tbsa.reset_launch_counts()
    for which, name, out in ((1, "bsa_dq", dict(o=q, dq=q)),
                             (2, "bsa_dkv", dict(dk=q, dv=q))):
        with pytest.raises(ValueError, match="unknown design"):
            tbsa._launch(which, name, 64, True, lists, "wgmma", q=q, k=q,
                         v=q, lse=lse, dout=q, delta=lse, **out)
    assert tbsa.LAUNCHES == {"bsa_fwd": 0, "bsa_dq": 0, "bsa_dkv": 0}
    for name in ("bsa_dq", "bsa_dkv"):
        assert tbsa.DESIGN_LAUNCHES[name] == {"sm90": 0, "mma_sync": 0,
                                              "fp32": 0}
