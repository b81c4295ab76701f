"""The query-major flash backward (K2-qmajor) of the port held against the
JAX package's ``_bwd_kernel_t_qmajor`` on CPU.

The JAX side runs ``flash_attention(qkv_t=True, bwd_qmajor=True)`` with its
Pallas kernels in interpret mode; the port's side runs the same call on CPU
tensors, which takes the kernel's plain version
(``flash_bwd_qmajor_reference``). Shapes and tolerances are
tests/unit/test_pallas_ops.py:936-1035's (B=2, H=4, d=32, T=256 on the
(B, H, d, T) layout; gradients at rtol=atol=1e-4). Then the plain
query-major and k-major versions against each other (fp32 sums in another
order: 1e-5), a tiny GPT-2 with ``flash_bwd_qmajor=True`` against the JAX
model (loss 2e-5, gradients 1e-4, as test_torch_gpt2_training.py), and three
``train_batch`` steps against the JAX engine (test_torch_engine.py's
tolerances)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.models import GPT2Config as JGPT2Config
from deepspeed_tpu.ops.pallas.flash_attention import attention_reference
from deepspeed_tpu.ops.pallas.flash_attention import \
    flash_attention as jflash
from deepspeed_tpu.ops.pallas.flash_attention import \
    flash_attention_with_lse as jflash_lse
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models import GPT2, GPT2Config, gpt2_params_from_numpy
from deepspeed_tpu_torch.ops.cuda import flash_attention as tfa

GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
PLAIN_TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(B=2, T=256, H=4, d=32, seed=0):
    """test_pallas_ops.py TestFlashBwdQMajor._qkv: (B, H, d, T) * 0.3."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, H, d, T) * 0.3).astype(np.float32)
            for _ in range(3)]


def _counted(monkeypatch):
    """Count the port's plain backward versions (the kernels' stand-ins on
    CPU)."""
    calls = {"qmajor": 0, "kmajor": 0}
    for key, name in (("qmajor", "flash_bwd_qmajor_reference"),
                      ("kmajor", "flash_backward_reference")):
        real = getattr(tfa, name)

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(tfa, name, counted)
    return calls


def _jax_grads(arrays, with_lse=False, **kw):
    def loss(q, k, v):
        if with_lse:
            o, lse = jflash_lse(q, k, v, qkv_t=True, **kw)
            return jnp.sum(o.astype(jnp.float32) ** 2) + 0.1 * jnp.sum(lse)
        o = jflash(q, k, v, qkv_t=True, **kw)
        return jnp.sum(o.astype(jnp.float32) ** 2)
    return [np.asarray(g) for g in
            jax.grad(loss, (0, 1, 2))(*map(jnp.asarray, arrays))]


def _port_grads(arrays, with_lse=False, **kw):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    if with_lse:
        o, lse = tfa.flash_attention_with_lse(q, k, v, qkv_t=True, **kw)
        loss = (o.float() ** 2).sum() + 0.1 * lse.sum()
    else:
        loss = (tfa.flash_attention(q, k, v, qkv_t=True, **kw).float()
                ** 2).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, (q, k, v))]


@pytest.mark.parametrize("case", [
    dict(block_q=128, block_k=128), dict(block_q=256, block_k=256),
    dict(block_q=64, block_k=128), dict(block_q=128, block_k=128,
                                         window=100),
    dict(block_q=128, block_k=128, T=200), dict(block_q=128, block_k=128,
                                                with_lse=True)],
    ids=["128x128", "256x256", "64x128", "window100", "padded_T200",
         "lse_cotangent"])
def test_qmajor_backward_matches_jax(case, monkeypatch):
    case = dict(case)
    arrays = _qkv(T=case.pop("T", 256))
    with_lse = case.pop("with_lse", False)
    want = _jax_grads(arrays, with_lse, bwd_qmajor=True, **case)
    calls = _counted(monkeypatch)
    got = _port_grads(arrays, with_lse, bwd_qmajor=True, **case)
    assert calls == {"qmajor": 1, "kmajor": 0}
    for g, w, n in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, w, err_msg=f"d{n}", **GRAD_TOL)


def test_qmajor_backward_matches_dense_reference():
    arrays = _qkv()

    def ref_loss(q, k, v):
        t = lambda x: x.transpose(0, 3, 1, 2)
        return jnp.sum(attention_reference(
            t(q), t(k), t(v), causal=True).astype(jnp.float32) ** 2)

    want = jax.grad(ref_loss, (0, 1, 2))(*map(jnp.asarray, arrays))
    got = _port_grads(arrays, bwd_qmajor=True)
    for g, w, n in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"d{n}",
                                   **GRAD_TOL)


def test_qmajor_serves_qkv_t_only_and_auto_is_kmajor(monkeypatch):
    """The JAX dispatch: qkv_t with bwd_qmajor=True takes the query-major
    backward; another layout, or "auto" (False on a winner-cache miss),
    the k-major one."""
    calls = _counted(monkeypatch)
    arrays = _qkv(T=64)
    _port_grads(arrays, bwd_qmajor="auto")
    assert calls == {"qmajor": 0, "kmajor": 1}
    q = torch.from_numpy(arrays[0]).transpose(-1, -2).requires_grad_()
    tfa.flash_attention(q, q, q, heads_major=True,
                        bwd_qmajor=True).sum().backward()
    assert calls == {"qmajor": 0, "kmajor": 2}
    assert tfa.LAUNCHES["flash_bwd_qmajor"] == 0     # CPU: plain versions


@pytest.mark.parametrize("d,dtype,want", [
    (64, torch.bfloat16, "sm90"), (128, torch.bfloat16, "sm90"),
    (32, torch.bfloat16, "mma_sync"), (64, torch.float32, "fp32")])
def test_qmajor_bwd_design_rule(d, dtype, want):
    """flash_backward_qmajor's operands as it hands them to the launcher:
    the qkv_t layout (B, H, d, T) seen as (B, H, T, d), made d-contiguous
    by ``_kernel_view``, with ``empty_like`` gradients, take
    ``_bwd_design``'s rule: bf16 at d = 64 / 128 (GPT-2 350M's query-major
    path at H=16, T=1024) -> sm90, d = 32 -> mma_sync, fp32 -> fp32; the
    raw views, whose d is not contiguous, are never sm90."""
    x = torch.empty(2, 16, d, 1024, dtype=dtype)
    raw = [tfa._to_bhtd(x, False, True) for _ in range(5)]
    views = [tfa._kernel_view(t) for t in raw]
    grads = [torch.empty_like(t) for t in views[:3]]
    assert tfa._bwd_design(*views, grads) == want
    assert want in tfa._DESIGN_CODE
    assert tfa._bwd_design(*raw) == ("fp32" if want == "fp32" else
                                     "mma_sync")


@pytest.mark.parametrize("B,H,T,d,causal,window,dlse", [
    (2, 3, 200, 32, True, 0, False), (1, 2, 130, 64, True, 100, True),
    (2, 2, 100, 32, False, 0, True), (1, 2, 64, 128, True, 0, False)])
def test_qmajor_plain_equals_kmajor_plain(B, H, T, d, causal, window, dlse):
    rs = np.random.RandomState(T)
    q, k, v, do = (torch.from_numpy(rs.randn(B, H, T, d).astype(np.float32))
                   for _ in range(4))
    q = q * 0.3
    o, lse = tfa.flash_forward_reference(q, k, v, causal=causal,
                                         window=window)
    dl = torch.from_numpy(rs.randn(B, H, T).astype(np.float32)) \
        if dlse else None
    a = tfa.flash_backward_reference(q, k, v, o, lse, do, causal=causal,
                                     window=window, dlse=dl)
    b = tfa.flash_bwd_qmajor_reference(q, k, v, o, lse, do, causal=causal,
                                       window=window, dlse=dl)
    for x, y, n in zip(a, b, "qkv"):
        torch.testing.assert_close(y, x, msg=f"d{n}", **PLAIN_TOL)


# ------------------------------------------------------------------ GPT-2

BASE = dict(n_layer=2, n_head=2, d_model=64, max_seq_len=64, vocab_size=200,
            dtype="float32", use_flash_attention=True, flash_qkv_t=True,
            flash_bwd_qmajor=True)


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks.{k}": v for k, v in tree["blocks"].items()})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("remat", [
    dict(remat=False),
    dict(remat=True, remat_policy="nothing_saveable"),
    dict(remat=True, remat_policy="save_flash", loss_chunk=24,
         fused_loss=True, fused_loss_kernel=True)],
    ids=["no_remat", "nothing_saveable", "save_flash"])
def test_gpt2_qmajor_matches_jax(remat, monkeypatch):
    over = {**BASE, **remat}
    jmodel = JGPT2(JGPT2Config(**over))
    params = jmodel.init(jax.random.key(0))
    ids = np.random.RandomState(10).randint(
        0, BASE["vocab_size"], (3, BASE["max_seq_len"])).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {"input_ids": jnp.asarray(ids)}))(params)
    jgrads = _flat(jgrads)
    model = GPT2(GPT2Config(**over), device="cpu")
    assert model.flash_qmajor
    model.load_state_dict(gpt2_params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu", torch.float32))
    calls = _counted(monkeypatch)
    loss = model.loss({"input_ids": torch.from_numpy(ids)})
    loss.backward()
    # every block's backward through the query-major plain version
    assert calls == {"qmajor": BASE["n_layer"], "kmajor": 0}
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g, jgrads[name], err_msg=name, **GRAD_TOL)


def test_train_batch_qmajor_matches_jax_engine():
    """3 AdamW steps with clipping, flash_bwd_qmajor=True on both sides, from
    the JAX engine's initial master: the same losses and final master
    (test_torch_engine.py's tolerances)."""
    cfg = dict(BASE, max_seq_len=32, remat=False)
    config = {"train_micro_batch_size_per_gpu": 1,
              "gradient_accumulation_steps": 1, "steps_per_print": 0,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 1e-3, "weight_decay": 0.01}},
              "gradient_clipping": 1.0, "zero_optimization": {"stage": 0}}
    rs = np.random.RandomState(3)
    batches = [{"input_ids": rs.randint(0, cfg["vocab_size"], (8, 32))
                .astype(np.int32)} for _ in range(3)]
    groups.reset()
    jeng, *_ = deepspeed_tpu.initialize(model=JGPT2(JGPT2Config(**cfg)),
                                        config=config)
    master0 = jax.tree.map(np.asarray, jeng.state["master"])
    jlosses = [float(jeng.train_batch(b)) for b in batches]
    model = GPT2(GPT2Config(**cfg), device="cpu")
    model.load_state_dict(gpt2_params_from_numpy(master0, "cpu",
                                                 torch.float32))
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, config={**config, "train_micro_batch_size_per_gpu": 8},
        device="cpu")
    losses = [float(eng.train_batch(b)) for b in batches]
    assert eng.config.train_batch_size == jeng.config.train_batch_size == 8
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-6)
    jm = jeng.state["master"]
    jmaster = {k: v for k, v in jm.items() if k != "blocks"}
    jmaster.update({f"blocks.{k}": v for k, v in jm["blocks"].items()})
    for name, m in eng.state["master"].items():
        np.testing.assert_allclose(m.numpy(), np.asarray(jmaster[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
