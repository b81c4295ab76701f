"""Llama model family — RoPE + RMSNorm + SwiGLU + GQA — for training and
v2 paged serving.

Counterpart of ``deepspeed_tpu/models/llama.py``: the training surface
(``apply``, ``apply_with_aux``, ``loss``, ``partition_specs``,
``flops_per_token``) and the serving surface (``head``,
``init_paged_cache``, ``apply_paged_prefill/chunk/decode/verify``, which
run under ``torch.inference_mode``). Parameter names and shapes are the
JAX package's, so weights move between the two through numpy with no
renaming or transposes:

  wte (V, D) | norm_f (D,) | lm_head (V, D) unless tied
  blocks: rms1 (L, D), wq (L, D, D), wk (L, D, KVD), wv (L, D, KVD),
          wo (L, D, D), rms2 (L, D), wgate (L, D, F), wup (L, D, F),
          wdown (L, F, D)       — projections are ``x @ W``

The architecture knobs of the JAX config are carried through every program
(training, the remat block and the four paged serving programs), which is
what the seven config-only families (Bloom, Falcon, GPT-NeoX, GPT-J,
InternLM, Phi, Qwen: ``models/{bloom,...}.py``) are made of:
``norm_type="ln"`` (LayerNorm with the ``b1`` / ``b2`` / ``norm_f_b``
shifts), ``parallel_block`` (x + attn(n1 x) + mlp(n2 x)), the bias knobs
(``qkv_bias``: ``bq`` / ``bk`` / ``bv``; ``o_bias``: ``bo``; ``mlp_bias``:
``bup`` / ``bdown`` (/ ``bgate``); ``proj_bias`` both; ``head_bias``:
``lm_head_b``), ``embed_norm`` (``embed_ln_s`` / ``embed_ln_b``),
``rotary_pct`` < 1 (the leading lanes rotate, half-split or interleaved)
and ALiBi (``alibi`` / ``alibi_inv_norm``: no rotary; training through
K1 / K2 with the slopes when flash resolves on, else dense scores plus
``_alibi_bias``; serving prefill, chunk and verify densely, decode
through K4 with the slopes whatever ``paged_kernel`` says, as the JAX
programs dispatch, llama.py:702-703, :785-786, :856, :935-936). Leaf
names, shapes and specs are JAX's (llama.py:229-325).

Norms, RoPE angles/products and the logits are fp32, as in the JAX model;
activations run in the parameters' dtype. Training (JAX llama.py:454-575)
repeats the K/V heads to the query heads before attention (``_repeat_kv``:
autograd sums dK/dV over each group) and attends through the flash
kernels K1 / K2 (ops/cuda/flash_attention.py, ``sliding_window`` as their
window) when ``use_flash_attention`` resolves on, else densely with fp32
scores; ``remat`` (policy ``nothing_saveable``) recomputes each block
whole under ``torch.utils.checkpoint``; ``loss`` takes the dense,
chunked or fused (gradient-in-forward) cross entropy of
``models/common.py`` as JAX does (no fused-CE kernel: JAX Llama's loss
has none). Serving attention goes through the Hopper paged kernels
(ops/cuda/paged_attention.py) unless ``paged_kernel`` is False, the
explicit dense-gather parity path; each paged program resolves
``paged_kernel`` / ``paged_block_c`` and the kernels' split levers for its
shape bucket through the autotune winner cache (``resolve_paged_*_levers``,
as the JAX programs call ``resolve_paged_*``).

Weight-only quantization (``quantize="int8" | "int4"`` at build, or the
serving engine's ``weight_quant`` / ``quantize_weights``): the ``blocks``
leaves that ``ops/int8_weights.quantize_tree`` takes live in ``qblocks``
as ``Int8Weight`` / ``Int4Weight`` nodes instead of parameters. Layer
weights are read through ``_w`` (the JAX ``_layer_slice``): a quantized
leaf dequantizes one layer at a time, except the FFN keys in ``_WQ_KEEP``
when the engine set ``_weight_quant_fused``; those stay quantized into
the fused-dequant kernel K7 (ops/cuda/mlp_matmul.wq_matmul).
"""

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.cuda.flash_attention import flash_attention
from ..ops.cuda.mlp_matmul import wq_matmul
from ..ops.cuda.paged_attention import (alibi_slopes, paged_chunk_attention,
                                        paged_chunk_attention_reference,
                                        paged_decode_attention,
                                        paged_decode_attention_reference,
                                        resolve_paged_chunk_levers,
                                        resolve_paged_decode_levers)
from ..ops.int8_weights import (is_quantized, qualifies, quantize_slices,
                                quantize_tensor)
from ..utils.device import resolve_device
from .common import (QuantizedBlocks, chunked_softmax_xent,
                     fused_linear_xent, mm_f32, next_token_xent, quant_bits,
                     resolve_flash, resolve_remat_policy, scatter_kv)

_TODO_REMAT = "(ROADMAP Queue 1, M3: more remat policies)"
_TODO_SEQ = "(ROADMAP Queue 1, M12: the Llama family under sequence " \
    "parallelism)"


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_seq_len: int = 2048
    n_layer: int = 16
    n_head: int = 16
    n_kv_heads: int = 16
    d_model: int = 1024
    d_ff: int = 0               # 0 = round(8/3 * d_model) to multiple of 128
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing_saveable"
    tie_embeddings: bool = False
    loss_chunk: int = 0
    fused_loss: bool = False
    use_flash_attention: object = "auto"
    flash_block_q: int = 512
    flash_block_k: int = 1024
    qkv_bias: bool = False
    rotary_pct: float = 1.0
    mlp_gated: bool = True             # False: wup + gelu + wdown only
    parallel_block: bool = False
    norm_type: str = "rms"
    proj_bias: bool = False
    o_bias: bool = False
    mlp_bias: bool = False
    head_bias: object = "auto"
    rotary_interleaved: bool = False   # gptj rotate_every_two pairing
    mlp_act: str = "gelu_tanh"         # non-gated MLP: gelu_tanh | gelu
    sliding_window: int = 0            # mistral: 0 = full causal
    alibi: bool = False
    alibi_inv_norm: bool = False
    embed_norm: bool = False

    @property
    def o_bias_on(self):
        return self.proj_bias or self.o_bias

    @property
    def mlp_bias_on(self):
        return self.proj_bias or self.mlp_bias

    @property
    def head_bias_on(self):
        return self.proj_bias if self.head_bias == "auto" \
            else bool(self.head_bias)

    @property
    def d_head(self):
        return self.d_model // self.n_head

    @property
    def ffn_dim(self):
        if self.d_ff:
            return self.d_ff
        return ((int(8 * self.d_model / 3) + 127) // 128) * 128

    def num_params(self):
        """Parameters, the biases and norm shifts included (JAX
        llama.py:131-151)."""
        D, Fd, V = self.d_model, self.ffn_dim, self.vocab_size
        kvd = self.n_kv_heads * self.d_head
        block = (2 * D + D * D + 2 * D * kvd + D * D
                 + (3 if self.mlp_gated else 2) * D * Fd)
        if self.qkv_bias:
            block += D + 2 * kvd
        if self.o_bias_on:
            block += D
        if self.mlp_bias_on:
            block += D + Fd * (2 if self.mlp_gated else 1)
        if self.norm_type == "ln":
            block += 2 * D
        head = 0 if self.tie_embeddings else V * D
        if self.head_bias_on:
            head += V
        extra_f = D if self.norm_type == "ln" else 0
        if self.embed_norm:
            extra_f += 2 * D
        return V * D + self.n_layer * block + D + extra_f + head

    def flops_per_token(self):
        """6 N (N without the embedding) + the attention's 12 L D T, a
        token's training flops (JAX llama.py:153)."""
        n = self.num_params() - self.vocab_size * self.d_model
        return 6 * n + 12 * self.n_layer * self.d_model * self.max_seq_len


LLAMA_TINY = LlamaConfig(n_layer=2, n_head=4, n_kv_heads=2, d_model=128,
                         max_seq_len=128, vocab_size=512, remat=False)
LLAMA2_7B = LlamaConfig(n_layer=32, n_head=32, n_kv_heads=32, d_model=4096,
                        max_seq_len=4096, vocab_size=32000)
MISTRAL_7B = LlamaConfig(n_layer=32, n_head=32, n_kv_heads=8, d_model=4096,
                         d_ff=14336, max_seq_len=8192, vocab_size=32000,
                         sliding_window=4096)

LLAMA_PRESETS = {"tiny": LLAMA_TINY, "llama2-7b": LLAMA2_7B,
                 "mistral-7b": MISTRAL_7B}


def _rms_norm(x, scale, eps):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _layer_norm(x, scale, bias, eps):
    """LayerNorm with a learned shift in fp32, cast back to x's dtype (JAX
    llama.py:177-182)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale.float()
            + bias.float()).to(x.dtype)


def _rope(x, pos, theta, interleaved=False):
    """x: (..., T, H, hd) with positions pos (..., T) -> rotated (angles
    and products in fp32, cast back to x's dtype). ``interleaved``: pairs
    are adjacent lanes (gptj) instead of the half-split."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = pos.float()[..., None, None] * freqs      # (..., T, 1, half)
    cos, sin = angles.cos(), angles.sin()
    if interleaved:
        x1, x2 = x[..., 0::2], x[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(x.shape)
    else:
        x1, x2 = x[..., :half], x[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _logits_f32(x, w):
    """x (N, D) @ w (V, D)^T with fp32 output. On the card the bf16 product
    accumulates in fp32 and writes fp32 logits directly (no fp32 copy of
    the head; ``mm_f32``, differentiable); fp32 weights multiply as they
    are."""
    if w.dtype == torch.float32:
        return x.float() @ w.t()
    return mm_f32(x, w.t())


def _repeat_kv(k, n_rep):
    """(B, T, KVH, hd) -> (B, T, KVH * n_rep, hd), each KV head repeated
    for its group of query heads (JAX llama.py:208)."""
    return k if n_rep == 1 else torch.repeat_interleave(k, n_rep, dim=2)


class Llama(QuantizedBlocks, nn.Module):
    """Llama for training and serving. ``device`` defaults to the card
    (raises without one); ``dtype`` defaults to ``config.dtype``; weights
    are random from a ``torch.Generator`` seeded with ``seed`` (load real
    or converted weights with ``load_state_dict``) and train (``loss``
    over the module's own parameters). ``quantize`` ("int8" | "int4")
    quantizes each block leaf as it is drawn, one (In, Out) slice at a
    time, so the float model never exists: bitwise
    ``quantize_tree(Llama(config, seed=seed).params_tree())``; a
    quantized model serves only."""

    # FFN keys the fused path keeps quantized (engine weight_quant)
    _WQ_KEEP = ("wgate", "wup", "wdown")

    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 seed=0, quantize=None):
        super().__init__()
        if config.norm_type not in ("rms", "ln"):
            raise ValueError(f"norm_type must be 'rms' or 'ln', got "
                             f"{config.norm_type!r}")
        self.config = config
        dev = resolve_device(device)
        dt = dtype if dtype is not None else getattr(torch, config.dtype)
        # attention dispatch: "auto" = the winner cache's choice per shape
        # bucket (the kernels on a cold cache), True = the paged kernels,
        # False = the dense-gather parity path; paged_block_c: the chunk
        # kernel's query tile ("auto" | int); the serving engine sets both
        self.paged_kernel = "auto"
        self.paged_block_c = "auto"
        bits = quant_bits(quantize) if quantize else 0

        L, D, Fd, V = (config.n_layer, config.d_model, config.ffn_dim,
                       config.vocab_size)
        kvd = config.n_kv_heads * config.d_head
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        std = 0.02
        res_std = std / math.sqrt(2 * L)

        def slices(shape, s, dtype):
            for _ in range(math.prod(shape[:-2])):
                yield (torch.randn(shape[-2:], generator=gen, device=dev)
                       * s).to(dtype)

        def nrm(shape, s=std, dtype=dt, key=None):
            # one (rows, cols) slice at a time (a 2-D table in runs of
            # rows of at most 2^22 values): the fp32 draw never holds a
            # whole stacked tensor. A block leaf (``key``) that
            # quantize_tree takes is quantized slice by slice as it is
            # drawn, from the same draws.
            if (bits and key is not None and len(shape) > 2
                    and qualifies(key, shape, dtype)):
                return quantize_slices(shape, slices(shape, s, dtype), bits,
                                       dev)
            out = torch.empty(shape, dtype=dtype, device=dev)
            if len(shape) == 2:
                step = max(1, (1 << 22) // shape[1])
                for r in range(0, shape[0], step):
                    rows = out[r:r + step]
                    rows.copy_(torch.randn(rows.shape, generator=gen,
                                           device=dev) * s)
                return nn.Parameter(out)
            flat = out.view(-1, *shape[-2:])
            for i in range(flat.shape[0]):
                flat[i].copy_(torch.randn(flat.shape[1:], generator=gen,
                                          device=dev) * s)
            return nn.Parameter(out)

        def ones(shape):
            return nn.Parameter(torch.ones(shape, dtype=dt, device=dev))

        def zeros(shape):
            return nn.Parameter(torch.zeros(shape, dtype=dt, device=dev))

        self.wte = nrm((V, D))
        self.norm_f = ones((D,))
        blocks = {
            "rms1": ones((L, D)),
            "wq": nrm((L, D, D), key="wq"),
            "wk": nrm((L, D, kvd), key="wk"),
            "wv": nrm((L, D, kvd), key="wv"),
            "wo": nrm((L, D, D), res_std, key="wo"),
            "rms2": ones((L, D)),
        }
        blocks.update(self._init_mlp(nrm, res_std))
        # the knobs' leaves (JAX llama.py:255-276): biases and LayerNorm
        # shifts start at zero, the embedding norm's scale at one
        if config.qkv_bias:
            blocks.update(bq=zeros((L, D)), bk=zeros((L, kvd)),
                          bv=zeros((L, kvd)))
        if config.o_bias_on:
            blocks["bo"] = zeros((L, D))
        if config.mlp_bias_on:
            blocks.update(bup=zeros((L, Fd)), bdown=zeros((L, D)))
            if config.mlp_gated:
                blocks["bgate"] = zeros((L, Fd))
        if config.head_bias_on:
            self.lm_head_b = zeros((V,))
        if config.norm_type == "ln":
            blocks.update(b1=zeros((L, D)), b2=zeros((L, D)))
            self.norm_f_b = zeros((D,))
        if config.embed_norm:
            self.embed_ln_s = ones((D,))
            self.embed_ln_b = zeros((D,))
        self.qblocks = {}
        self.weight_quant = quantize or None
        params = {}
        for k, v in blocks.items():
            # the (L, D) norm scales pass min_size at full width
            if bits and not is_quantized(v) and qualifies(k, v.shape,
                                                          v.dtype):
                v = quantize_tensor(v.data, bits)
            if is_quantized(v):
                self.qblocks[k] = v
            else:
                params[k] = v
        self.blocks = nn.ParameterDict(params)
        if not config.tie_embeddings:
            self.lm_head = nrm((V, D))

    def _init_mlp(self, nrm, res_std):
        """The blocks' FFN tensors (the dense SwiGLU or plain MLP), drawn
        with ``nrm(shape, std=0.02, dtype=the model's, key=leaf name)``; a
        subclass with another FFN overrides this."""
        L, D, Fd = self.config.n_layer, self.config.d_model, \
            self.config.ffn_dim
        out = {"wup": nrm((L, D, Fd), key="wup"),
               "wdown": nrm((L, Fd, D), res_std, key="wdown")}
        if self.config.mlp_gated:
            out["wgate"] = nrm((L, D, Fd), key="wgate")
        return out

    @property
    def dtype(self):
        return self.wte.dtype

    @property
    def device(self):
        return self.wte.device

    # ---------------------------------------------------------- quantization
    # the top-level leaves of the JAX tree (besides ``blocks``)
    TOP_KEYS = ("wte", "norm_f", "norm_f_b", "embed_ln_s", "embed_ln_b",
                "lm_head_b", "lm_head")

    # --------------------------------------------------------------- pieces
    def _head_keys(self):
        """The parameters ``head`` reads, in ``_head``'s order (the fused
        CE's head parameters; JAX llama.py:548)."""
        cfg = self.config
        keys = ["norm_f"]
        if cfg.norm_type == "ln":
            keys.append("norm_f_b")
        keys.append("wte" if cfg.tie_embeddings else "lm_head")
        if cfg.head_bias_on:
            keys.append("lm_head_b")
        return keys

    def head(self, x):
        """Final norm + unembedding (+ its bias): (..., D) -> fp32 (...,
        V)."""
        return self._head([getattr(self, k) for k in self._head_keys()], x)

    def _head(self, ps, x):
        cfg = self.config
        p = dict(zip(self._head_keys(), ps))
        if cfg.norm_type == "ln":
            x = _layer_norm(x, p["norm_f"], p["norm_f_b"], cfg.rms_eps)
        else:
            x = _rms_norm(x, p["norm_f"], cfg.rms_eps)
        w = p["wte" if cfg.tie_embeddings else "lm_head"]
        lead = x.shape[:-1]
        logits = _logits_f32(x.reshape(-1, x.shape[-1]), w).reshape(
            *lead, w.shape[0])
        if cfg.head_bias_on:
            logits = logits + p["lm_head_b"].float()
        return logits

    def _embed(self, ids):
        """Token embedding (+ the embedding LayerNorm under
        ``embed_norm``)."""
        x = F.embedding(ids.long(), self.wte)
        if self.config.embed_norm:
            x = _layer_norm(x, self.embed_ln_s, self.embed_ln_b,
                            self.config.rms_eps)
        return x

    def _norm(self, x, i, which):
        """Block norm ``which`` (1 or 2): RMSNorm, or LayerNorm with its
        shift under norm_type "ln" (JAX llama.py:329-335)."""
        cfg = self.config
        if cfg.norm_type == "ln":
            return _layer_norm(x, self._w(f"rms{which}", i),
                               self._w(f"b{which}", i), cfg.rms_eps)
        return _rms_norm(x, self._w(f"rms{which}", i), cfg.rms_eps)

    def _attn_proj(self, x, i):
        cfg = self.config
        B, T = x.shape[0], x.shape[1]
        h = self._norm(x, i, 1)
        q = h @ self._w("wq", i)
        k = h @ self._w("wk", i)
        v = h @ self._w("wv", i)
        if cfg.qkv_bias:
            q = q + self._w("bq", i)
            k = k + self._w("bk", i)
            v = v + self._w("bv", i)
        # this rank's heads (all of them but in a tensor-parallel world)
        return (q.reshape(B, T, -1, cfg.d_head),
                k.reshape(B, T, -1, cfg.d_head),
                v.reshape(B, T, -1, cfg.d_head))

    def _rope(self, x, pos):
        """Rotary over the leading ``rotary_pct`` of each head (JAX
        llama.py:366-382); none under ALiBi."""
        cfg = self.config
        if cfg.alibi:
            return x
        il = cfg.rotary_interleaved
        if cfg.rotary_pct >= 1.0:
            return _rope(x, pos, cfg.rope_theta, interleaved=il)
        rot = max(2, int(x.shape[-1] * cfg.rotary_pct)) // 2 * 2
        return torch.cat([_rope(x[..., :rot], pos, cfg.rope_theta,
                                interleaved=il), x[..., rot:]], dim=-1)

    def _rank_slopes(self):
        """The ALiBi slopes of this rank's heads: the slice of the model's
        slopes that its global heads ``_tp_index * H / tp ...`` take."""
        H = self.config.n_head // self._tp
        h0 = self._tp_index * H
        return alibi_slopes(self.config.n_head)[h0:h0 + H]

    def _alibi_bias(self, k_pos):
        """(H, *k_pos.shape) fp32 additive score term slope_h * k_pos (this
        rank's heads); under ``alibi_inv_norm`` rounded through bf16 and
        divided by sqrt(hd) (JAX llama.py:384-397)."""
        cfg = self.config
        slopes = torch.tensor(self._rank_slopes(), dtype=torch.float32,
                              device=k_pos.device)
        bias = slopes.reshape(-1, *([1] * k_pos.dim())) * k_pos.float()[None]
        if cfg.alibi_inv_norm:
            bias = bias.to(torch.bfloat16).float() / math.sqrt(cfg.d_head)
        return bias

    def _alibi_kw(self):
        """The flash / paged kernels' ALiBi arguments (none without it)."""
        cfg = self.config
        if not cfg.alibi:
            return {}
        return dict(alibi_scale=(1.0 / math.sqrt(cfg.d_head)
                                 if cfg.alibi_inv_norm else 1.0),
                    alibi_bf16=cfg.alibi_inv_norm)

    def _wo(self, attn, i):
        out = self._tp_sum(attn @ self._w("wo", i))
        if self.config.o_bias_on:
            out = out + self._w("bo", i)
        return out

    def _mlp(self, x, i):
        cfg = self.config
        h = self._norm(x, i, 2)
        up, down = self._w("wup", i), self._w("wdown", i)
        pb = cfg.mlp_bias_on
        # quantized FFN weights under the fused path: K7 streams the codes
        # and applies the scales in its epilogue (JAX llama.py:414-452)
        mm = wq_matmul if is_quantized(up) else torch.matmul
        u = mm(h, up)
        if pb:
            u = u + self._w("bup", i)
        if not cfg.mlp_gated:
            act = F.gelu(u, approximate="tanh" if cfg.mlp_act == "gelu_tanh"
                         else "none")
        else:
            gt = mm(h, self._w("wgate", i))
            if pb:
                gt = gt + self._w("bgate", i)
            act = F.silu(gt) * u
        out = self._tp_sum(mm(act, down))
        return out + self._w("bdown", i) if pb else out

    def _block_tail(self, x, attn, i):
        """The block after attention: sequential x + wo(attn) then + mlp,
        or falcon/phi's parallel x + wo(attn) + mlp(x)."""
        attn_out = self._wo(attn, i)
        if self.config.parallel_block:
            return x + attn_out + self._mlp(x, i)
        x = x + attn_out
        return x + self._mlp(x, i)

    def _chunk_attend(self, C, MB, BS, dtype, device):
        """The prefill / chunk / verify attention of a C-token chunk over
        MB-block tables: K5 (paged_chunk_attention) with the levers that
        ``resolve_paged_chunk_levers`` gives this bucket, its plain version
        where ``paged_kernel`` resolves off, or the dense gather with the
        ALiBi term for ALiBi families, which JAX runs densely whatever the
        switch says, forced off before any dispatch (llama.py:702-703,
        :785-786, :935-936)."""
        cfg = self.config
        if cfg.alibi:
            return self._dense_alibi_attend
        use, bc, splits = resolve_paged_chunk_levers(
            self.paged_kernel, self.paged_block_c, C, MB, BS,
            cfg.n_kv_heads // self._tp, cfg.n_head // cfg.n_kv_heads,
            cfg.d_head, dtype, device)
        if not use:
            return paged_chunk_attention_reference
        return functools.partial(paged_chunk_attention, block_c=bc,
                                 splits=splits)

    def _decode_attend(self, B, MB, BS, dtype, device):
        """The decode step's attention: K4 with the split size that
        ``resolve_paged_decode_levers`` gives this bucket, or its plain
        version where ``paged_kernel`` resolves off. ALiBi families keep K4
        whatever ``paged_kernel`` says (JAX llama.py:856: the dense path
        lacks falcon's bf16 variant)."""
        cfg = self.config
        use, sp = resolve_paged_decode_levers(
            True if cfg.alibi else self.paged_kernel, B, MB, BS,
            cfg.n_kv_heads // self._tp, cfg.n_head // cfg.n_kv_heads,
            cfg.d_head, dtype, device)
        if not use:
            return paged_decode_attention_reference
        return functools.partial(paged_decode_attention, split_positions=sp)

    def _dense_alibi_attend(self, q, k_cache, v_cache, table, start,
                            true_len, window=0):
        """Dense attention of a C-token query chunk at positions start ..
        start + C - 1 over the sequence's keys gathered through ``table``
        (keys below start + true_len, causal, the window), fp32 scores /
        sqrt(hd) plus ``_alibi_bias``, p rounded to q's dtype before P V
        (JAX llama.py:727-737, :813-825, :960-974). Returns (C, H, hd)."""
        C, H, hd = q.shape
        KVH, BS = k_cache.shape[1], k_cache.shape[2]
        S = table.shape[0] * BS
        tb = table.long()
        gk = k_cache[tb].transpose(1, 2).reshape(S, KVH, hd)
        gv = v_cache[tb].transpose(1, 2).reshape(S, KVH, hd)
        gk = gk.repeat_interleave(H // KVH, dim=1)
        gv = gv.repeat_interleave(H // KVH, dim=1)
        s = torch.einsum("thd,shd->hts", q.float(), gk.float())
        s = s / math.sqrt(hd)
        k_pos = torch.arange(S, device=q.device)
        s = s + self._alibi_bias(k_pos)[:, None, :]
        q_pos = (int(start) + torch.arange(C, device=q.device))[:, None]
        ok = ((k_pos[None] <= q_pos)
              & (k_pos[None] < int(start) + int(true_len)))
        if window:
            ok = ok & (q_pos - k_pos[None] < window)
        s = torch.where(ok[None], s, -1e30)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("hts,shd->thd", p, gv)

    # ------------------------------------------------------------ training
    def partition_specs(self, topology=None):
        """The JAX model's tensor-parallel specs (llama.py:282-325) by
        parameter name: "tensor" on the column-parallel out dims (wq, wk,
        wv, wgate, wup) and the row-parallel in dims (wo, wdown); the
        embeddings and norms whole. The port runs no tensor axis; the
        engine's ZeRO plan reads these so it leaves the same dims whole as
        JAX (runtime/zero/partitioning.py)."""
        cfg = self.config
        col, row, vec = (None, None, "tensor"), (None, "tensor", None), \
            (None, None)
        blocks = {"rms1": vec, "wq": col, "wk": col, "wv": col, "wo": row,
                  "rms2": vec}
        blocks.update(self._mlp_specs(topology))
        if cfg.qkv_bias:
            blocks.update(bq=(None, "tensor"), bk=(None, "tensor"),
                          bv=(None, "tensor"))
        if cfg.o_bias_on:
            blocks["bo"] = vec
        if cfg.mlp_bias_on:
            blocks.update(bup=(None, "tensor"), bdown=vec)
            if cfg.mlp_gated:
                blocks["bgate"] = (None, "tensor")
        if cfg.norm_type == "ln":
            blocks.update(b1=vec, b2=vec)
        specs = {"wte": (), "norm_f": ()}
        for key in ("norm_f_b", "embed_ln_s", "embed_ln_b", "lm_head_b",
                    "lm_head"):
            if hasattr(self, key):
                specs[key] = ()
        specs.update({f"blocks.{k}": v for k, v in blocks.items()})
        return specs

    def _check_serving_topology(self, topology):
        """A tensor-parallel rank holds whole query and KV heads (the JAX
        ``paged_cache_specs`` shard the pools' KV heads over ``tensor``):
        both counts must divide over the axis."""
        tp, cfg = topology.axis_size("tensor"), self.config
        for what, n in (("n_head", cfg.n_head),
                        ("n_kv_heads", cfg.n_kv_heads)):
            if n % tp:
                raise ValueError(
                    f"{what}={n} does not divide over tensor_parallel={tp}: "
                    f"a rank holds whole heads")

    def _mlp_specs(self, topology=None):
        col, row = (None, None, "tensor"), (None, "tensor", None)
        out = {"wup": col, "wdown": row}
        if self.config.mlp_gated:
            out["wgate"] = col
        return out

    @property
    def flash_on(self):
        """Resolved use_flash_attention ("auto": on for a CUDA model)."""
        return resolve_flash(self.config.use_flash_attention, self.device)

    def _train_attn(self, q, k, v, mask):
        """Attention over (B, T, H, hd) q and the repeated k, v: the flash
        kernels (K1 forward, K2 backward; ``sliding_window`` their window,
        the ALiBi slopes their in-kernel term) or dense fp32 scores (plus
        ``_alibi_bias``) under ``mask`` (T, T), as JAX llama.py:470-500.
        Returns (B, T, H, hd) in the model's dtype."""
        cfg = self.config
        if self.flash_on:
            al = ({"alibi": alibi_slopes(cfg.n_head), **self._alibi_kw()}
                  if cfg.alibi else {})
            return flash_attention(q, k, v, causal=True,
                                   window=cfg.sliding_window,
                                   **al).to(q.dtype)
        s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
        s = s / math.sqrt(cfg.d_head)
        if cfg.alibi:
            s = s + self._alibi_bias(torch.arange(
                q.shape[1], device=q.device))[None, :, None, :]
        s = torch.where(mask, s, -1e30)
        probs = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bhts,bshd->bthd", probs, v)

    def _train_block(self, x, pos, mask, *ws):
        """One block (JAX ``block_forward``, sequential residual): x (B,
        T, D) and the layer's tensors in ``self.blocks`` order."""
        cfg = self.config
        B, T = x.shape[0], x.shape[1]
        H, hd = cfg.n_head, cfg.d_head
        layer = dict(zip(self.blocks.keys(), ws))
        q, k, v = self._attn_proj(x, layer)
        q, k = self._rope(q, pos), self._rope(k, pos)
        n_rep = H // cfg.n_kv_heads
        attn = self._train_attn(q, _repeat_kv(k, n_rep),
                                _repeat_kv(v, n_rep), mask)
        return self._block_tail(x, attn.reshape(B, T, H * hd), layer)

    def apply(self, input_ids, *, rng=None, train=False, seq_sharded=False,
              return_hidden=False):
        """Logits (B, T, V) fp32 of (B, T) token ids (JAX llama.py:511), or
        the last block's output (B, T, D) with ``return_hidden``. Given a
        callable instead, ``nn.Module.apply``."""
        if callable(input_ids):
            return super().apply(input_ids)
        cfg = self.config
        if seq_sharded:
            raise NotImplementedError(
                f"seq_sharded Llama is not ported yet {_TODO_SEQ}")
        if self.qblocks:
            raise NotImplementedError(
                f"a {self.weight_quant} weight-quantized model serves only")
        if cfg.remat and resolve_remat_policy(
                cfg.remat_policy) != "nothing_saveable":
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r} is not ported for the "
                f"Llama family yet {_TODO_REMAT}")
        ids = torch.as_tensor(input_ids).to(self.device).long()
        B, T = ids.shape
        x = self._embed(ids)
        pos = torch.arange(T, device=ids.device)[None, :].expand(B, T)
        mask = None
        if not self.flash_on:
            i = torch.arange(T, device=ids.device)
            mask = i[:, None] >= i[None, :]
            if cfg.sliding_window:
                mask = mask & (i[:, None] - i[None, :] < cfg.sliding_window)
        layers = [p.unbind(0) for p in self.blocks.values()]
        for i in range(cfg.n_layer):
            ws = [t[i] for t in layers]
            if cfg.remat:
                x = checkpoint(self._train_block, x, pos, mask, *ws,
                               use_reentrant=False)
            else:
                x = self._train_block(x, pos, mask, *ws)
        return x if return_hidden else self.head(x)

    def apply_with_aux(self, input_ids, **kw):
        """(logits, 0.0): the family threads no aux loss (JAX
        llama.py:544)."""
        return self.apply(input_ids, **kw), torch.zeros(
            (), dtype=torch.float32, device=self.device)

    def loss(self, batch, *, rng=None, train=True, seq_sharded=False):
        """Mean next-token cross entropy of batch {"input_ids": (B, T)}
        (JAX llama.py:559-575): with ``loss_chunk`` < T - 1 the chunked
        head, fused (gradients in the forward) when ``fused_loss``; else
        the dense logits."""
        ids = torch.as_tensor(batch["input_ids"]).to(self.device)
        T = ids.shape[1]
        chunk = self.config.loss_chunk
        if chunk and T - 1 > chunk:
            x = self.apply(ids, rng=rng, train=train,
                           seq_sharded=seq_sharded, return_hidden=True)
            if self.config.fused_loss:
                keys = self._head_keys()
                return fused_linear_xent(
                    self._head, chunk, {k: getattr(self, k) for k in keys},
                    x[:, :-1], ids[:, 1:])
            return chunked_softmax_xent(self.head, x[:, :-1], ids[:, 1:],
                                        chunk)
        return next_token_xent(self.apply(ids, rng=rng, train=train,
                                          seq_sharded=seq_sharded), ids)

    # --------------------------------------------------------- paged cache
    def init_paged_cache(self, num_blocks, block_size, dtype=None):
        """LISTS of per-layer heads-major pools (NB, KVH, BS, hd); each is
        updated in place by the paged programs (the JAX package donates
        per-layer pools for the same reason). A tensor-parallel rank's
        pools hold its KVH / tp heads (the JAX ``paged_cache_specs``)."""
        cfg = self.config
        dt = dtype if dtype is not None else self.dtype
        shape = (num_blocks, cfg.n_kv_heads // self._tp, block_size,
                 cfg.d_head)
        return {"k": [torch.zeros(shape, dtype=dt, device=self.device)
                      for _ in range(cfg.n_layer)],
                "v": [torch.zeros(shape, dtype=dt, device=self.device)
                      for _ in range(cfg.n_layer)]}

    @torch.inference_mode()
    def apply_paged_prefill(self, input_ids, cache, token_blocks,
                            token_offsets, length):
        """Bucketed whole-prompt prefill of ONE sequence.

        input_ids: (1, T) right-padded prompt; token_blocks/token_offsets:
        (T,) destination block/slot per position (pads -> scratch block
        0); length: real prompt length. K/V are written into each layer's
        pool in place. Returns (logits (1, V) fp32 at position length-1,
        cache)."""
        cfg = self.config
        T = input_ids.shape[1]
        length = int(length)
        x = self._embed(input_ids)
        pos = torch.arange(T, device=input_ids.device)[None, :]
        BS = cache["k"][0].shape[2]
        prefill_table = token_blocks[::BS].to(torch.int32).contiguous()
        attend = self._chunk_attend(T, prefill_table.shape[0], BS,
                                    cache["k"][0].dtype, x.device)
        for i in range(cfg.n_layer):
            kc, vc = cache["k"][i], cache["v"][i]
            q, k, v = self._attn_proj(x, i)
            q = self._rope(q, pos)
            k = self._rope(k, pos)
            scatter_kv(kc, token_blocks, token_offsets, k[0])
            scatter_kv(vc, token_blocks, token_offsets, v[0])
            attn = attend(q[0].contiguous(), kc, vc, prefill_table, 0, length,
                          window=cfg.sliding_window)
            x = self._block_tail(x, attn.reshape(1, T, -1), i)
        last = x[:, max(length - 1, 0)]
        return self.head(last), cache

    @torch.inference_mode()
    def apply_paged_chunk(self, input_ids, cache, token_blocks,
                          token_offsets, start, true_len, table):
        """Prefill ONE CHUNK of one sequence into the paged cache (Dynamic
        SplitFuse).

        input_ids: (1, C) chunk tokens (right-padded); token_blocks/
        token_offsets: (C,) destination block/slot per chunk position
        (pads -> scratch block 0); start: absolute position of the chunk's
        first token; true_len: real tokens in the chunk; table: (MB,) the
        sequence's block table (scratch-padded). Queries attend the
        sequence's prior cache plus the in-chunk causal prefix. Returns
        (logits (1, V) fp32 at chunk position true_len-1, cache)."""
        cfg = self.config
        C = input_ids.shape[1]
        start, true_len = int(start), int(true_len)
        x = self._embed(input_ids)
        pos = start + torch.arange(C, device=input_ids.device)[None, :]
        table = table.to(torch.int32).contiguous()
        BS = cache["k"][0].shape[2]
        attend = self._chunk_attend(C, table.shape[0], BS,
                                    cache["k"][0].dtype, x.device)
        for i in range(cfg.n_layer):
            kc, vc = cache["k"][i], cache["v"][i]
            q, k, v = self._attn_proj(x, i)
            q = self._rope(q, pos)
            k = self._rope(k, pos)
            scatter_kv(kc, token_blocks, token_offsets, k[0])
            scatter_kv(vc, token_blocks, token_offsets, v[0])
            attn = attend(q[0].contiguous(), kc, vc, table, start, true_len,
                          window=cfg.sliding_window)
            x = self._block_tail(x, attn.reshape(1, C, -1), i)
        last = x[:, max(true_len - 1, 0)]
        return self.head(last), cache

    @torch.inference_mode()
    def apply_paged_decode(self, tokens, lengths, cache, block_tables):
        """One decode step for every batch slot.

        tokens: (B,) input token per slot; lengths: (B,) int32 = its
        position (= tokens already in the cache); block_tables: (B, MB)
        int32. A write position past the table (a sequence that finished
        mid-dispatch keeps decoding to the dispatch's end) goes to scratch
        block 0 — the JAX program drops such out-of-range scatters; torch
        indexing would fault instead. Returns (logits (B, V) fp32,
        cache)."""
        cfg = self.config
        B = tokens.shape[0]
        H = cfg.n_head
        BS = cache["k"][0].shape[2]
        MB = block_tables.shape[1]
        lengths = lengths.to(torch.int32).contiguous()
        block_tables = block_tables.to(torch.int32).contiguous()
        pos = lengths.clamp(max=cfg.max_seq_len - 1)
        x = self._embed(tokens[:, None])
        blk_idx = (lengths // BS).long()
        in_table = blk_idx < MB
        dst_block = torch.where(
            in_table,
            block_tables.gather(1, blk_idx.clamp(max=MB - 1)[:, None])[:, 0],
            0)
        dst_off = lengths % BS
        al = ({"alibi_slopes": self._rank_slopes(),
               "alibi_offset": self._tp_index * (H // self._tp),
               "alibi_heads": H, **self._alibi_kw()} if cfg.alibi else {})
        attend = self._decode_attend(B, MB, BS, cache["k"][0].dtype,
                                     x.device)
        for i in range(cfg.n_layer):
            kc, vc = cache["k"][i], cache["v"][i]
            q, k, v = self._attn_proj(x, i)           # (B, 1, ., hd)
            q = self._rope(q, pos[:, None])
            k = self._rope(k, pos[:, None])
            scatter_kv(kc, dst_block, dst_off, k[:, 0])
            scatter_kv(vc, dst_block, dst_off, v[:, 0])
            attn = attend(q[:, 0].contiguous(), kc, vc, block_tables, lengths,
                          window=cfg.sliding_window, **al)
            x = self._block_tail(x, attn.reshape(B, 1, -1), i)
        return self.head(x)[:, 0], cache

    @torch.inference_mode()
    def apply_paged_verify(self, tokens, lengths, cache, block_tables):
        """Speculative verify: C tokens a slot in ONE pass (the JAX
        ``apply_paged_verify``).

        tokens: (B, C) per slot, the last committed token then the draft's
        proposals; lengths: (B,) HOST ints (numpy or a list) = each slot's
        first input position; block_tables: (B, MB) int32. RoPE runs at
        each slot's absolute positions, the K/V of all B x C tokens are
        scattered first, then each slot's C queries attend its cache
        through the chunk kernel (K5) with start = lengths[b] and true_len
        = C: B launches a layer, their ints from the host, so no layer
        waits on the device. A write position past the table lands in the
        table's last block, as the JAX program clamps it (the scheduler
        never speculates that far). Returns (logits (B, C, V) fp32,
        cache)."""
        cfg = self.config
        B, C = tokens.shape
        hd = cfg.d_head
        BS = cache["k"][0].shape[2]
        MB = block_tables.shape[1]
        starts = [int(n) for n in np.asarray(lengths).reshape(-1)]
        dev = tokens.device
        block_tables = block_tables.to(torch.int32).contiguous()
        linpos = (torch.as_tensor(starts, device=dev)[:, None]
                  + torch.arange(C, device=dev)[None, :])        # (B, C)
        pos = linpos.clamp(max=cfg.max_seq_len - 1)
        x = self._embed(tokens)
        fb = block_tables.gather(1, (linpos // BS).clamp(max=MB - 1)) \
            .reshape(-1)
        fo = (linpos % BS).reshape(-1)
        attend = self._chunk_attend(C, MB, BS, cache["k"][0].dtype, dev)
        for i in range(cfg.n_layer):
            kc, vc = cache["k"][i], cache["v"][i]
            q, k, v = self._attn_proj(x, i)           # (B, C, ., hd)
            q = self._rope(q, pos)
            k = self._rope(k, pos)
            scatter_kv(kc, fb, fo, k.reshape(B * C, -1, hd))
            scatter_kv(vc, fb, fo, v.reshape(B * C, -1, hd))
            attn = torch.stack([
                attend(q[b], kc, vc, block_tables[b], starts[b], C,
                       window=cfg.sliding_window)
                for b in range(B)])
            x = self._block_tail(x, attn.reshape(B, C, -1), i)
        return self.head(x), cache
