"""Llama model family for v2 paged serving — RoPE + RMSNorm + SwiGLU + GQA.

Counterpart of ``deepspeed_tpu/models/llama.py`` (serving surface only:
``head``, ``init_paged_cache``, ``apply_paged_prefill/chunk/decode``).
Parameter names and shapes are the JAX package's, so weights move between
the two through numpy with no renaming or transposes:

  wte (V, D) | norm_f (D,) | lm_head (V, D) unless tied
  blocks: rms1 (L, D), wq (L, D, D), wk (L, D, KVD), wv (L, D, KVD),
          wo (L, D, D), rms2 (L, D), wgate (L, D, F), wup (L, D, F),
          wdown (L, F, D)       — projections are ``x @ W``

Norms, RoPE angles/products and the logits are fp32, as in the JAX model;
activations run in the parameters' dtype. Attention goes through the
Hopper paged kernels (ops/cuda/paged_attention.py) unless
``paged_kernel`` is False, the explicit dense-gather parity path.

Weight-only quantization (``quantize="int8" | "int4"`` at build, or the
serving engine's ``weight_quant`` / ``quantize_weights``): the ``blocks``
leaves that ``ops/int8_weights.quantize_tree`` takes live in ``qblocks``
as ``Int8Weight`` / ``Int4Weight`` nodes instead of parameters. Layer
weights are read through ``_w`` (the JAX ``_layer_slice``): a quantized
leaf dequantizes one layer at a time, except the FFN keys in ``_WQ_KEEP``
when the engine set ``_weight_quant_fused``; those stay quantized into
the fused-dequant kernel K7 (ops/cuda/mlp_matmul.wq_matmul).
"""

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda.mlp_matmul import wq_matmul
from ..ops.cuda.paged_attention import (paged_chunk_attention,
                                        paged_chunk_attention_reference,
                                        paged_decode_attention,
                                        paged_decode_attention_reference)
from ..ops.int8_weights import (EXCLUDE_KEYS, is_quantized, layer_slice,
                                qualifies, quantize_slices, quantize_tensor)
from ..utils.device import resolve_device

_MODEL_TODO = "(ROADMAP Queue 1, serving: more Llama-family knobs)"


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
        D, Fd, V = self.d_model, self.ffn_dim, self.vocab_size
        kvd = self.n_kv_heads * self.d_head
        block = (2 * D + D * D + 2 * D * kvd + D * D
                 + (3 if self.mlp_gated else 2) * D * Fd)
        head = 0 if self.tie_embeddings else V * D
        return V * D + self.n_layer * block + D + head


LLAMA_TINY = LlamaConfig(n_layer=2, n_head=4, n_kv_heads=2, d_model=128,
                         max_seq_len=128, vocab_size=512, remat=False)
LLAMA2_7B = LlamaConfig(n_layer=32, n_head=32, n_kv_heads=32, d_model=4096,
                        max_seq_len=4096, vocab_size=32000)
MISTRAL_7B = LlamaConfig(n_layer=32, n_head=32, n_kv_heads=8, d_model=4096,
                         d_ff=14336, max_seq_len=8192, vocab_size=32000,
                         sliding_window=4096)

LLAMA_PRESETS = {"tiny": LLAMA_TINY, "llama2-7b": LLAMA2_7B,
                 "mistral-7b": MISTRAL_7B}


def _unsupported(cfg):
    """Knobs of the JAX config this slice does not carry."""
    out = []
    if cfg.alibi:
        out.append("alibi")
    if cfg.norm_type != "rms":
        out.append(f"norm_type={cfg.norm_type!r}")
    if cfg.parallel_block:
        out.append("parallel_block")
    if cfg.qkv_bias or cfg.o_bias_on or cfg.mlp_bias_on or cfg.head_bias_on:
        out.append("bias knobs (qkv_bias/proj_bias/o_bias/mlp_bias/"
                   "head_bias)")
    if cfg.embed_norm:
        out.append("embed_norm")
    if cfg.rotary_pct < 1.0:
        out.append("rotary_pct<1")
    return out


def _rms_norm(x, scale, eps):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


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
    the head); fp32 weights multiply as they are."""
    if w.dtype == torch.float32:
        return x.float() @ w.t()
    if x.is_cuda:
        return torch.mm(x, w.t(), out_dtype=torch.float32)
    return x.float() @ w.float().t()


def _scatter_kv(pool, blocks, offsets, vals):
    """pool (NB, KVH, BS, hd)[blocks[i], :, offsets[i]] = vals[i], in place
    (index_put_ through a (NB, BS, KVH, hd) view of the same storage)."""
    pool.permute(0, 2, 1, 3).index_put_((blocks.long(), offsets.long()),
                                        vals.to(pool.dtype))


_QUANT_BITS = {"int8": 8, "int4": 4}


def _quant_bits(mode):
    if mode not in _QUANT_BITS:
        raise ValueError(f"quantize must be None|'int8'|'int4', got "
                         f"{mode!r}")
    return _QUANT_BITS[mode]


class Llama(nn.Module):
    """Serving-side Llama. ``device`` defaults to the card (raises without
    one); ``dtype`` defaults to ``config.dtype``; weights are random from a
    ``torch.Generator`` seeded with ``seed`` (load real or converted
    weights with ``load_state_dict``). ``quantize`` ("int8" | "int4")
    quantizes each block leaf as it is drawn, one (In, Out) slice at a
    time, so the float model never exists: bitwise
    ``quantize_tree(Llama(config, seed=seed).params_tree())``."""

    # FFN keys the fused path keeps quantized (engine weight_quant)
    _WQ_KEEP = ("wgate", "wup", "wdown")
    _weight_quant_fused = False

    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 seed=0, quantize=None):
        super().__init__()
        bad = _unsupported(config)
        if bad:
            raise NotImplementedError(
                f"Llama port does not carry {', '.join(bad)} yet "
                f"{_MODEL_TODO}")
        self.config = config
        dev = resolve_device(device)
        dt = dtype if dtype is not None else getattr(torch, config.dtype)
        # attention dispatch: "auto"/True = the paged kernels, False = the
        # dense-gather parity path
        self.paged_kernel = "auto"
        bits = _quant_bits(quantize) if quantize else 0

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
            # one (rows, cols) slice at a time (one row at a time for a
            # 2-D table): the fp32 draw never holds a whole stacked tensor.
            # A block leaf (``key``) that quantize_tree takes is quantized
            # slice by slice as it is drawn, from the same draws.
            if (bits and key is not None and len(shape) > 2
                    and qualifies(key, shape, dtype)):
                return quantize_slices(shape, slices(shape, s, dtype), bits,
                                       dev)
            out = torch.empty(shape, dtype=dtype, device=dev)
            flat = out.view(-1, *shape[-2:]) if len(shape) > 2 else out
            for i in range(flat.shape[0]):
                flat[i].copy_(torch.randn(flat.shape[1:], generator=gen,
                                          device=dev) * s)
            return nn.Parameter(out, requires_grad=False)

        def ones(shape):
            return nn.Parameter(torch.ones(shape, dtype=dt, device=dev),
                                requires_grad=False)

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
    def params_tree(self):
        """The JAX parameter tree: ``wte``, ``norm_f``, ``lm_head`` and
        ``blocks`` (tensors and quantized nodes), sharing storage."""
        tree = {k: getattr(self, k) for k in ("wte", "norm_f", "lm_head")
                if hasattr(self, k)}
        tree["blocks"] = {**dict(self.blocks.items()), **self.qblocks}
        return tree

    def quantize_(self, mode):
        """Quantize the float model in place as the JAX engine's
        ``shard_params(quantize=...)`` does (``quantize_tree``: the block
        leaves with >= 2 dims and >= 2^16 elements, never the router), one
        (In, Out) slice at a time, each float leaf freed once quantized."""
        if self.qblocks:
            raise ValueError(f"model is already quantized "
                             f"({self.weight_quant})")
        bits = _quant_bits(mode)
        for k in list(self.blocks):
            p = self.blocks[k]
            if qualifies(k, p.shape, p.dtype):
                self.qblocks[k] = quantize_tensor(p.data, bits)
                del self.blocks[k]
        self.weight_quant = mode
        return self

    def to_serving(self, device, dtype):
        """The serving engine's cast. Unquantized: every floating parameter
        to ``dtype``, the router included (the JAX ``shard_params`` does
        the same). Quantized: codes and scales move as they are and the
        router stays fp32 (the JAX ``cast_unquantized``); the other float
        leaves take ``dtype``."""
        if not self.qblocks:
            return self.to(device=device, dtype=dtype)
        self.to(device=device)
        self.qblocks = {k: w.to(device) for k, w in self.qblocks.items()}
        for name, p in self.named_parameters():
            if (p.is_floating_point()
                    and name.rsplit(".", 1)[-1] not in EXCLUDE_KEYS):
                p.data = p.data.to(dtype)
        return self

    def load_state_dict(self, state_dict, strict=True, assign=False):
        """``nn.Module.load_state_dict`` that also takes quantized block
        leaves (``blocks.<name>`` -> ``Int8Weight`` / ``Int4Weight``, as
        ``convert.llama_params_from_numpy`` gives them for a quantized JAX
        tree); each replaces the leaf's parameter."""
        state = dict(state_dict)
        for key in [k for k, v in state.items() if is_quantized(v)]:
            name = key[len("blocks."):]
            if name in self.blocks:
                del self.blocks[name]
            self.qblocks[name] = state.pop(key).to(self.device)
        if self.qblocks:
            self.weight_quant = "int4" if any(
                w.bits == 4 for w in self.qblocks.values()) else "int8"
        return super().load_state_dict(state, strict=strict, assign=assign)

    def _w(self, name, i):
        """Layer ``i`` of block leaf ``name`` (the JAX ``_layer_slice``):
        a quantized leaf is dequantized to the model's dtype, except a
        ``_WQ_KEEP`` leaf under the fused path, which stays quantized."""
        w = self.qblocks.get(name)
        if w is None:
            return self.blocks[name][i]
        keep = self._weight_quant_fused and name in self._WQ_KEEP
        return layer_slice(w, i, self.dtype, keep=keep)

    # --------------------------------------------------------------- pieces
    def head(self, x):
        """Final RMSNorm + unembedding: (..., D) -> fp32 (..., V)."""
        x = _rms_norm(x, self.norm_f, self.config.rms_eps)
        w = self.wte if self.config.tie_embeddings else self.lm_head
        lead = x.shape[:-1]
        return _logits_f32(x.reshape(-1, x.shape[-1]), w).reshape(
            *lead, w.shape[0])

    def _attn_proj(self, x, i):
        cfg = self.config
        B, T = x.shape[0], x.shape[1]
        h = _rms_norm(x, self._w("rms1", i), cfg.rms_eps)
        q = h @ self._w("wq", i)
        k = h @ self._w("wk", i)
        v = h @ self._w("wv", i)
        return (q.reshape(B, T, cfg.n_head, cfg.d_head),
                k.reshape(B, T, cfg.n_kv_heads, cfg.d_head),
                v.reshape(B, T, cfg.n_kv_heads, cfg.d_head))

    def _rope(self, x, pos):
        return _rope(x, pos, self.config.rope_theta,
                     interleaved=self.config.rotary_interleaved)

    def _wo(self, attn, i):
        return attn @ self._w("wo", i)

    def _mlp(self, x, i):
        cfg = self.config
        h = _rms_norm(x, self._w("rms2", i), cfg.rms_eps)
        up, down = self._w("wup", i), self._w("wdown", i)
        # quantized FFN weights under the fused path: K7 streams the codes
        # and applies the scales in its epilogue (JAX llama.py:414-438)
        mm = wq_matmul if is_quantized(up) else torch.matmul
        if not cfg.mlp_gated:
            act = F.gelu(mm(h, up),
                         approximate="tanh" if cfg.mlp_act == "gelu_tanh"
                         else "none")
            return mm(act, down)
        return mm(F.silu(mm(h, self._w("wgate", i))) * mm(h, up), down)

    def _block_tail(self, x, attn, i):
        x = x + self._wo(attn, i)
        return x + self._mlp(x, i)

    def _use_kernel(self):
        return self.paged_kernel is not False

    # --------------------------------------------------------- paged cache
    def init_paged_cache(self, num_blocks, block_size, dtype=None):
        """LISTS of per-layer heads-major pools (NB, KVH, BS, hd); each is
        updated in place by the paged programs (the JAX package donates
        per-layer pools for the same reason)."""
        cfg = self.config
        dt = dtype if dtype is not None else self.dtype
        shape = (num_blocks, cfg.n_kv_heads, block_size, cfg.d_head)
        return {"k": [torch.zeros(shape, dtype=dt, device=self.device)
                      for _ in range(cfg.n_layer)],
                "v": [torch.zeros(shape, dtype=dt, device=self.device)
                      for _ in range(cfg.n_layer)]}

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
        H, hd = cfg.n_head, cfg.d_head
        length = int(length)
        x = F.embedding(input_ids.long(), self.wte)
        pos = torch.arange(T, device=input_ids.device)[None, :]
        BS = cache["k"][0].shape[2]
        prefill_table = token_blocks[::BS].to(torch.int32).contiguous()
        attend = (paged_chunk_attention if self._use_kernel()
                  else paged_chunk_attention_reference)
        for i in range(cfg.n_layer):
            kc, vc = cache["k"][i], cache["v"][i]
            q, k, v = self._attn_proj(x, i)
            q = self._rope(q, pos)
            k = self._rope(k, pos)
            _scatter_kv(kc, token_blocks, token_offsets, k[0])
            _scatter_kv(vc, token_blocks, token_offsets, v[0])
            attn = attend(q[0].contiguous(), kc, vc, prefill_table, 0, length,
                          window=cfg.sliding_window)
            x = self._block_tail(x, attn.reshape(1, T, H * hd), i)
        last = x[:, max(length - 1, 0)]
        return self.head(last), cache

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
        H, hd = cfg.n_head, cfg.d_head
        start, true_len = int(start), int(true_len)
        x = F.embedding(input_ids.long(), self.wte)
        pos = start + torch.arange(C, device=input_ids.device)[None, :]
        table = table.to(torch.int32).contiguous()
        attend = (paged_chunk_attention if self._use_kernel()
                  else paged_chunk_attention_reference)
        for i in range(cfg.n_layer):
            kc, vc = cache["k"][i], cache["v"][i]
            q, k, v = self._attn_proj(x, i)
            q = self._rope(q, pos)
            k = self._rope(k, pos)
            _scatter_kv(kc, token_blocks, token_offsets, k[0])
            _scatter_kv(vc, token_blocks, token_offsets, v[0])
            attn = attend(q[0].contiguous(), kc, vc, table, start, true_len,
                          window=cfg.sliding_window)
            x = self._block_tail(x, attn.reshape(1, C, H * hd), i)
        last = x[:, max(true_len - 1, 0)]
        return self.head(last), cache

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
        H, hd = cfg.n_head, cfg.d_head
        BS = cache["k"][0].shape[2]
        MB = block_tables.shape[1]
        lengths = lengths.to(torch.int32).contiguous()
        block_tables = block_tables.to(torch.int32).contiguous()
        pos = lengths.clamp(max=cfg.max_seq_len - 1)
        x = F.embedding(tokens.long()[:, None], self.wte)
        blk_idx = (lengths // BS).long()
        in_table = blk_idx < MB
        dst_block = torch.where(
            in_table,
            block_tables.gather(1, blk_idx.clamp(max=MB - 1)[:, None])[:, 0],
            0)
        dst_off = lengths % BS
        attend = (paged_decode_attention if self._use_kernel()
                  else paged_decode_attention_reference)
        for i in range(cfg.n_layer):
            kc, vc = cache["k"][i], cache["v"][i]
            q, k, v = self._attn_proj(x, i)           # (B, 1, ., hd)
            q = self._rope(q, pos[:, None])
            k = self._rope(k, pos[:, None])
            _scatter_kv(kc, dst_block, dst_off, k[:, 0])
            _scatter_kv(vc, dst_block, dst_off, v[:, 0])
            attn = attend(q[:, 0].contiguous(), kc, vc, block_tables, lengths,
                          window=cfg.sliding_window)
            x = self._block_tail(x, attn.reshape(B, 1, H * hd), i)
        return self.head(x)[:, 0], cache
