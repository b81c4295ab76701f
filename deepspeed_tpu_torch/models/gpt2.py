"""GPT-2 model family for training and v2 paged serving.

Counterpart of ``deepspeed_tpu/models/gpt2.py``: the training surface (the
config and presets, ``embed``, ``head``, the blocks, the dense MLP and
``loss`` with its chunked and fused cross-entropy heads) and the serving
surface (``init_paged_cache``, ``apply_paged_prefill/chunk/decode/verify``
under ``torch.inference_mode``, what ``QuantizedBlocks`` gives the engine).
OPT (``models/opt.py``) and GPT-Neo (``models/gpt_neo.py``) are this class
at other configs, as in JAX. Parameter names
and shapes are the JAX package's, so weights move between the two through
numpy with no renaming or transposes (``convert.gpt2_params_from_numpy``):

  wte (V, D) | wpe (T, D) | lnf_{scale,bias} (D,)
  blocks: ln1_{scale,bias} (L, D), wqkv (L, D, 3D), bqkv (L, 3D),
          wo (L, D, D), bo (L, D), ln2_{scale,bias} (L, D),
          wup (L, D, F), bup (L, F), wdown (L, F, D), bdown (L, D)
                                                 — projections are ``x @ W``

LayerNorm statistics and the logits are fp32, as in the JAX model;
activations run in the parameters' dtype. Each block returns ``(x, aux)``
and ``loss`` adds ``moe_loss_coeff`` times the aux summed over layers (the
MoE load-balance loss of ``gpt2_moe.GPT2MoE``; a dense block's aux is None,
where JAX's is 0.0 times a zero coefficient). Attention goes through the
Hopper flash kernels (ops/cuda/flash_attention.py) when
``use_flash_attention`` resolves on, else the dense path; its backward
through the query-major kernel when ``flash_bwd_qmajor`` resolves on
(``flash_qmajor``); the loss head
through the fused CE kernel when ``fused_loss_kernel``; every LayerNorm
through the K13 kernels (ops/cuda/layernorm.py) when ``fused_layernorm``
(``_ln``); the MLP projections through K6 (ops/cuda/mlp_matmul.py) when
``mlp_kernel`` (``_mlp``).

Per-layer windows (``attn_layer_windows``, GPT-Neo's local layers; 0 =
global): in training every layer of such a model attends densely with the
mask ``causal & ((w == 0) | (q - k < w))``, as JAX forces the dense path
for a window operand (gpt2.py:553-556, :674), remat and Ulysses included;
ring attention raises for windows and for unscaled scores. The serving
programs pass each layer's window to the paged kernels (K4 / K5), and
``scale_attn=False`` as ``scale = 1.0``.

Serving (JAX gpt2.py:910-1224): learned positions, clamped to the last
``wpe`` row (a finished slot keeps decoding to its dispatch's end); the
prefill, chunk and verify attend through K5 (``paged_chunk_attention``,
the verify once per slot and layer), decode through K4
(``paged_decode_attention``); ``paged_kernel=False`` takes their plain
versions (the dense-gather parity path). Each program resolves
``paged_kernel`` / ``paged_block_c`` and the kernels' split levers for its
shape bucket (KVH = n_head, G = 1) through the autotune winner cache, as
the JAX programs call ``resolve_paged_*``. Under the engine's
``weight_quant`` the FFN weights ``wup`` / ``wdown`` stay quantized into
K7 (``ops/cuda/mlp_matmul.wq_matmul``, gpt2.py:712-719) and every other
quantized leaf dequantizes one layer at a time (``_w``, the JAX
``_layer_slice``; ``quantize_weights`` dequantizes them all).

Sequence parallelism (``loss(seq_sharded=True)``, JAX gpt2.py:543-617,
:1226-1259): every rank of the ``seq`` process group passes the same
global batch, takes its contiguous block of the sequence (positions from
its offset, labels from the global ids, so a block's last label comes from
the next block) and runs the blocks with attention over the group:
``attention_backend="ring"`` through the zigzag ring (sequence/ring.py,
K10 / K2), otherwise Ulysses around the dense attention
(sequence/layer.py). The flash kernels, K6 and the chunked / fused loss
heads are not taken when seq-sharded, as in JAX; the loss is the global
mean over B * (T - 1) predictions on every rank, and each rank's
gradients are its blocks' share (the engine sums them over the group).
"""

import functools

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.cuda._common import dispatch, dtype_name, ln_bucket, mlp_bucket
from ..ops.cuda.flash_attention import (flash_attention, flash_backward,
                                        flash_backward_qmajor, flash_forward,
                                        resolve_bwd_qmajor, scale_q)
from ..ops.cuda.layernorm import (fused_layernorm, layernorm_fused_bwd,
                                  layernorm_reference as layernorm)
from ..ops.cuda.mlp_matmul import mlp_matmul, wq_matmul
from ..ops.cuda.paged_attention import (paged_chunk_attention,
                                        paged_chunk_attention_reference,
                                        paged_decode_attention,
                                        paged_decode_attention_reference,
                                        resolve_paged_chunk_levers,
                                        resolve_paged_decode_levers)
from ..ops.int8_weights import is_quantized
from ..comm import comm
from ..runtime.config import SequenceConfig
from ..sequence.layer import DistributedAttention
from ..sequence.ring import ring_attention
from ..utils import groups, prng
from ..utils.device import resolve_device
from .common import (QuantizedBlocks, chunked_softmax_xent,
                     fused_linear_xent, fused_linear_xent_kernel, mm_f32,
                     next_token_xent, resolve_flash, resolve_remat_policy,
                     scatter_kv)


@dataclass(frozen=True)
class GPT2Config:
    """Every field of the JAX ``GPT2Config`` (gpt2.py:42-150); the ones this
    port does not carry raise in ``GPT2`` (see ``_unported_knobs``). The
    flash tile knobs are accepted and change nothing."""
    vocab_size: int = 50304
    max_seq_len: int = 1024
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    dropout: float = 0.0
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing_saveable"
    use_flash_attention: object = "auto"
    flash_block_q: object = 128
    flash_block_k: object = 128
    flash_block_h: object = 2
    flash_block_q_bwd: object = 0
    flash_block_k_bwd: object = 0
    flash_qkv_t: bool = True
    attention_backend: str = "dense"
    pipe_microbatches: int = 0
    pipe_schedule: str = "gpipe"
    loss_chunk: int = 0
    fused_loss: bool = False
    fused_loss_kernel: bool = False
    scan_unroll: int = 1
    activation: str = "gelu"
    scale_attn: bool = True
    attn_layer_windows: tuple = ()
    mlp_kernel: object = False
    mlp_kernel_fuse_dw: bool = True
    flash_bwd_qmajor: object = False
    fused_layernorm: object = False

    @property
    def d_head(self):
        return self.d_model // self.n_head

    @property
    def d_ff(self):
        return 4 * self.d_model

    def num_params(self):
        wte = self.vocab_size * self.d_model
        wpe = self.max_seq_len * self.d_model
        block = (4 * self.d_model
                 + self.d_model * 3 * self.d_model + 3 * self.d_model
                 + self.d_model * self.d_model + self.d_model
                 + 2 * self.d_model * self.d_ff + self.d_ff + self.d_model)
        return wte + wpe + self.n_layer * block + 2 * self.d_model

    def flops_per_token(self):
        """6*N + attention flops per token (training fwd+bwd)."""
        n = self.num_params() - self.vocab_size * self.d_model
        return 6 * n + 12 * self.n_layer * self.d_model * self.max_seq_len


GPT2_TINY = GPT2Config(n_layer=2, n_head=4, d_model=128, max_seq_len=128,
                       vocab_size=1024)
GPT2_125M = GPT2Config(n_layer=12, n_head=12, d_model=768)
GPT2_350M = GPT2Config(n_layer=24, n_head=16, d_model=1024)
GPT2_1_3B = GPT2Config(n_layer=24, n_head=32, d_model=2048)
GPT2_13B = GPT2Config(n_layer=40, n_head=40, d_model=5120,
                      max_seq_len=2048)

PRESETS = {"tiny": GPT2_TINY, "125M": GPT2_125M, "350M": GPT2_350M,
           "1.3B": GPT2_1_3B, "13B": GPT2_13B}

BLOCK_KEYS = ("ln1_scale", "ln1_bias", "wqkv", "bqkv", "wo", "bo",
              "ln2_scale", "ln2_bias", "wup", "bup", "wdown", "bdown")
_PRE = slice(0, 4)     # ln1 + qkv
_WO = slice(4, 6)      # output projection
_POST = slice(6, None)  # ln2 + MLP

_TODO = {
    "dropout": "(ROADMAP Queue 1, M2: dropout)",
    "ltd": "(ROADMAP Queue 1, M14: random-LTD)",
    "seq_moe": "(ROADMAP Queue 1, M12: MoE under sequence parallelism)",
}


def _unported_knobs(cfg):
    out = []
    if cfg.dropout > 0:
        out.append(("dropout > 0", _TODO["dropout"]))
    return out


_ACTS = {"gelu": lambda u: F.gelu(u, approximate="tanh"), "relu": F.relu}


class GPT2(QuantizedBlocks, nn.Module):
    """GPT-2 for training and serving. ``device`` defaults to the card
    (raises without one); ``dtype`` defaults to ``config.dtype``; weights
    are random from a ``torch.Generator`` seeded with ``seed`` (load real
    or converted weights with ``load_state_dict``). ``loss(batch)`` is the
    JAX ``loss`` over the module's own parameters; a weight-quantized model
    (``quantize_``, or quantized leaves loaded) serves only."""

    block_keys = BLOCK_KEYS    # per-layer parameters, in _block's order
    moe_loss_coeff = 0.0       # overridden by GPT2MoE
    # the top-level leaves of the JAX tree (besides ``blocks``)
    TOP_KEYS = ("wte", "wpe", "lnf_scale", "lnf_bias")
    # FFN keys the fused path keeps quantized (engine weight_quant)
    _WQ_KEEP = ("wup", "wdown")
    # the fused q / k / v columns, split per head by a tensor-parallel
    # rank (inference/utils.shard_model)
    _FUSED_SECTIONS = {"wqkv": 3, "bqkv": 3}

    def __init__(self, config: GPT2Config, device=None, dtype=None, seed=0):
        super().__init__()
        bad = _unported_knobs(config)
        if bad:
            raise NotImplementedError(
                "GPT2 port does not carry "
                + ", ".join(f"{what} {item}" for what, item in bad))
        if config.activation not in _ACTS:
            raise ValueError(f"unknown activation {config.activation!r}; "
                             f"expected one of {sorted(_ACTS)}")
        if config.attn_layer_windows and \
                len(config.attn_layer_windows) != config.n_layer:
            raise ValueError(
                f"attn_layer_windows has {len(config.attn_layer_windows)} "
                f"entries for {config.n_layer} layers")
        if config.remat:
            resolve_remat_policy(config.remat_policy)
        self.config = config
        # serving attention: "auto" = the winner cache's choice per shape
        # bucket (the kernels on a cold cache), True = the paged kernels,
        # False = the dense-gather parity path; paged_block_c: the chunk
        # kernel's query tile; the engine sets both
        self.paged_kernel = "auto"
        self.paged_block_c = "auto"
        self.qblocks = {}
        self.weight_quant = None
        dev = resolve_device(device)
        dt = dtype if dtype is not None else getattr(torch, config.dtype)
        L, D, Fd, V, T = (config.n_layer, config.d_model, config.d_ff,
                          config.vocab_size, config.max_seq_len)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        std = 0.02
        res_std = std / math.sqrt(2 * L)

        def nrm(shape, s=std):
            out = torch.empty(shape, dtype=dt, device=dev)
            for i in range(shape[0]):
                out[i].copy_(torch.randn(shape[1:], generator=gen,
                                         device=dev) * s)
            return nn.Parameter(out)

        def const(shape, value):
            return nn.Parameter(torch.full(shape, value, dtype=dt,
                                           device=dev))

        self.wte = nrm((V, D))
        self.wpe = nrm((T, D))
        self.lnf_scale = const((D,), 1.0)
        self.lnf_bias = const((D,), 0.0)
        self.blocks = nn.ParameterDict({
            "ln1_scale": const((L, D), 1.0),
            "ln1_bias": const((L, D), 0.0),
            "wqkv": nrm((L, D, 3 * D)),
            "bqkv": const((L, 3 * D), 0.0),
            "wo": nrm((L, D, D), res_std),
            "bo": const((L, D), 0.0),
            "ln2_scale": const((L, D), 1.0),
            "ln2_bias": const((L, D), 0.0),
        })
        self._init_mlp(nrm, const, res_std, gen)

    def _init_mlp(self, nrm, const, res_std, gen):
        """Add the per-layer MLP parameters to ``self.blocks``."""
        L, D, Fd = self.config.n_layer, self.config.d_model, self.config.d_ff
        self.blocks.update({
            "wup": nrm((L, D, Fd)),
            "bup": const((L, Fd), 0.0),
            "wdown": nrm((L, Fd, D), res_std),
            "bdown": const((L, D), 0.0),
        })

    def _check_serving_topology(self, topology):
        """A tensor-parallel rank holds whole heads of q, k and v."""
        tp = topology.axis_size("tensor")
        if self.config.n_head % tp:
            raise ValueError(
                f"n_head={self.config.n_head} does not divide over "
                f"tensor_parallel={tp}: a rank holds whole heads")

    def partition_specs(self, topology=None):
        """The JAX model's tensor-parallel specs (gpt2.py:251-275) by
        parameter name: "tensor" on the column-parallel out dims (wqkv,
        wup and their biases) and the row-parallel in dims (wo, wdown).
        The port runs no tensor axis; ZeRO's plan reads these so it leaves
        the same dims whole as JAX (runtime/zero/partitioning.py)."""
        col, row = (None, None, "tensor"), (None, "tensor", None)
        vec, vec_t = (None, None), (None, "tensor")
        blocks = {"ln1_scale": vec, "ln1_bias": vec, "wqkv": col,
                  "bqkv": vec_t, "wo": row, "bo": vec, "ln2_scale": vec,
                  "ln2_bias": vec, "wup": col, "bup": vec_t, "wdown": row,
                  "bdown": vec}
        return {"wte": (), "wpe": (), "lnf_scale": (), "lnf_bias": (),
                **{f"blocks.{k}": v for k, v in blocks.items()}}

    @property
    def dtype(self):
        return self.wte.dtype

    @property
    def device(self):
        return self.wte.device

    @property
    def flash_on(self):
        """Resolved use_flash_attention ("auto": on for a CUDA model)."""
        return resolve_flash(self.config.use_flash_attention, self.device)

    def flash_qmajor_for(self, T, dtype=None, device=None):
        """Whether the flash backward at sequence length T is the query-major
        kernel: ``flash_bwd_qmajor`` resolved for the flash bucket (T,
        d_head, causal, ``flash_qkv_t``) ("auto": the winner cache's choice,
        False on a miss) on the ``flash_qkv_t`` layout, as gpt2.py:591-596
        passes it."""
        cfg = self.config
        return cfg.flash_qkv_t and resolve_bwd_qmajor(
            cfg.flash_bwd_qmajor, T, cfg.d_head, True, True,
            dtype or self.dtype, device or self.device)

    @property
    def flash_qmajor(self):
        """``flash_qmajor_for`` at ``max_seq_len``."""
        return self.flash_qmajor_for(self.config.max_seq_len)

    # --------------------------------------------------------------- pieces
    def embed(self, ids, offset=0):
        """Token + position embedding (B, T) -> (B, T, D); the positions
        start at ``offset`` (a sequence block's place in the sequence)."""
        T = ids.shape[1]
        x = F.embedding(ids.long(), self.wte) + self.wpe[offset:offset + T]
        return x.to(self.dtype)

    def _ln(self, x, scale, bias):
        """LayerNorm dispatch (gpt2.py:451-483): "bwd" = the plain forward
        + the K13 backward kernel; True = the K13 forward and backward
        kernels; False = plain; "auto" = the winner cache's variant for this
        (rows, D) bucket (op ``layernorm``; the plain form on a miss, and
        always where D % 128 != 0, which K13 does not tile)."""
        use = self.config.fused_layernorm
        if use == "auto":
            from ..autotuning.kernel_registry import LN_DEFAULTS
            win = dispatch("layernorm",
                           ln_bucket(math.prod(x.shape[:-1]), x.shape[-1]),
                           dtype_name(x.dtype), LN_DEFAULTS, device=x.device)
            variant = win["variant"] if x.shape[-1] % 128 == 0 else "plain"
            use = {"plain": False, "fused": True, "bwd": "bwd"}[variant]
        if use == "bwd":
            return layernorm_fused_bwd(x, scale, bias)
        if use:
            return fused_layernorm(x, scale, bias)
        return layernorm(x, scale, bias)

    def head(self, x):
        """Final LN + tied-embedding unembed: (B, T, D) -> fp32 logits."""
        return self._head([self.wte, self.lnf_scale, self.lnf_bias], x)

    def _head(self, ps, x):
        wte, scale, bias = ps
        h = self._ln(x, scale, bias)
        lead = h.shape[:-1]
        return mm_f32(h.reshape(-1, h.shape[-1]), wte.t()).reshape(
            *lead, wte.shape[0])

    def _qkv(self, x, ln1_scale, ln1_bias, wqkv, bqkv):
        """ln1 + qkv projection: (B, T, D) -> q, k, v each (B, T, H, hd)
        (views of one projection)."""
        cfg = self.config
        B, T = x.shape[0], x.shape[1]
        h = self._ln(x, ln1_scale, ln1_bias)
        qkv = h @ wqkv + bqkv
        # this rank's heads of q, k and v (all of them but under tensor
        # parallelism, where wqkv holds H / tp heads of each)
        return qkv.view(B, T, 3, -1, cfg.d_head).unbind(2)

    def _window(self, i):
        """Layer ``i``'s attention window: None without
        ``attn_layer_windows``, else its entry (0 = global)."""
        ws = self.config.attn_layer_windows
        return ws[i] if ws else None

    def _attn(self, q, k, v, seq_sharded=False, window=None):
        """Attention dispatch: (B, T, H, hd) x3 -> (B, T, H, hd); with
        ``seq_sharded`` T is this rank's block: the zigzag ring for
        ``attention_backend="ring"``, else Ulysses around the dense
        attention (gpt2.py:557-617). A layer ``window`` (not None: the
        model has per-layer windows) takes the dense path with the window
        in its mask, as JAX forces it (gpt2.py:674)."""
        cfg = self.config
        if seq_sharded and cfg.attention_backend == "ring":
            if window is not None or not cfg.scale_attn:
                raise ValueError(
                    "ring attention supports neither per-layer local "
                    "windows nor unscaled (gpt-neo) scores")
            scfg = getattr(self, "_sequence_cfg", None) or SequenceConfig()
            return ring_attention(
                q, k, v, "seq", causal=True, layout=scfg.layout,
                block_kernel=scfg.block_kernel,
                double_buffer=scfg.double_buffer,
                rotate_chunks=scfg.rotate_chunks).to(self.dtype)
        if seq_sharded:
            return DistributedAttention(self._dense_attn, "seq")(
                q, k, v, window=window)
        if window is not None:
            return self._dense_attn(q, k, v, window=window)
        if self.flash_on:
            kw = dict(causal=True, scale=None if cfg.scale_attn else 1.0,
                      block_q=cfg.flash_block_q, block_k=cfg.flash_block_k,
                      block_h=cfg.flash_block_h,
                      bwd_qmajor=cfg.flash_bwd_qmajor)
            if cfg.flash_qkv_t:
                # (B, H, hd, T) views, as the JAX model feeds the kernel;
                # o comes back (B, H, T, hd)
                q, k, v = (t.permute(0, 2, 3, 1) for t in (q, k, v))
                o = flash_attention(q, k, v, qkv_t=True, **kw)
                return o.transpose(1, 2).to(self.dtype)
            return flash_attention(q, k, v, **kw).to(self.dtype)
        return self._dense_attn(q, k, v)

    def _dense_attn(self, q, k, v, window=None):
        """Dense causal attention, fp32 scores: (B, T, H, hd) x3 ->
        (B, T, H, hd); a ``window`` w > 0 keeps the keys with q - k < w
        (gpt2.py:553-556)."""
        cfg = self.config
        T = q.shape[1]
        s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
        if cfg.scale_attn:
            s = s / math.sqrt(cfg.d_head)
        causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        if window:
            i = torch.arange(T, device=q.device)
            causal = causal & (i[:, None] - i[None, :] < window)
        s = torch.where(causal, s, -1e30)
        probs = torch.softmax(s, dim=-1).to(self.dtype)
        return torch.einsum("bhts,bshd->bthd", probs, v)

    def _mlp_kernel_mode(self):
        """Resolved ``mlp_kernel``: None (plain products) | "down" | "both" |
        "auto" (the winner cache, consulted in ``_mlp`` where the bucket's
        shape is known). True means "down"."""
        v = self.config.mlp_kernel
        if not v:
            return None
        return "down" if v is True else v

    def _mlp(self, x, ln2_scale, ln2_bias, wup, bup, wdown, bdown, *,
             seq_sharded=False, rng=None, train=False):
        """ln2 + MLP: (B, T, D) -> ((B, T, D), aux); a dense MLP has no
        aux (None) and draws no noise (``rng`` / ``train`` reach an MoE
        MLP, ``gpt2_moe.GPT2MoE``). Quantized FFN weights (the engine's
        ``weight_quant``) go through K7, ``wq_matmul`` (gpt2.py:712-719).
        With ``mlp_kernel`` the pre-activation is carried (B, F, T), as
        gpt2.py:755-769: the up product through K6 emitting (B, F, T) in
        "both" (else a plain einsum to that layout), the down product
        through K6 reading it with ``x_t``."""
        act = _ACTS[self.config.activation]
        h = self._ln(x, ln2_scale, ln2_bias)
        if is_quantized(wup):
            up = act(wq_matmul(h, wup) + bup)
            return self._tp_sum(wq_matmul(up, wdown)) + bdown, None
        mode = None if seq_sharded else self._mlp_kernel_mode()
        fuse = self.config.mlp_kernel_fuse_dw
        if mode == "auto":
            # the winner for this (tokens, D, F) bucket picks the path and
            # its dW epilogue (gpt2.py:744-758); a miss: the plain products
            from ..autotuning.kernel_registry import MLP_DEFAULTS
            win = dispatch("mlp_matmul", mlp_bucket(h.shape[1], *wup.shape),
                           dtype_name(h.dtype),
                           {**MLP_DEFAULTS, "fuse_dw": fuse}, device=h.device)
            mode = None if win["mode"] == "plain" else win["mode"]
            fuse = bool(win["fuse_dw"])
        if mode:
            if mode == "both":
                u = mlp_matmul(h, wup, out_t=True, fuse_dw=fuse)
            else:
                u = torch.einsum("btd,df->bft", h, wup)
            up = act(u + bup[None, :, None])
            return self._tp_sum(mlp_matmul(up, wdown, x_t=True,
                                           fuse_dw=fuse)) + bdown, None
        up = act(h @ wup + bup)
        return self._tp_sum(up @ wdown) + bdown, None

    def _block_core(self, x, layer, attend, **mlp_kw):
        """ln1 -> qkv -> ``attend`` -> output projection residual -> ln2
        -> MLP residual (gpt2.py:805-826): ``attend((B, T, H, hd) q, k, v)
        -> (B, T, H, hd)`` owns masking and any cache reads and writes.
        Returns ((B, T, D), aux)."""
        B, T = x.shape[:2]
        q, k, v = self._qkv(x, *layer[_PRE])
        wo, bo = layer[_WO]
        mid = x + self._tp_sum(attend(q, k, v).reshape(B, T, -1) @ wo) + bo
        out, aux = self._mlp(mid, *layer[_POST], **mlp_kw)
        return mid + out, aux

    def _block(self, x, *layer, seq_sharded=False, window=None, rng=None,
               train=False):
        """One transformer block: (B, T, D) -> ((B, T, D), aux); ``rng``:
        this layer's key words, ``train`` the MLP's mode."""
        return self._block_core(
            x, layer,
            lambda q, k, v: self._attn(q, k, v, seq_sharded, window),
            seq_sharded=seq_sharded, rng=rng, train=train)

    def _requires_train_rng(self):
        """True when a training forward is stochastic (gpt2.py:685;
        GPT2MoE's noisy gating or top-2 sampling)."""
        return self.config.dropout > 0

    def hidden_with_aux(self, ids, offset=0, seq_sharded=False, rng=None,
                        train=False):
        """Embedding + blocks: (B, T) -> ((B, T, D) before the final LN,
        the aux summed over layers or None); positions start at
        ``offset``. ``rng``: threefry key words (numpy uint32 (2,), the
        engine's micro-step key), split into one key a layer as
        gpt2.py:413-414 does; ``train=True`` without it raises for a
        model whose training forward draws noise (gpt2.py:489-495)."""
        cfg = self.config
        if self.qblocks:
            raise NotImplementedError(
                f"a {self.weight_quant} weight-quantized model serves only")
        if train and rng is None and self._requires_train_rng():
            raise ValueError(
                "train=True requires rng= (model uses stochastic "
                "dropout/routing)")
        keys = (prng.split(rng, cfg.n_layer) if rng is not None
                else [None] * cfg.n_layer)
        x = self.embed(ids, offset)
        layers = [self.get_parameter(f"blocks.{k}").unbind(0)
                  for k in self.block_keys]
        policy = resolve_remat_policy(cfg.remat_policy) if cfg.remat \
            else None
        total = None
        for i in range(cfg.n_layer):
            layer = [t[i] for t in layers]
            window = self._window(i)
            block = functools.partial(self._block, seq_sharded=seq_sharded,
                                      window=window, rng=keys[i], train=train)
            if (policy == "save_flash" and self.flash_on
                    and not seq_sharded and window is None):
                x, aux = _SaveFlashBlock.apply(
                    self, x, {"rng": keys[i], "train": train}, *layer)
            elif policy is not None:
                x, aux = checkpoint(block, x, *layer, use_reentrant=False)
            else:
                x, aux = block(x, *layer)
            if aux is not None:
                total = aux if total is None else total + aux
        return x, total

    def hidden(self, ids):
        """Embedding + blocks: (B, T) -> (B, T, D) (no final LN)."""
        return self.hidden_with_aux(ids)[0]

    def logits(self, ids):
        """Logits (B, T, V) fp32 (the JAX ``apply``)."""
        return self.head(self.hidden(ids))

    # ------------------------------------------------------------------ loss
    def loss(self, batch, *, rng=None, train=True, seq_sharded=False,
             ltd_keep=None):
        """Next-token cross entropy. batch: {"input_ids": (B, T) int};
        ``rng`` / ``train`` as for ``hidden_with_aux``; ``seq_sharded``:
        the global batch on every rank of the ``seq`` group, this rank
        computing its sequence block (module docstring)."""
        if ltd_keep is not None:
            raise NotImplementedError(f"ltd_keep {_TODO['ltd']}")
        ids = batch["input_ids"]
        if not torch.is_tensor(ids):
            ids = torch.as_tensor(ids)
        ids = ids.to(self.device)
        if seq_sharded:
            return self._seq_sharded_loss(ids)
        cfg = self.config
        T = ids.shape[1]
        chunk = cfg.loss_chunk
        x, aux = self.hidden_with_aux(ids, rng=rng, train=train)
        if chunk and T - 1 > chunk:
            loss = self._chunked_head_loss(x[:, :-1], ids[:, 1:], chunk)
        else:
            loss = next_token_xent(self.head(x), ids)
        return loss if aux is None else loss + self.moe_loss_coeff * aux

    def _seq_sharded_loss(self, ids):
        """This rank's block of the global next-token CE over the ``seq``
        group, full logits (gpt2.py:1247 takes no chunked head when
        seq-sharded): the block's summed CE over B * (T - 1), summed over
        the group in the forward (the backward passes each rank its own
        share)."""
        if self.block_keys != BLOCK_KEYS:
            raise NotImplementedError(
                f"seq_sharded {type(self).__name__} {_TODO['seq_moe']}")
        topo = groups.get_topology()
        R, r = topo.axis_size("seq"), topo.axis_index("seq")
        B, T = ids.shape
        if T % R:
            raise ValueError(f"sequence length {T} does not split over "
                             f"{R} seq ranks")
        off = r * (T // R)
        x, _ = self.hidden_with_aux(ids[:, off:off + T // R], offset=off,
                                    seq_sharded=True)
        targets = ids[:, off + 1:off + T // R + 1].long()
        logits = self.head(x[:, :targets.shape[1]])
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        return _SumOverAxis.apply((logz - gold).sum() / (B * (T - 1)),
                                  "seq")

    def _chunked_head_loss(self, hidden, targets, chunk):
        """The big-vocab head: fused grad-in-forward CE when
        cfg.fused_loss (over the fused CE kernel with
        cfg.fused_loss_kernel), else the recomputed chunked path."""
        cfg = self.config
        if cfg.fused_loss and cfg.fused_loss_kernel:
            return fused_linear_xent_kernel(
                lambda ps, x: self._ln(x, ps[0], ps[1]), chunk,
                {"lnf_scale": self.lnf_scale, "lnf_bias": self.lnf_bias},
                self.wte, hidden, targets)
        if cfg.fused_loss:
            return fused_linear_xent(
                self._head, chunk,
                {"wte": self.wte, "lnf_scale": self.lnf_scale,
                 "lnf_bias": self.lnf_bias}, hidden, targets)
        return chunked_softmax_xent(self.head, hidden, targets, chunk)

    # --------------------------------------------------------- paged cache
    def init_paged_cache(self, num_blocks, block_size, dtype=None):
        """LISTS of per-layer heads-major pools (NB, H, BS, hd), one K and
        one V a layer (gpt2.py:910-923); the paged programs update them in
        place. Block 0 is the scratch block. A tensor-parallel rank's pools
        hold its H / tp heads."""
        cfg = self.config
        dt = dtype if dtype is not None else self.dtype
        shape = (num_blocks, cfg.n_head // self._tp, block_size, cfg.d_head)
        return {"k": [torch.zeros(shape, dtype=dt, device=self.device)
                      for _ in range(cfg.n_layer)],
                "v": [torch.zeros(shape, dtype=dt, device=self.device)
                      for _ in range(cfg.n_layer)]}

    def _layer(self, i):
        """Layer ``i``'s tensors in ``block_keys`` order, each through
        ``_w`` (gpt2.py:935-943)."""
        return [self._w(k, i) for k in self.block_keys]

    def _embed_at(self, ids, pos):
        """Token + learned position embedding at ``pos`` (broadcast with
        ``ids``), each position clamped to the table's last row as the
        serving programs clamp it (gpt2.py:1032, :1094, :1170)."""
        pos = pos.clamp(max=self.config.max_seq_len - 1).long()
        return (F.embedding(ids.long(), self.wte)
                + F.embedding(pos, self.wpe)).to(self.dtype)

    def _paged_kw(self, i):
        """The paged kernels' scale (1.0 for unscaled scores) and layer
        ``i``'s window (0 = global)."""
        return dict(scale=None if self.config.scale_attn else 1.0,
                    window=self._window(i) or 0)

    def _chunk_attend(self, C, MB, BS, dtype, device):
        """Prefill / chunk / verify attention of a C-token chunk over
        MB-block tables: K5 with the levers ``resolve_paged_chunk_levers``
        gives this bucket, or its plain version (the dense-gather path)
        where ``paged_kernel`` resolves off."""
        cfg = self.config
        use, bc, splits = resolve_paged_chunk_levers(
            self.paged_kernel, self.paged_block_c, C, MB, BS,
            cfg.n_head // self._tp, 1, cfg.d_head, dtype, device)
        if not use:
            return paged_chunk_attention_reference
        return functools.partial(paged_chunk_attention, block_c=bc,
                                 splits=splits)

    @torch.inference_mode()
    def apply_paged_prefill(self, input_ids, cache, token_blocks,
                            token_offsets, length):
        """Bucketed whole-prompt prefill of ONE sequence (gpt2.py:945).

        input_ids: (1, T) right-padded prompt; token_blocks/token_offsets:
        (T,) destination block/slot per position (pads -> scratch block
        0); length: real prompt length. K5 runs with start 0 over the
        prompt's own blocks (``token_blocks[::BS]``). Returns (logits (1,
        V) fp32 at position length-1, cache)."""
        T = input_ids.shape[1]
        length = int(length)
        x = self._embed_at(input_ids,
                           torch.arange(T, device=input_ids.device)[None])
        BS = cache["k"][0].shape[2]
        table = token_blocks[::BS].to(torch.int32).contiguous()
        attend = self._chunk_attend(T, table.shape[0], BS,
                                    cache["k"][0].dtype, x.device)
        for i in range(self.config.n_layer):
            kc, vc = cache["k"][i], cache["v"][i]

            def fn(q, k, v, kc=kc, vc=vc, kw=self._paged_kw(i)):
                scatter_kv(kc, token_blocks, token_offsets, k[0])
                scatter_kv(vc, token_blocks, token_offsets, v[0])
                return attend(q[0].contiguous(), kc, vc, table, 0, length,
                              **kw)
            x, _ = self._block_core(x, self._layer(i), fn)
        return self.head(x[:, max(length - 1, 0)]), cache

    @torch.inference_mode()
    def apply_paged_chunk(self, input_ids, cache, token_blocks,
                          token_offsets, start, true_len, table):
        """Prefill ONE CHUNK of one sequence into the paged cache (Dynamic
        SplitFuse, gpt2.py:1016): input_ids (1, C) right-padded; token_
        blocks/token_offsets (C,) destinations (pads -> scratch 0); start:
        the chunk's first position; true_len: its real tokens; table:
        (MB,) the sequence's block table. Returns (logits (1, V) fp32 at
        chunk position true_len-1, cache)."""
        C = input_ids.shape[1]
        start, true_len = int(start), int(true_len)
        x = self._embed_at(
            input_ids, start + torch.arange(C, device=input_ids.device)[None])
        table = table.to(torch.int32).contiguous()
        attend = self._chunk_attend(C, table.shape[0], cache["k"][0].shape[2],
                                    cache["k"][0].dtype, x.device)
        for i in range(self.config.n_layer):
            kc, vc = cache["k"][i], cache["v"][i]

            def fn(q, k, v, kc=kc, vc=vc, kw=self._paged_kw(i)):
                scatter_kv(kc, token_blocks, token_offsets, k[0])
                scatter_kv(vc, token_blocks, token_offsets, v[0])
                return attend(q[0].contiguous(), kc, vc, table, start,
                              true_len, **kw)
            x, _ = self._block_core(x, self._layer(i), fn)
        return self.head(x[:, max(true_len - 1, 0)]), cache

    @torch.inference_mode()
    def apply_paged_decode(self, tokens, lengths, cache, block_tables):
        """One decode step for every batch slot (gpt2.py:1081), through K4.

        tokens: (B,) input token per slot; lengths: (B,) = its position
        (tokens already in the cache); block_tables: (B, MB) int32. A write
        position past the table goes to scratch block 0 (the JAX scatter
        drops it). Returns (logits (B, V) fp32, cache)."""
        BS = cache["k"][0].shape[2]
        MB = block_tables.shape[1]
        lengths = lengths.to(torch.int32).contiguous()
        block_tables = block_tables.to(torch.int32).contiguous()
        x = self._embed_at(tokens[:, None], lengths[:, None])
        blk = (lengths // BS).long()
        dst_block = torch.where(
            blk < MB, block_tables.gather(1, blk.clamp(max=MB - 1)[:, None])
            [:, 0], 0)
        dst_off = lengths % BS
        cfg = self.config
        use, sp = resolve_paged_decode_levers(
            self.paged_kernel, lengths.shape[0], MB, BS,
            cfg.n_head // self._tp, 1, cfg.d_head, cache["k"][0].dtype,
            x.device)
        attend = (functools.partial(paged_decode_attention,
                                    split_positions=sp) if use
                  else paged_decode_attention_reference)
        for i in range(self.config.n_layer):
            kc, vc = cache["k"][i], cache["v"][i]

            def fn(q, k, v, kc=kc, vc=vc, kw=self._paged_kw(i)):
                scatter_kv(kc, dst_block, dst_off, k[:, 0])
                scatter_kv(vc, dst_block, dst_off, v[:, 0])
                return attend(q[:, 0].contiguous(), kc, vc, block_tables,
                              lengths, **kw)
            x, _ = self._block_core(x, self._layer(i), fn)
        return self.head(x)[:, 0], cache

    @torch.inference_mode()
    def apply_paged_verify(self, tokens, lengths, cache, block_tables):
        """Speculative verify: C tokens a slot in ONE pass (gpt2.py:1139).

        tokens: (B, C) per slot, the last committed token then the draft's
        proposals; lengths: (B,) HOST ints = each slot's first input
        position; block_tables: (B, MB) int32. The K/V of all B x C tokens
        are scattered first (a position past the table lands in its last
        block, as JAX clamps it), then each slot's C queries attend its
        cache through K5 with start = lengths[b], true_len = C: one launch
        a slot and layer. Returns (logits (B, C, V) fp32, cache)."""
        B, C = tokens.shape
        cfg = self.config
        BS = cache["k"][0].shape[2]
        MB = block_tables.shape[1]
        starts = [int(n) for n in np.asarray(lengths).reshape(-1)]
        dev = tokens.device
        block_tables = block_tables.to(torch.int32).contiguous()
        linpos = (torch.as_tensor(starts, device=dev)[:, None]
                  + torch.arange(C, device=dev)[None, :])        # (B, C)
        x = self._embed_at(tokens, linpos)
        fb = block_tables.gather(1, (linpos // BS).clamp(max=MB - 1)) \
            .reshape(-1)
        fo = (linpos % BS).reshape(-1)
        attend = self._chunk_attend(C, MB, BS, cache["k"][0].dtype, dev)
        hd = cfg.d_head
        for i in range(cfg.n_layer):
            kc, vc = cache["k"][i], cache["v"][i]

            def fn(q, k, v, kc=kc, vc=vc, kw=self._paged_kw(i)):
                scatter_kv(kc, fb, fo, k.reshape(B * C, -1, hd))
                scatter_kv(vc, fb, fo, v.reshape(B * C, -1, hd))
                return torch.stack([
                    attend(q[b].contiguous(), kc, vc, block_tables[b],
                           starts[b], C, **kw) for b in range(B)])
            x, _ = self._block_core(x, self._layer(i), fn)
        return self.head(x), cache


class _SumOverAxis(torch.autograd.Function):
    """Sum over the ranks of an axis in the forward; the backward passes
    the cotangent through (each rank's share of a summed loss)."""

    @staticmethod
    def forward(ctx, x, axis_name):
        return comm.all_reduce(x, axis_name)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SaveFlashBlock(torch.autograd.Function):
    """One block under the save_flash policy: keeps the block input, the
    post-attention residual ``mid`` and the flash o/lse; backward recomputes
    ln1 + qkv and ln2 + MLP and runs the fused flash backward (query-major
    when ``model.flash_qmajor``) on the saved o/lse — the flash forward
    never runs again. Returns (out, aux) as
    ``_block`` does; ``mlp_kw`` (the layer's key words and the mode) reach
    the MLP in both passes, so an MoE MLP's recomputed routing, noise
    included, equals the forward's."""

    @staticmethod
    def forward(ctx, model, x, mlp_kw, *layer):
        cfg = model.config
        B, T, D = x.shape
        scale = 1.0 / math.sqrt(cfg.d_head) if cfg.scale_attn else 1.0
        q, k, v = (t.transpose(1, 2) for t in model._qkv(x, *layer[_PRE]))
        o, lse = flash_forward(scale_q(q, scale), k, v, causal=True)
        o = o.transpose(1, 2).to(x.dtype)            # (B, T, H, hd)
        wo, bo = layer[_WO]
        mid = x + o.reshape(B, T, D) @ wo + bo
        out, aux = model._mlp(mid, *layer[_POST], **mlp_kw)
        ctx.model, ctx.scale, ctx.mlp_kw = model, scale, mlp_kw
        ctx.save_for_backward(x, mid, o, lse, *layer)
        return mid + out, aux

    @staticmethod
    def backward(ctx, g, g_aux):
        model, scale = ctx.model, ctx.scale
        x, mid, o, lse, *layer = ctx.saved_tensors
        B, T, D = x.shape
        with torch.enable_grad():
            mid_ = mid.detach().requires_grad_()
            post = [p.detach().requires_grad_() for p in layer[_POST]]
            out, aux = model._mlp(mid_, *post, **ctx.mlp_kw)
            outs, grads = [mid_ + out], [g]
            if aux is not None and g_aux is not None:
                outs.append(aux)
                grads.append(g_aux)
            g_mid, *d_post = torch.autograd.grad(outs, [mid_] + post, grads)
        wo, _ = layer[_WO]
        g2 = g_mid.reshape(-1, D)
        d_wo = o.reshape(-1, D).t() @ g2
        d_bo = g2.sum(0)
        d_o = (g2 @ wo.t()).view_as(o)
        with torch.enable_grad():
            x_ = x.detach().requires_grad_()
            pre = [p.detach().requires_grad_() for p in layer[_PRE]]
            q, k, v = (t.transpose(1, 2) for t in model._qkv(x_, *pre))
            qs = scale_q(q, scale)
            bwd = (flash_backward_qmajor
                   if model.flash_qmajor_for(T, qs.dtype, qs.device)
                   else flash_backward)
            dqs, dk, dv = bwd(
                qs.detach(), k.detach(), v.detach(), o.transpose(1, 2), lse,
                d_o.transpose(1, 2), causal=True)
            d_x, *d_pre = torch.autograd.grad([qs, k, v], [x_] + pre,
                                              [dqs, dk, dv])
        return (None, d_x + g_mid, None, *d_pre, d_wo,
                d_bo.to(layer[5].dtype), *d_post)
