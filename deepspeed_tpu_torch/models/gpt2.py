"""GPT-2 model family for training.

Counterpart of ``deepspeed_tpu/models/gpt2.py`` (training surface: the
config and presets, ``embed``, ``head``, the blocks, the dense MLP and
``loss`` with its chunked and fused cross-entropy heads). Parameter names
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

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.cuda.flash_attention import (flash_attention, flash_backward,
                                        flash_backward_qmajor, flash_forward,
                                        resolve_bwd_qmajor, scale_q)
from ..ops.cuda.layernorm import (fused_layernorm, layernorm_fused_bwd,
                                  layernorm_reference as layernorm)
from ..ops.cuda.mlp_matmul import mlp_matmul
from ..comm import comm
from ..runtime.config import SequenceConfig
from ..sequence.layer import DistributedAttention
from ..sequence.ring import ring_attention
from ..utils import groups
from ..utils.device import resolve_device
from .common import (chunked_softmax_xent, fused_linear_xent,
                     fused_linear_xent_kernel, mm_f32, next_token_xent,
                     resolve_flash, resolve_remat_policy)


@dataclass(frozen=True)
class GPT2Config:
    """Every field of the JAX ``GPT2Config`` (gpt2.py:42-150); the ones this
    port does not carry raise in ``GPT2`` (see ``_unsupported``). The flash
    tile knobs are accepted and change nothing."""
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
    "attn_layer_windows": "(ROADMAP Queue 1, M2: per-layer windows)",
    "ltd": "(ROADMAP Queue 1, M14: random-LTD)",
    "seq_moe": "(ROADMAP Queue 1, M12: MoE under sequence parallelism)",
}


def _unsupported(cfg):
    out = []
    if cfg.dropout > 0:
        out.append(("dropout > 0", _TODO["dropout"]))
    if cfg.attn_layer_windows:
        out.append(("attn_layer_windows", _TODO["attn_layer_windows"]))
    return out


_ACTS = {"gelu": lambda u: F.gelu(u, approximate="tanh"), "relu": F.relu}


class GPT2(nn.Module):
    """Training-side GPT-2. ``device`` defaults to the card (raises without
    one); ``dtype`` defaults to ``config.dtype``; weights are random from a
    ``torch.Generator`` seeded with ``seed`` (load real or converted weights
    with ``load_state_dict``). ``loss(batch)`` is the JAX ``loss`` over the
    module's own parameters."""

    block_keys = BLOCK_KEYS    # per-layer parameters, in _block's order
    moe_loss_coeff = 0.0       # overridden by GPT2MoE

    def __init__(self, config: GPT2Config, device=None, dtype=None, seed=0):
        super().__init__()
        bad = _unsupported(config)
        if bad:
            raise NotImplementedError(
                "GPT2 port does not carry "
                + ", ".join(f"{what} {item}" for what, item in bad))
        if config.activation not in _ACTS:
            raise ValueError(f"unknown activation {config.activation!r}; "
                             f"expected one of {sorted(_ACTS)}")
        if config.remat:
            resolve_remat_policy(config.remat_policy)
        self.config = config
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

    def partition_specs(self):
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

    @property
    def flash_qmajor(self):
        """Whether the flash backward is the query-major kernel: resolved
        ``flash_bwd_qmajor`` ("auto": False, the JAX choice on a winner-cache
        miss) on the ``flash_qkv_t`` layout, as gpt2.py:591-596 passes it."""
        return (resolve_bwd_qmajor(self.config.flash_bwd_qmajor)
                and self.config.flash_qkv_t)

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
        kernels; False = plain; "auto" = plain: the JAX package resolves it
        through its autotune winner cache and takes the plain form on a
        miss, and the port has no winner cache yet."""
        use = self.config.fused_layernorm
        if use == "bwd":
            return layernorm_fused_bwd(x, scale, bias)
        if use and use != "auto":
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
        return qkv.view(B, T, 3, cfg.n_head, cfg.d_head).unbind(2)

    def _attn(self, q, k, v, seq_sharded=False):
        """Attention dispatch: (B, T, H, hd) x3 -> (B, T, H, hd); with
        ``seq_sharded`` T is this rank's block: the zigzag ring for
        ``attention_backend="ring"``, else Ulysses around the dense
        attention (gpt2.py:557-617)."""
        cfg = self.config
        if seq_sharded and cfg.attention_backend == "ring":
            if not cfg.scale_attn:
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
            return DistributedAttention(self._dense_attn, "seq")(q, k, v)
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

    def _dense_attn(self, q, k, v):
        """Dense causal attention, fp32 scores: (B, T, H, hd) x3 ->
        (B, T, H, hd)."""
        cfg = self.config
        T = q.shape[1]
        s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
        if cfg.scale_attn:
            s = s / math.sqrt(cfg.d_head)
        causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = torch.where(causal, s, -1e30)
        probs = torch.softmax(s, dim=-1).to(self.dtype)
        return torch.einsum("bhts,bshd->bthd", probs, v)

    def _mlp_kernel_mode(self):
        """Resolved ``mlp_kernel``: None (plain products) | "down" | "both".
        True means "down"; "auto" is the plain path, the JAX package's
        choice on an autotune winner-cache miss (the port has no winner
        cache yet)."""
        v = self.config.mlp_kernel
        if not v or v == "auto":
            return None
        return "down" if v is True else v

    def _mlp(self, x, ln2_scale, ln2_bias, wup, bup, wdown, bdown, *,
             seq_sharded=False):
        """ln2 + MLP: (B, T, D) -> ((B, T, D), aux); a dense MLP has no
        aux (None). With ``mlp_kernel`` the pre-activation is carried
        (B, F, T), as gpt2.py:755-769: the up product through K6 emitting
        (B, F, T) in "both" (else a plain einsum to that layout), the down
        product through K6 reading it with ``x_t``."""
        act = _ACTS[self.config.activation]
        h = self._ln(x, ln2_scale, ln2_bias)
        mode = None if seq_sharded else self._mlp_kernel_mode()
        if mode:
            fuse = self.config.mlp_kernel_fuse_dw
            if mode == "both":
                u = mlp_matmul(h, wup, out_t=True, fuse_dw=fuse)
            else:
                u = torch.einsum("btd,df->bft", h, wup)
            up = act(u + bup[None, :, None])
            return mlp_matmul(up, wdown, x_t=True, fuse_dw=fuse) + bdown, \
                None
        up = act(h @ wup + bup)
        return up @ wdown + bdown, None

    def _block(self, x, *layer, seq_sharded=False):
        """One transformer block: (B, T, D) -> ((B, T, D), aux)."""
        B, T, D = x.shape
        q, k, v = self._qkv(x, *layer[_PRE])
        attn = self._attn(q, k, v, seq_sharded)
        wo, bo = layer[_WO]
        mid = x + attn.reshape(B, T, D) @ wo + bo
        kw = {"seq_sharded": True} if seq_sharded else {}
        out, aux = self._mlp(mid, *layer[_POST], **kw)
        return mid + out, aux

    def hidden_with_aux(self, ids, offset=0, seq_sharded=False):
        """Embedding + blocks: (B, T) -> ((B, T, D) before the final LN,
        the aux summed over layers or None); positions start at
        ``offset``."""
        cfg = self.config
        x = self.embed(ids, offset)
        layers = [self.get_parameter(f"blocks.{k}").unbind(0)
                  for k in self.block_keys]
        policy = resolve_remat_policy(cfg.remat_policy) if cfg.remat \
            else None
        total = None
        for i in range(cfg.n_layer):
            layer = [t[i] for t in layers]
            block = functools.partial(self._block, seq_sharded=seq_sharded)
            if (policy == "save_flash" and self.flash_on
                    and not seq_sharded):
                x, aux = _SaveFlashBlock.apply(self, x, *layer)
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
        ``seq_sharded``: the global batch on every rank of the ``seq``
        group, this rank computing its sequence block (module
        docstring)."""
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
        x, aux = self.hidden_with_aux(ids)
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
    ``_block`` does; an MoE MLP's recomputed routing is deterministic, so it
    equals the forward's."""

    @staticmethod
    def forward(ctx, model, x, *layer):
        cfg = model.config
        B, T, D = x.shape
        scale = 1.0 / math.sqrt(cfg.d_head) if cfg.scale_attn else 1.0
        q, k, v = (t.transpose(1, 2) for t in model._qkv(x, *layer[_PRE]))
        o, lse = flash_forward(scale_q(q, scale), k, v, causal=True)
        o = o.transpose(1, 2).to(x.dtype)            # (B, T, H, hd)
        wo, bo = layer[_WO]
        mid = x + o.reshape(B, T, D) @ wo + bo
        out, aux = model._mlp(mid, *layer[_POST])
        ctx.model, ctx.scale = model, scale
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
            out, aux = model._mlp(mid_, *post)
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
            bwd = (flash_backward_qmajor if model.flash_qmajor
                   else flash_backward)
            dqs, dk, dv = bwd(
                qs.detach(), k.detach(), v.detach(), o.transpose(1, 2), lse,
                d_o.transpose(1, 2), causal=True)
            d_x, *d_pre = torch.autograd.grad([qs, k, v], [x_] + pre,
                                              [dqs, dk, dv])
        return (None, d_x + g_mid, *d_pre, d_wo, d_bo.to(layer[5].dtype),
                *d_post)
