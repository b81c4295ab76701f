"""Weight-only int8/int4 quantization for serving (ZeRO-Inference).

Counterpart of ``deepspeed_tpu/ops/int8_weights.py``. A quantized weight
of logical shape (..., In, Out) keeps int8 codes and one fp32 scale per
output channel, ``scale[..., 0, o] = absmax over In of column o / 127``
(``/ 7`` for int4, whose codes pack two per byte along the contracted
axis -2: byte r holds code 2r in its low nibble and code 2r+1 in its high
nibble, both sign-extended). ``Int8Weight`` / ``Int4Weight`` are plain
containers of the ``(q, scale)`` tensors; slicing a stacked (L, ...)
weight slices both together (``layer_slice``).

The serving engine's ``weight_quant`` keeps the FFN weights quantized
through the fused-dequant kernels (``ops/cuda/mlp_matmul.wq_matmul``,
``ops/cuda/grouped_matmul.grouped_swiglu_wq``); every other quantized
leaf is dequantized one layer at a time (``quantize_weights``, the
ZeRO-Inference capacity mode, dequantizes them all). Not ported:
``quantized_shardings`` (tensor parallel, ROADMAP Queue 1).
"""

import torch

EXCLUDE_KEYS = ("moe_gate",)
MIN_SIZE = 1 << 16


class Int8Weight:
    """int8 codes ``q`` (..., In, Out) and fp32 scales (..., 1, Out)."""

    bits = 8

    def __init__(self, q, scale):
        self.q = q
        self.scale = scale

    def codes(self):
        """The int8 codes, one per element (..., In, Out)."""
        return self.q

    def dequant(self, dtype):
        """The JAX ``(q.astype(f32) * scale).astype(dtype)`` in one pass:
        int8 x fp32 is computed in fp32 and rounded once into ``dtype``."""
        out = torch.empty(self.shape, dtype=dtype, device=self.q.device)
        return torch.mul(self.codes(), self.scale, out=out)

    def to(self, device):
        return type(self)(self.q.to(device), self.scale.to(device))

    @property
    def shape(self):
        """The logical (unpacked) weight shape."""
        return tuple(self.q.shape)

    def __repr__(self):
        return (f"{type(self).__name__}(q={tuple(self.q.shape)}, "
                f"scale={tuple(self.scale.shape)})")


class Int4Weight(Int8Weight):
    """int4 codes packed two per byte along the contracted axis -2
    (``q.shape[-2]`` is In // 2) and fp32 scales (..., 1, Out)."""

    bits = 4

    def codes(self):
        return unpack_int4(self.q)

    @property
    def shape(self):
        s = tuple(self.q.shape)
        return s[:-2] + (2 * s[-2], s[-1])


def is_quantized(x):
    return isinstance(x, Int8Weight)


def pack_int4(q):
    """Pack int4 codes (int8 storage, values in [-7, 7]) two per byte along
    axis -2: (..., In, Out) -> (..., In // 2, Out), byte r = (q[2r+1] << 4)
    | (q[2r] & 0xF). In must be even."""
    k = q.shape[-2]
    if k % 2:
        raise ValueError(f"int4 pack needs an even contracted dim, got {k}")
    lo = q[..., 0::2, :].to(torch.int16) & 0xF
    hi = (q[..., 1::2, :].to(torch.int16) & 0xF) << 4
    byte = hi | lo                                   # 0..255
    return torch.where(byte >= 128, byte - 256, byte).to(torch.int8)


def unpack_int4(p):
    """Inverse of pack_int4: (..., In // 2, Out) -> (..., In, Out) int8
    codes, each nibble sign-extended (through int16: no int8 shift
    overflow)."""
    b = p.to(torch.int16)                            # sign-extended byte
    lo = ((b & 0xF) ^ 8) - 8
    hi = b >> 4
    out = torch.stack([lo, hi], dim=-2)              # (..., In//2, 2, Out)
    shape = p.shape[:-2] + (2 * p.shape[-2], p.shape[-1])
    return out.reshape(shape).to(torch.int8)


def quantize_leaf(w, bits=8):
    """Per-channel symmetric int8/int4 quantization of one weight (any
    device), bitwise the JAX ``quantize_leaf``: fp32 absmax over axis -2,
    ``/ 127`` or ``/ 7``, a zero scale replaced by 1, round half to even,
    clip. ``bits=4`` falls back to int8 when axis -2 is odd."""
    w = w.float()
    int4 = bits == 4 and w.shape[-2] % 2 == 0
    qmax = 7.0 if int4 else 127.0
    scale = w.abs().amax(dim=-2, keepdim=True) / qmax
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.round(w / safe).clamp(-qmax, qmax).to(torch.int8)
    if int4:
        return Int4Weight(pack_int4(q), scale)
    return Int8Weight(q, scale)


def quantize_slices(shape, slices, bits, device):
    """Quantize a (..., In, Out) weight given slice by slice: ``slices``
    yields its (In, Out) slices in order (any float dtype). The scales
    reduce over In, which each slice holds whole, so the result is bitwise
    ``quantize_leaf`` of the whole weight while only one slice is ever in
    fp32."""
    *lead, In, Out = shape
    int4 = bits == 4 and In % 2 == 0
    rows = In // 2 if int4 else In
    q = torch.empty(*lead, rows, Out, dtype=torch.int8, device=device)
    scale = torch.empty(*lead, 1, Out, dtype=torch.float32, device=device)
    qf, sf = q.view(-1, rows, Out), scale.view(-1, 1, Out)
    n = 0
    for i, w in enumerate(slices):
        part = quantize_leaf(w, 4 if int4 else 8)
        qf[i].copy_(part.q)
        sf[i].copy_(part.scale)
        n = i + 1
    if n != qf.shape[0]:
        raise ValueError(f"quantize_slices: got {n} slices for {shape}")
    return (Int4Weight if int4 else Int8Weight)(q, scale)


def quantize_tensor(w, bits=8):
    """``quantize_leaf`` of a stacked weight one (In, Out) slice at a time
    (a whole bf16 Mixtral-8x7B expert stack would need 60 GB in fp32)."""
    if w.dim() <= 2:
        return quantize_leaf(w, bits)
    return quantize_slices(tuple(w.shape), iter(w.reshape(-1, *w.shape[-2:])),
                           bits, w.device)


def qualifies(key, shape, dtype, min_size=MIN_SIZE,
              exclude_keys=EXCLUDE_KEYS):
    """Whether ``quantize_tree`` quantizes a ``blocks`` leaf: a float
    weight with >= 2 dims and >= min_size elements, never a router."""
    numel = 1
    for s in shape:
        numel *= s
    return (key not in exclude_keys and len(shape) >= 2
            and numel >= min_size and dtype.is_floating_point)


def quantize_tree(params, min_size=MIN_SIZE, exclude_keys=EXCLUDE_KEYS,
                  bits=8):
    """Quantize the ``blocks`` sub-tree's float weights with >= 2 dims and
    >= min_size elements (embeddings, the head and small leaves stay as
    they are; routers named in ``exclude_keys`` are never quantized:
    int8 router logits can flip the top-k expert choice). Quantized nodes
    pass through."""

    def walk(tree, key, in_blocks):
        if isinstance(tree, dict):
            return {k: walk(v, k, in_blocks or k == "blocks")
                    for k, v in tree.items()}
        if (in_blocks and isinstance(tree, torch.Tensor)
                and qualifies(key, tuple(tree.shape), tree.dtype, min_size,
                              exclude_keys)):
            return quantize_tensor(tree, bits)
        return tree
    return walk(params, None, False)


def cast_unquantized(tree, dtype, exclude_keys=EXCLUDE_KEYS):
    """Cast a quantized tree's remaining float leaves (embeddings, norms)
    to ``dtype``, leaving quantized nodes and the ``exclude_keys`` leaves
    (routers keep fp32) untouched."""

    def walk(t, key):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if (key in exclude_keys or is_quantized(t)
                or not t.dtype.is_floating_point):
            return t
        return t.to(dtype)
    return walk(tree, None)


def dequant_tree(tree, dtype, keep=()):
    """Replace quantized nodes by their dequantized ``dtype`` tensors
    (identity on an unquantized tree); nodes under a dict key in ``keep``
    pass through quantized (the fused path's FFN weights)."""

    def walk(t, key):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if is_quantized(t) and key not in keep:
            return t.dequant(dtype)
        return t
    return walk(tree, None)


def has_quantized(tree):
    if isinstance(tree, dict):
        return any(has_quantized(v) for v in tree.values())
    return is_quantized(tree)


def layer_slice(w, i, dtype, keep=False):
    """Layer ``i`` of a stacked (L, ...) leaf, the counterpart of the JAX
    ``Llama._layer_slice`` on one leaf: a tensor's row i; a quantized
    leaf's (q[i], scale[i]), dequantized to ``dtype`` unless ``keep``.

    A 2-D quantized leaf (an (L, D) RMS scale, which passes ``min_size``
    at full width) was quantized over its L axis with one (1, D) scale.
    JAX indexes that scale with i and clamps, so every layer uses
    scale[0]: layer i is then row i of the whole leaf dequantized, which
    is what this returns (at int4 the JAX slice cannot unpack a 1-D row;
    row i of the dequantized leaf is the same rule)."""
    if not is_quantized(w):
        return w[i]
    if w.q.dim() == 2:
        if isinstance(w, Int4Weight):
            code = w.q[i // 2].to(torch.int16)
            code = (code >> 4) if i % 2 else ((code & 0xF) ^ 8) - 8
        else:
            code = w.q[i]
        return (code * w.scale[0]).to(dtype)
    wi = type(w)(w.q[i], w.scale[i])
    return wi if keep else wi.dequant(dtype)
