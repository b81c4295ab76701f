"""InferenceEngineV2 — continuous-batching serving over a paged KV cache.

Counterpart of ``deepspeed_tpu/inference/v2/engine_v2.py`` (the
``put()`` -> ``step()`` -> ``get()`` loop), in PyTorch on one card:
  * The blocked KV cache is a list of per-layer heads-major pools
    (num_blocks, KVH, block_size, hd) that the model updates in place;
    per-sequence block tables index them.
  * Three device programs run eagerly: the bucketed prefill (one
    sequence), the split-fuse chunk (one chunk of the oldest prefilling
    sequence, followed in the same dispatch by ``decode_steps_per_dispatch``
    decode steps of every running sequence) and the fused decode
    (``decode_steps_per_dispatch`` steps, each fed the token sampled by the
    last). Attention in all three goes through the Hopper paged kernels;
    a Mixtral's expert FFN through the grouped-GEMM kernels.
  * Scheduling is the JAX engine's: admit pending requests while slots and
    blocks allow, stream prompts through chunks (or bucketed prefill), then
    batched decode; sequences retire on EOS or max_new_tokens and their
    blocks return to the free list at once.
  * Serving telemetry (``monitor/telemetry.py``) and the disaggregated
    handoff half (``hold_decode``, ``export_handoff``, ``import_handoff``,
    ``release_handoff``; ``kv_transfer.py`` frames the bytes) are the JAX
    engine's, for ``Replica`` / ``Router``.

Sampling uses a ``torch.Generator`` seeded from ``config.seed``; it gives
other numbers than ``jax.random`` from the same seed, so only greedy
streams are comparable across the two packages.
"""

from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ...monitor.telemetry import ServingTelemetry
from ...runtime.checkpoint_engine import serialization as ser
from ...utils.device import resolve_device
from ...utils.logging import log_dist
from .ragged import DSStateManager

# fields of the JAX config the port does not carry yet: (allowed values,
# the ROADMAP Queue 1 serving item that brings them)
_NOT_YET = {
    "tensor_parallel": ((1,), "tensor parallel"),
    "expert_parallel": ((1,), "MoE expert parallel (M10)"),
    "kv_host_offload": ((False,), "KV host offload"),
    "device_kv_blocks": ((0,), "KV host offload"),
    "prefix_cache": (("auto", False), "prefix cache"),
    "prefix_cache_blocks": ((0,), "prefix cache"),
    "prefix_cache_min_match": (("auto",), "prefix cache"),
    "spec_draft": (("auto", False), "speculative decoding"),
    "spec_k": (("auto",), "speculative decoding"),
    "paged_block_c": (("auto",), "autotune winner cache"),
    "autotune_mode": (("",), "autotune winner cache"),
    "autotune_cache": (("",), "autotune winner cache"),
}


def _not_yet(what):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1, serving: {what})")


@dataclass
class RaggedInferenceEngineConfig:
    """The JAX engine's config. Fields this slice carries: dtype,
    max_batch_size, kv_block_size, num_kv_blocks, prompt_bucket,
    temperature, top_k, seed, decode_steps_per_dispatch, splitfuse_tokens,
    paged_kernel, quantize_weights, weight_quant, telemetry,
    telemetry_interval. The rest raise at a non-default value ("auto"
    settings that the JAX engine resolves off on a cold winner cache stay
    accepted and resolve off)."""
    dtype: str = "bfloat16"
    tensor_parallel: int = 1
    expert_parallel: int = 1
    max_batch_size: int = 8          # concurrent sequences
    kv_block_size: int = 64
    num_kv_blocks: int = 0           # 0 = auto from max_seq_len * max_batch
    prompt_bucket: int = 64
    temperature: float = 0.0         # 0 = greedy
    top_k: int = 0
    seed: int = 0
    decode_steps_per_dispatch: int = 8
    # Dynamic SplitFuse: > 0 = prompts stream through chunks of this many
    # tokens, each dispatch fused with the running decodes; 0 = bucketed
    # whole-prompt prefill
    splitfuse_tokens: int = 0
    # ZeRO-Inference capacity mode: the block weights live as int8 codes +
    # per-channel scales and dequantize one layer at a time
    quantize_weights: bool = False
    # fused W8A16 / W4A16: "int8" | "int4" quantizes as above and keeps the
    # FFN weights quantized into the fused-dequant kernels (K7, K9); "auto"
    # resolves off; wins over quantize_weights
    weight_quant: object = "auto"
    kv_host_offload: bool = False
    device_kv_blocks: int = 0
    # "auto" / True = the Hopper paged kernels (the port has no winner
    # cache yet, so "auto" means the kernels); False = the dense-gather
    # parity path, explicit only
    paged_kernel: object = "auto"
    paged_block_c: object = "auto"
    prefix_cache: object = "auto"
    prefix_cache_blocks: int = 0
    prefix_cache_min_match: object = "auto"
    spec_draft: object = "auto"
    spec_k: object = "auto"
    autotune_mode: str = ""
    autotune_cache: str = ""
    # per-request TTFT/TPOT accounting (monitor/telemetry.py
    # ServingTelemetry); with a monitor passed to the engine,
    # Serve/Telemetry/* events every telemetry_interval completed requests
    telemetry: bool = True
    telemetry_interval: int = 32

    def __post_init__(self):
        if self.paged_kernel not in (True, False, "auto"):
            raise ValueError(
                f"paged_kernel must be true|false|'auto', got "
                f"{self.paged_kernel!r}")
        if self.splitfuse_tokens < 0:
            raise ValueError(
                f"splitfuse_tokens must be >= 0, got "
                f"{self.splitfuse_tokens}")
        if self.dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"dtype must be 'bfloat16' or 'float32', got {self.dtype!r}")
        if self.weight_quant not in (False, "auto", "int8", "int4"):
            raise ValueError(
                f"weight_quant must be false|'auto'|'int8'|'int4', got "
                f"{self.weight_quant!r}")
        for name, (allowed, item) in _NOT_YET.items():
            value = getattr(self, name)
            if not any(value is a or (type(value) is type(a) and value == a)
                       for a in allowed):
                raise _not_yet(item)


def _host_leaf(t):
    """A device tensor as a host numpy array; bf16, which numpy has no
    dtype for, as its raw 2-byte words (``np.dtype("V2")``)."""
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _torch_dtype(dtype):
    """The torch dtype of a host KV leaf: any 2-byte void (raw bf16 words,
    or the JAX package's ``bfloat16``) is bf16; None when torch has
    none."""
    try:
        dtype = np.dtype(dtype)
    except TypeError:
        return None
    if dtype.kind == "V" and dtype.itemsize == 2:
        return torch.bfloat16
    try:
        return torch.from_numpy(np.empty(0, dtype)).dtype
    except TypeError:
        return None


def _device_leaf(a, device):
    """Inverse of :func:`_host_leaf`: a host KV leaf on ``device``."""
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16)).to(device).view(
            torch.bfloat16)
    return torch.from_numpy(a).to(device)


@dataclass
class _Request:
    uid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_token_id: int = -1
    temperature: float = 0.0
    top_k: int = 0


class InferenceEngineV2:
    """``put(uid, prompt)`` then ``step()`` until ``is_done(uid)``;
    ``get(uid)`` returns the generated tokens.

    ``model``: the port's ``Llama`` or ``Mixtral`` (moved to ``device``
    in ``config.dtype``, every floating parameter cast, the Mixtral router
    too, as the JAX engine's ``shard_params`` does); ``device`` defaults to
    the card and raises without one. ``monitor``: any object with
    ``enabled`` and ``write_events(events)``, for the ``Serve/Telemetry/*``
    events of ``ServingTelemetry`` (``telemetry_snapshot()`` reads it
    without one). Under ``weight_quant`` /
    ``quantize_weights`` a float model is quantized here (``quantize_``)
    and one built with ``quantize=`` must be in the same mode; codes,
    scales and the router then keep their types (``to_serving``).
    ``forward_counts`` counts the model forwards each program ran
    (prefill, chunk, decode step) — with the kernels on, every forward
    launches one paged kernel per layer, and a Mixtral forward one fused
    gate/up and one down grouped kernel per layer (``model.grouped_kernel``;
    the K9 pair under ``weight_quant``), a quantized Llama three K7
    products per layer."""

    def __init__(self, model, config=None, device=None, monitor=None,
                 draft_model=None, **kwargs):
        if isinstance(config, dict):
            config = RaggedInferenceEngineConfig(**{**config, **kwargs})
        elif config is None:
            config = RaggedInferenceEngineConfig(**kwargs)
        if draft_model is not None:
            raise _not_yet("speculative decoding")
        self.config = config
        self.telemetry = None
        if config.telemetry:
            self.telemetry = ServingTelemetry(
                monitor=monitor, interval=config.telemetry_interval)
        self.device = resolve_device(device)
        self.dtype = getattr(torch, config.dtype)
        # weight_quant wins over quantize_weights (int8, nothing kept
        # quantized); "auto" resolves off
        fused = (config.weight_quant if config.weight_quant
                 in ("int8", "int4") else None)
        quant = fused or ("int8" if config.quantize_weights else None)
        built = model.weight_quant
        if built and built != quant:
            raise ValueError(
                f"the model's weights are quantized as {built!r} but the "
                f"engine config asks for {quant!r} (weight_quant="
                f"{config.weight_quant!r}, quantize_weights="
                f"{config.quantize_weights})")
        if quant and not built:
            model.quantize_(quant)
        self.model = model.to_serving(self.device, self.dtype)
        model.paged_kernel = config.paged_kernel
        model._weight_quant_fused = fused is not None
        self.max_seq_len = model.config.max_seq_len

        BS = config.kv_block_size
        self.max_blocks_per_seq = -(-self.max_seq_len // BS)
        num_blocks = config.num_kv_blocks or (
            1 + config.max_batch_size * self.max_blocks_per_seq)
        self.state_mgr = DSStateManager(
            num_blocks=num_blocks, block_size=BS,
            max_batch=config.max_batch_size,
            max_blocks_per_seq=self.max_blocks_per_seq)
        self.cache = model.init_paged_cache(num_blocks, BS, dtype=self.dtype)
        # the router's prefix-affinity probe reads it; the port has no
        # prefix cache yet (ROADMAP Queue 1, serving: prefix cache)
        self.prefix_cache = None

        self._pending = deque()
        self._results = {}            # uid -> generated tokens (finished)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(config.seed + 23)
        self._prefill_q = deque()     # uids mid-chunked-prefill (SplitFuse)
        # disaggregated prefill/decode: uids parked out of every decode
        # dispatch until their KV streams to a decode replica
        self._decode_hold = set()
        self._uid_next = 0
        self.forward_counts = {"prefill": 0, "chunk": 0, "decode": 0}
        log_dist(
            f"v2 engine ready: device={self.device} blocks="
            f"{num_blocks}x{BS} max_batch={config.max_batch_size}",
            ranks=[0])

    # ------------------------------------------------------------- requests
    def put(self, prompt, max_new_tokens=32, eos_token_id=-1, uid=None,
            temperature=None, top_k=None, klass=0):
        """Queue a generation request (sampling params per request; None
        = the engine-config defaults; ``klass`` = the router's request
        class, which serving telemetry keys by). Returns its uid."""
        if uid is None:
            uid = self._uid_next
            self._uid_next += 1
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = len(prompt) + max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(
                f"prompt+max_new={total} exceeds "
                f"model max_seq_len={self.max_seq_len}")
        mgr = self.state_mgr
        if mgr.blocks_needed(total) > mgr.allocator.total_blocks:
            raise ValueError(
                f"request needs {mgr.blocks_needed(total)} KV blocks but "
                f"the pool only has {mgr.allocator.total_blocks}; raise "
                "num_kv_blocks")
        self._pending.append(_Request(
            uid, prompt, max_new_tokens, eos_token_id,
            temperature=(self.config.temperature if temperature is None
                         else float(temperature)),
            top_k=(self.config.top_k if top_k is None else int(top_k))))
        if self.telemetry is not None:
            # the TTFT clock starts at submit
            self.telemetry.on_submit(uid, klass=klass)
        return uid

    def is_done(self, uid):
        if uid in self._results:
            return True
        if any(r.uid == uid for r in self._pending):
            return False
        if uid in self.state_mgr._seqs:
            return False
        raise KeyError(f"unknown uid {uid} (never submitted or already "
                       "fetched with get())")

    def get(self, uid, flush=True):
        """Generated tokens for a finished request (``flush`` forgets the
        result afterwards; in-flight requests return their tokens so far)."""
        if uid in self._results:
            return self._results.pop(uid) if flush else self._results[uid]
        if any(r.uid == uid for r in self._pending):
            return np.zeros((0,), np.int32)  # queued, nothing yet
        try:
            seq = self.state_mgr.get_sequence(uid)
        except KeyError:
            raise KeyError(
                f"unknown uid {uid} (never submitted, or already fetched "
                f"with get(flush=True))") from None
        return np.asarray(seq.generated, np.int32)

    def cancel(self, uid):
        """Withdraw a request (the router's deadline / shed path): queued
        requests are dropped; in-flight sequences are flushed (blocks back
        to the pool); a finished-but-unfetched result is forgotten.
        Serving telemetry drops the request from its windows
        (``on_reject``). Returns True when the uid was known."""
        self._decode_hold.discard(uid)
        for i, r in enumerate(self._pending):
            if r.uid == uid:
                del self._pending[i]
                if self.telemetry is not None:
                    self.telemetry.on_reject(uid)
                return True
        if uid in self._results:
            del self._results[uid]
            return True
        if uid not in self.state_mgr._seqs:
            return False
        try:
            self._prefill_q.remove(uid)
        except ValueError:
            pass
        self.state_mgr.flush(uid)
        if self.telemetry is not None:
            self.telemetry.on_reject(uid)
        return True

    @property
    def has_work(self):
        return bool(self._pending) or self.state_mgr.n_active > 0

    # -------------------------------- disaggregated prefill/decode handoff
    def hold_decode(self, uid):
        """Park ``uid`` out of every decode dispatch. A prefill-role
        replica holds each sequence here once submitted: it prefills to
        the last prompt token, posts the first generated token, then waits
        for its KV handoff to a decode replica instead of decoding."""
        self._decode_hold.add(uid)

    def release_decode_hold(self, uid=None):
        """Release one park (all of them with ``uid=None``: when the
        fleet's last decode replica dies every held sequence resumes
        decoding here)."""
        if uid is None:
            self._decode_hold.clear()
        else:
            self._decode_hold.discard(uid)

    def export_handoff(self, uid):
        """Export half of the handoff: -> (descriptor state dict, host KV
        tree ``{"k": [...], "v": [...]}`` holding the blocks the sequence
        wrote). One gather per layer pool over the sequence's first
        ``blocks_needed(seen_tokens - 1)`` blocks, copied to host; bf16
        pools go over as raw 2-byte words (numpy has no bfloat16), which
        ``kv_transfer.pack_handoff`` names "bfloat16" as the JAX package
        does. The sequence is not removed: :meth:`release_handoff` runs
        once the decode side confirms the import, so a failed stream
        retries from unchanged state. The blocks hold positions
        ``0..seen_tokens-2``, exactly what a colocated decode would
        attend: the last generated token's KV is written by the decode
        step that consumes it."""
        mgr = self.state_mgr
        seq = mgr.get_sequence(uid)
        if not seq.generated:
            raise RuntimeError(
                f"uid {uid} has no first token yet — only "
                f"prefill-complete sequences hand off")
        n = mgr.blocks_needed(seq.seen_tokens - 1)
        src = torch.as_tensor(seq.blocks[:n], dtype=torch.long,
                              device=self.device)
        with torch.inference_mode():
            kv_host = {name: [_host_leaf(p.index_select(0, src))
                              for p in pools]
                       for name, pools in self.cache.items()}
        t_submit = None
        klass = 0
        if self.telemetry is not None:
            t_submit = self.telemetry.submit_stamp(uid)
            klass = self.telemetry.klass_of(uid)
        state = {
            "uid": int(uid),
            "prompt": [int(t) for t in seq.prompt],
            "generated": [int(t) for t in seq.generated],
            # the prefix cache's claimed length; always 0 without one
            "cached_len": 0,
            "max_new_tokens": int(seq.max_new_tokens),
            "eos_token_id": int(seq.eos_token_id),
            "temperature": float(seq.temperature),
            "top_k": int(seq.top_k),
            "klass": int(klass),
            "t_submit": t_submit,
        }
        return state, kv_host

    def import_handoff(self, state, kv_flat):
        """Import half of the handoff: rebuild the wire's KV tree against
        this engine's cache, check its layout (per-block shape and dtype
        equal to the local pools', one block count across layers),
        allocate the sequence's whole budget from this pool, write the
        received blocks into each layer's pool in place (``index_copy_``
        of the real rows only), and bind the descriptor straight into the
        decode batch. Serving telemetry registers the request at its
        original submit stamp. Returns the uid."""
        from .kv_transfer import KVWireError
        mgr = self.state_mgr
        uid = int(state["uid"])
        if uid in mgr._seqs or uid in self._results:
            raise RuntimeError(f"handoff uid {uid} already live here")
        prompt = np.asarray(state["prompt"], np.int32)
        generated = [int(t) for t in state["generated"]]
        max_new = int(state["max_new_tokens"])
        template = {name: [0] * len(pools)
                    for name, pools in self.cache.items()}
        kv = ser.unflatten_into(template, kv_flat)
        # layout guard: a payload of another model (a GQA mismatch, a
        # block size) must never land in this cache
        n_blocks = set()
        for name, pools in self.cache.items():
            for p, a in zip(pools, kv[name]):
                shape = getattr(a, "shape", None)
                dtype = getattr(a, "dtype", None)
                if shape is None or tuple(shape[1:]) != tuple(p.shape[1:]) \
                        or _torch_dtype(dtype) != p.dtype:
                    raise KVWireError(
                        f"handoff KV layout mismatch: payload block shape "
                        f"{shape}/{dtype} vs local cache "
                        f"{tuple(p.shape)}/{p.dtype}")
                n_blocks.add(int(shape[0]))
        if len(n_blocks) != 1:
            raise KVWireError(
                f"handoff KV payload has inconsistent block counts "
                f"across layers: {sorted(n_blocks)}")
        n = n_blocks.pop()
        total = len(prompt) + max_new
        need = mgr.blocks_needed(total)
        if need > self.max_blocks_per_seq or n > need \
                or total > self.max_seq_len:
            raise KVWireError(
                f"handoff sequence needs {need} blocks / {total} "
                f"tokens — beyond this engine's per-sequence capacity")
        if mgr.free_slot() is None or \
                mgr.allocator.available_blocks < need:
            raise RuntimeError(
                "decode replica cannot admit handoff (no free "
                "slot/blocks) — the router must back-pressure "
                "(can_accept) before streaming")
        blocks = mgr.allocator.allocate(need)
        dst = torch.as_tensor(blocks[:n], dtype=torch.long,
                              device=self.device)
        with torch.inference_mode():
            for name, pools in self.cache.items():
                for p, a in zip(pools, kv[name]):
                    p.index_copy_(0, dst, _device_leaf(a, self.device))
        mgr.admit_imported(
            uid, prompt, generated, max_new, blocks,
            eos_token_id=int(state["eos_token_id"]),
            temperature=float(state["temperature"]),
            top_k=int(state["top_k"]))
        if self.telemetry is not None:
            self.telemetry.on_handoff_in(
                uid, klass=int(state.get("klass", 0)),
                submit_ts=state.get("t_submit"))
        return uid

    def release_handoff(self, uid):
        """The decode side confirmed the import: drop the sequence here
        (blocks and slot back, no result surfaced); telemetry forgets it
        without counting a rejection and keeps its TTFT sample (the first
        token was produced here)."""
        self._decode_hold.discard(uid)
        self.state_mgr.retire(uid)
        self.state_mgr.flush(uid)
        if self.telemetry is not None:
            self.telemetry.on_handoff_out(uid)

    # ------------------------------------------------------------- programs
    @staticmethod
    def _sample_per_slot(logits, gen, temps, top_ks, all_greedy=False):
        """Per-request sampling: logits (B, V) fp32, temps (B,) f32 (0 =
        greedy), top_ks (B,) int32 (0 = off). Gumbel-max over the
        temperature-scaled, top-k-masked logits; argmax ties take the
        first index."""
        greedy = logits.argmax(dim=-1).to(torch.int32)
        if all_greedy:
            return greedy
        V = logits.shape[-1]
        lt = logits / temps.clamp(min=1e-6)[:, None]
        sorted_desc = lt.sort(dim=-1, descending=True).values
        kth_val = sorted_desc.gather(
            1, (top_ks.long() - 1).clamp(0, V - 1)[:, None])
        masked = torch.where((top_ks[:, None] > 0) & (lt < kth_val),
                             -1e30, lt)
        u = torch.rand(masked.shape, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
        sampled = (masked + gumbel).argmax(dim=-1).to(torch.int32)
        return torch.where(temps > 0, sampled, greedy)

    def _dev(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _decode_steps(self, batch, all_greedy):
        """``decode_steps_per_dispatch`` decode steps over the batch, each
        fed the token sampled by the last; returns (n, B) tokens on the
        host (one device sync per dispatch)."""
        model = self.model
        tokens = self._dev(batch.tokens)
        lengths = self._dev(batch.lengths)
        tables = self._dev(batch.block_tables)
        temps = self._dev(batch.temps)
        top_ks = self._dev(batch.top_ks)
        toks = []
        for _ in range(max(1, self.config.decode_steps_per_dispatch)):
            logits, self.cache = model.apply_paged_decode(
                tokens, lengths, self.cache, tables)
            self.forward_counts["decode"] += 1
            tokens = self._sample_per_slot(logits, self._gen, temps, top_ks,
                                           all_greedy)
            lengths = lengths + 1
            toks.append(tokens)
        return torch.stack(toks)

    def _sample_one(self, logits, seq, all_greedy):
        return self._sample_per_slot(
            logits, self._gen,
            torch.tensor([seq.temperature], dtype=torch.float32,
                         device=self.device),
            torch.tensor([seq.top_k], dtype=torch.int32, device=self.device),
            all_greedy)

    def _step_splitfuse_chunk(self):
        """Run one fused dispatch: the next chunk of the oldest
        prefilling sequence + n decode steps (chunk-only when nothing is
        decoding). Returns decode (uid, token) pairs."""
        mgr = self.state_mgr
        C = self.config.splitfuse_tokens or self.config.prompt_bucket
        uid = self._prefill_q[0]
        seq = mgr.get_sequence(uid)
        off = seq.prefill_offset
        true_len = min(C, len(seq.prompt) - off)
        ids = np.zeros((1, C), np.int32)
        ids[0, :true_len] = seq.prompt[off:off + true_len]
        tb = np.zeros((C,), np.int32)
        to = np.zeros((C,), np.int32)
        fb, fo = mgr.token_placement(seq)
        tb[:true_len] = fb[off:off + true_len]
        to[:true_len] = fo[off:off + true_len]
        table = np.zeros((self.max_blocks_per_seq,), np.int32)
        table[:len(seq.blocks)] = seq.blocks

        batch = mgr.decode_batch(exclude=self._decode_hold)
        decoding = bool(batch.active.any())
        all_greedy = seq.temperature == 0.0 and not (
            decoding and bool(batch.temps.any()))
        with torch.inference_mode():
            c_logits, self.cache = self.model.apply_paged_chunk(
                self._dev(ids), self.cache, self._dev(tb), self._dev(to),
                off, true_len, self._dev(table))
            self.forward_counts["chunk"] += 1
            c_tok = self._sample_one(c_logits, seq, all_greedy)
            if decoding:
                toks = self._decode_steps(batch, all_greedy).cpu().numpy()
            else:
                toks = np.zeros((0, self.config.max_batch_size), np.int32)
            c_tok = int(c_tok.cpu()[0])
        seq.prefill_offset = off + true_len
        if seq.prefill_offset >= len(seq.prompt):
            self._prefill_q.popleft()
            self._post_token(seq, c_tok)
        return self._post_decode_tokens(batch, toks)

    # ----------------------------------------------------------------- step
    def _admit_pending(self):
        mgr = self.state_mgr
        bucket = self.config.prompt_bucket
        while self._pending:
            req = self._pending[0]
            if not mgr.can_admit(len(req.prompt), req.max_new_tokens):
                break
            self._pending.popleft()
            slot, seq = mgr.admit(req.uid, req.prompt, req.max_new_tokens,
                                  req.eos_token_id,
                                  temperature=req.temperature,
                                  top_k=req.top_k)
            if self.config.splitfuse_tokens:
                # SplitFuse: the prompt streams through chunk dispatches
                # interleaved with decodes — no bucketed prefill here
                self._prefill_q.append(req.uid)
                continue
            T = len(req.prompt)
            T_pad = -(-max(T, 1) // bucket) * bucket
            ids = np.zeros((1, T_pad), np.int32)
            ids[0, :T] = req.prompt
            tb = np.zeros((T_pad,), np.int32)       # scratch for pads
            to = np.zeros((T_pad,), np.int32)
            tb[:T], to[:T] = mgr.token_placement(seq)
            with torch.inference_mode():
                logits, self.cache = self.model.apply_paged_prefill(
                    self._dev(ids), self.cache, self._dev(tb),
                    self._dev(to), T)
                self.forward_counts["prefill"] += 1
                tok = int(self._sample_one(logits, seq,
                                           seq.temperature == 0.0).cpu()[0])
            self._post_token(seq, tok)

    def _post_token(self, seq, token):
        seq.generated.append(token)
        if self.telemetry is not None:
            self.telemetry.on_token(seq.uid)
        if ((seq.eos_token_id >= 0 and token == seq.eos_token_id)
                or len(seq.generated) >= seq.max_new_tokens):
            # a held sequence that finishes at its first token never
            # needs the handoff: drop the park
            self._decode_hold.discard(seq.uid)
            self._results[seq.uid] = np.asarray(seq.generated, np.int32)
            if self.telemetry is not None:
                self.telemetry.on_finish(seq.uid)
            self.state_mgr.retire(seq.uid)
            self.state_mgr.flush(seq.uid)

    def step(self):
        """One scheduler iteration (see :meth:`_step_inner`). The dispatch
        boundary is where serving telemetry amortizes this dispatch's wall
        time across the tokens it produced."""
        out = self._step_inner()
        if self.telemetry is not None:
            self.telemetry.on_dispatch(active=self.state_mgr.n_active)
            self.telemetry.maybe_emit()
        return out

    def telemetry_snapshot(self):
        """Current TTFT/TPOT percentiles and counters (None when serving
        telemetry is off)."""
        return None if self.telemetry is None else \
            self.telemetry.percentiles()

    def _step_inner(self):
        """One scheduler iteration: admit+prefill pending, then the next
        split-fuse chunk (fused with n decode steps) or n decode steps for
        every active sequence. Returns the (uid, token) decode pairs.

        A sequence that hits EOS or its budget mid-dispatch keeps decoding
        until the dispatch ends (its extra tokens are discarded; its
        writes land in its own tail slots or the scratch block)."""
        self._admit_pending()
        if self._prefill_q:
            return self._step_splitfuse_chunk()
        if self.state_mgr.n_active == 0:
            return []
        return self._plain_decode()

    def _plain_decode(self):
        """n fused decode steps over all active slots but the held ones."""
        batch = self.state_mgr.decode_batch(exclude=self._decode_hold)
        if not batch.active.any():
            return []
        with torch.inference_mode():
            toks = self._decode_steps(
                batch, not bool(batch.temps.any())).cpu().numpy()
        return self._post_decode_tokens(batch, toks)

    def _post_decode_tokens(self, batch, toks):
        """Feed (n, B) decode outputs to their sequences; returns the
        accepted (uid, token) pairs."""
        mgr = self.state_mgr
        out = []
        slots = list(mgr._slots)  # snapshot: retire mutates
        for slot, uid in enumerate(slots):
            if uid is None or not batch.active[slot]:
                continue
            seq = mgr.get_sequence(uid)
            for t in range(toks.shape[0]):
                if uid in self._results:
                    break                            # finished mid-dispatch
                tok = int(toks[t, slot])
                self._post_token(seq, tok)
                out.append((uid, tok))
        return out

    def generate_all(self, prompts, max_new_tokens=32, eos_token_id=-1):
        """Convenience: run the scheduler to completion over a request
        list; returns generated-token arrays in submission order."""
        uids = [self.put(p, max_new_tokens, eos_token_id) for p in prompts]
        while self.has_work:
            self.step()
        return [self.get(u) for u in uids]
