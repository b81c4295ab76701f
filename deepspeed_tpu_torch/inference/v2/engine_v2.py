"""InferenceEngineV2 — continuous-batching serving over a paged KV cache.

Counterpart of ``deepspeed_tpu/inference/v2/engine_v2.py`` (the
``put()`` -> ``step()`` -> ``get()`` loop), in PyTorch on one card or, at
``tensor_parallel`` / ``expert_parallel`` > 1, one process a rank of a
world (see ``InferenceEngineV2``):
  * The blocked KV cache is a list of per-layer heads-major pools
    (num_blocks, KVH, block_size, hd) that the model updates in place;
    per-sequence block tables index them.
  * The device programs run eagerly: the bucketed prefill (one sequence),
    the split-fuse chunk (one chunk of the oldest prefilling sequence,
    followed in the same dispatch by ``decode_steps_per_dispatch`` decode
    steps of every running sequence) and the fused decode
    (``decode_steps_per_dispatch`` steps, each fed the token sampled by the
    last). Attention in all of them goes through the Hopper paged kernels;
    a Mixtral's expert FFN, and a ragged GPT2MoE's, through the
    grouped-GEMM kernels. The Llama family, Mixtral, the GPT-2 family
    (GPT-2, OPT, GPT-Neo) and GPT2MoE (both MoE backends) serve.
  * Scheduling is the JAX engine's: admit pending requests while slots and
    blocks allow, stream prompts through chunks (or bucketed prefill), then
    batched decode; sequences retire on EOS or max_new_tokens and their
    blocks return to the pool at once.
  * The serving features of the JAX engine: the radix prefix cache
    (``prefix_cache.py``; a hit skips the cached prefix's prefill, a
    partial-tail hit copies the matched slice into a fresh block on the
    compute stream first), draft-model speculative decoding
    (``speculative.py``; ``draft_model=``: the draft proposes ``spec_k``
    tokens a greedy sequence and the target verifies all k+1 in one
    ``apply_paged_verify`` pass through K5) and KV host offload
    (``kv_offload.py``; the logical pool in pinned host memory, the device
    pool an LRU cache of it, decode in groups whose blocks fit it).
  * Serving telemetry (``monitor/telemetry.py``) and the disaggregated
    handoff half (``hold_decode``, ``export_handoff``, ``import_handoff``,
    ``release_handoff``; ``kv_transfer.py`` frames the bytes) are the JAX
    engine's, for ``Replica`` / ``Router``.

"auto" knobs (``paged_kernel``, ``paged_block_c``, ``prefix_cache``,
``prefix_cache_min_match``, ``spec_draft``, ``spec_k``) resolve through the
autotune winner cache (``autotuning/``) per shape bucket, under the
engine's ``autotune_mode`` / ``autotune_cache`` ("" = the
``DSTPU_AUTOTUNE`` / ``DSTPU_AUTOTUNE_CACHE`` env, default ``cache_only``
over ~/.cache/deepspeed_tpu/kernel_autotune.json). The engine installs its
dispatch state and kernel knobs at construction and again before each
program runs (``_install_trace_state``), so engines sharing one model each
dispatch under their own config. A cold cache gives the JAX package's
cold-cache defaults (prefix cache off; speculation on once a draft model
is passed, k = 4) and the paged kernels with their shape rules. Sampling
uses a
``torch.Generator`` seeded from ``config.seed``; it gives other numbers
than ``jax.random`` from the same seed, so only greedy streams are
comparable across the two packages.
"""

import json
from collections import Counter, deque
from dataclasses import dataclass

import numpy as np
import torch

from ...comm import comm
from ...monitor.telemetry import ServingTelemetry
from ...runtime.checkpoint_engine import serialization as ser
from ...utils import groups
from ...utils.device import resolve_device
from ...utils.logging import log_dist
from ..utils import shard_model
from .blocked_allocator import BlockedAllocator
from .kv_offload import OffloadKVPool
from .prefix_cache import PrefixCache, resolve_prefix_cache
from .ragged import DSStateManager, RaggedBatchWrapper
from .speculative import (SPEC_EMA_ALPHA, SPEC_MIN_ROUNDS, longest_accept,
                          resolve_spec)

_TODO_REPLICAS = "(ROADMAP Queue 1, serving: multi-rank replicas)"


class _RankZeroWinners:
    """The autotune winner cache's agreement across a multi-rank engine's
    ranks (``kernel_dispatch.set_agreement``): rank 0 resolves each key
    (its cache lookup, or its measured search), the others skip theirs and
    take rank 0's winner, so every rank launches the same design."""

    def __init__(self):
        self.root = comm.get_rank() == 0

    def __call__(self, winner):
        got = comm.allgather_bytes(json.dumps(winner).encode())
        return json.loads(got[0])


@dataclass
class RaggedInferenceEngineConfig:
    """The JAX engine's config. Fields this port carries: dtype,
    max_batch_size, kv_block_size, num_kv_blocks, prompt_bucket,
    temperature, top_k, seed, decode_steps_per_dispatch, splitfuse_tokens,
    quantize_weights, weight_quant, kv_host_offload, device_kv_blocks,
    paged_kernel, paged_block_c, prefix_cache, prefix_cache_blocks,
    prefix_cache_min_match, spec_draft, spec_k, autotune_mode,
    autotune_cache, telemetry, telemetry_interval, tensor_parallel and
    expert_parallel (a world of ``tensor_parallel * expert_parallel``
    ranks or a multiple of it, see ``InferenceEngineV2``)."""
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
    # ZeRO-Inference KV host offload: the logical block space lives in
    # (pinned) host memory, the device holds device_kv_blocks slots a layer
    # as an LRU cache of it; decode dispatches run in groups whose blocks
    # fit, the next group's uploads staged on a side stream under the
    # current group's compute (kv_offload.py)
    kv_host_offload: bool = False
    device_kv_blocks: int = 0        # required > 1 when kv_host_offload
    # "auto" = the winner cache's choice per shape bucket (the Hopper paged
    # kernels on a miss; on a card no cache entry may name the dense path);
    # True = the kernels; False = the dense-gather parity path, explicit
    # only
    paged_kernel: object = "auto"
    # the chunk kernel's query tile (SIMT / fp32 designs): "auto" = the
    # winner cache's (PAGED_CHUNK_BLOCK_C on a miss) | a positive int
    paged_block_c: object = "auto"
    # radix-tree prefix cache (prefix_cache.py): "auto" resolves OFF (the
    # JAX cold default); True raises under kv_host_offload
    prefix_cache: object = "auto"
    # cap on tree-held blocks (0 = bounded only by the pool)
    prefix_cache_blocks: int = 0
    # minimum matched FULL blocks for a hit ("auto" = 1)
    prefix_cache_min_match: object = "auto"
    # draft-model speculative decoding; the opt-in is the engine's
    # ``draft_model`` argument. spec_draft: "auto" (on once a draft model
    # is passed) | True (raises without a draft model, or under
    # kv_host_offload) | False; spec_k: "auto" (4) | int >= 1
    spec_draft: object = "auto"
    spec_k: object = "auto"
    # serving-side autotune dispatch state, applied COMPLETE at engine
    # construction and before each program runs ("" = the DSTPU_AUTOTUNE /
    # DSTPU_AUTOTUNE_CACHE env, default cache_only): off | cache_only |
    # on_first_use | search, and the winner cache file
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
        if self.paged_block_c != "auto" and (
                not isinstance(self.paged_block_c, int)
                or isinstance(self.paged_block_c, bool)
                or self.paged_block_c < 1):
            raise ValueError(
                f"paged_block_c must be 'auto' or a positive int, got "
                f"{self.paged_block_c!r}")
        if self.autotune_mode not in ("", "off", "cache_only",
                                      "on_first_use", "search"):
            raise ValueError(
                f"autotune_mode must be ''|off|cache_only|on_first_use|"
                f"search, got {self.autotune_mode!r}")
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
        if self.prefix_cache not in (True, False, "auto"):
            raise ValueError(
                f"prefix_cache must be true|false|'auto', got "
                f"{self.prefix_cache!r}")
        if self.prefix_cache_min_match != "auto" and (
                not isinstance(self.prefix_cache_min_match, int)
                or isinstance(self.prefix_cache_min_match, bool)
                or self.prefix_cache_min_match < 1):
            raise ValueError(
                f"prefix_cache_min_match must be 'auto' or an int >= 1, "
                f"got {self.prefix_cache_min_match!r}")
        if not isinstance(self.prefix_cache_blocks, int) \
                or isinstance(self.prefix_cache_blocks, bool) \
                or self.prefix_cache_blocks < 0:
            raise ValueError(
                f"prefix_cache_blocks must be an int >= 0, got "
                f"{self.prefix_cache_blocks!r}")
        if self.spec_draft not in (True, False, "auto"):
            raise ValueError(
                f"spec_draft must be true|false|'auto', got "
                f"{self.spec_draft!r}")
        if self.spec_k != "auto" and (
                not isinstance(self.spec_k, int)
                or isinstance(self.spec_k, bool)
                or self.spec_k < 1):
            raise ValueError(
                f"spec_k must be 'auto' or an int >= 1, got "
                f"{self.spec_k!r}")
        if self.prefix_cache is True and self.kv_host_offload:
            raise ValueError(
                "prefix_cache=True is incompatible with kv_host_offload: "
                "tree-held blocks would pin host/device residency the "
                "offload pool cannot track — use one or the other")
        if not isinstance(self.telemetry_interval, int) \
                or self.telemetry_interval < 1:
            raise ValueError(
                f"telemetry_interval must be an int >= 1, got "
                f"{self.telemetry_interval!r}")
        for name in ("tensor_parallel", "expert_parallel"):
            value = getattr(self, name)
            if not isinstance(value, int) or isinstance(value, bool) \
                    or value < 1:
                raise ValueError(f"{name} must be an int >= 1, got "
                                 f"{value!r}")


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

    ``model``: the port's ``Llama`` (or one of the families built on it:
    ``Bloom``, ``Falcon``, ``GPTNeoX``, ``GPTJ``, ``InternLM``, ``Phi``,
    ``Qwen``), ``Mixtral``, or ``GPT2`` (or one of the families built on
    it: ``OPT``, ``GPTNeo``, ``GPT2MoE``) (moved to ``device``
    in ``config.dtype``, every floating parameter cast, the Mixtral router
    too, as the JAX engine's ``shard_params`` does); ``device`` defaults to
    the card and raises without one. ``monitor``: any object with
    ``enabled`` and ``write_events(events)``, for the ``Serve/Telemetry/*``
    events of ``ServingTelemetry`` (``telemetry_snapshot()`` reads it
    without one). Under ``weight_quant`` /
    ``quantize_weights`` a float model is quantized here (``quantize_``)
    and one built with ``quantize=`` must be in the same mode; codes,
    scales and the router then keep their types (``to_serving``).
    ``draft_model``: a port model the engine serves, with the target's
    vocabulary (the target itself too) that proposes tokens for
    speculative decoding; it is cast like the model, never quantized here,
    and gets a KV pool of its own.
    ``forward_counts`` counts the model forwards each program ran
    (prefill, chunk, decode step, verify) and ``draft_forward_counts`` the
    draft's (catch-up chunk, propose decode step) — with the kernels on,
    every forward launches one paged kernel per layer (a verify forward
    one chunk kernel per slot and layer), and a Mixtral forward one fused
    gate/up and one down grouped kernel per layer (``model.grouped_kernel``;
    the K9 pair under ``weight_quant``), a GPT2MoE with the ragged backend
    and its grouped kernel on two ``grouped_gmm`` per layer (up, down; the
    same under ``weight_quant``, whose expert leaves are dequantized a
    layer at a time as in JAX) and with the dense backend none (its
    capacity dispatch is batched products), a quantized Llama three K7
    products per layer (two without the gate: GPT-J, Bloom, ...), a
    quantized GPT-2 two (``wup``, ``wdown``).

    Multi-rank serving (``tensor_parallel`` / ``expert_parallel`` > 1, the
    JAX engine over its mesh): the engine joins the world as
    ``initialize`` does (``comm.init_distributed``: ``env://``, a no-op
    once joined) and builds its topology from the config
    (``groups.initialize``: ``tensor`` innermost, ``expert`` next, data
    parallelism over the rest of the world) unless given the one
    ``groups.initialize`` made. Every rank constructs the engine with the
    whole model (float or quantized, the same weights) and keeps its slice
    (``inference/utils.shard_model``, after the whole-tree quantization):
    the Llama family's and the GPT-2 family's heads and FFN columns over
    ``tensor`` (a sum over ``tensor`` after each row-parallel product, its
    bias added once after it), Mixtral's experts over ``expert`` and their
    FFN columns over ``tensor``; embeddings, norms and the head stay whole,
    so every rank computes the same logits. Its KV pools hold its KV heads.
    Every rank is called with the same ``put`` / ``step`` / ``get`` /
    ``generate_all`` arguments, as the JAX engine's single controller is:
    the scheduler is host code and takes the same decisions on every rank.
    The tokens every rank commits are rank 0's: each sampled token (and
    each draft proposal and verify argmax) is broadcast from rank 0, so the
    streams are identical, with sampling too. The autotune winner cache
    resolves each key on rank 0 and shares its winner
    (``_RankZeroWinners``). The prefix cache, split-fuse, draft
    speculation (the draft sliced over the same topology) and KV host
    offload (each rank's pool of its own heads) run as on one rank; the
    KV handoff of a ``Replica`` / ``Router`` fleet does not (it raises)."""

    def __init__(self, model, config=None, device=None, monitor=None,
                 draft_model=None, topology=None, **kwargs):
        if isinstance(config, dict):
            config = RaggedInferenceEngineConfig(**{**config, **kwargs})
        elif config is None:
            config = RaggedInferenceEngineConfig(**kwargs)
        self.config = config
        self.telemetry = None
        if config.telemetry:
            self.telemetry = ServingTelemetry(
                monitor=monitor, interval=config.telemetry_interval)
        self.device = resolve_device(device)
        self.dtype = getattr(torch, config.dtype)
        self.topology = self._serving_topology(topology)
        self.multi_rank = self.topology is not None
        self._winners = _RankZeroWinners() if self.multi_rank else None
        # this rank's own picks and how many of them rank 0's replaced
        # (_agree, read by agreement())
        self._picks = 0
        self._overridden = torch.zeros((), dtype=torch.int64,
                                       device=self.device)
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
        if self.multi_rank:
            # the whole tree's quantization, then this rank's slice of it
            shard_model(model, self.topology)
        self.model = model.to_serving(self.device, self.dtype)
        model._weight_quant_fused = fused is not None
        self.draft_model = None
        # this engine's dispatch state and kernel knobs, installed now and
        # before each program runs (the knobs live on a model other engines
        # may share, the dispatch state in the process)
        self._install_trace_state()
        self.max_seq_len = model.config.max_seq_len

        BS = config.kv_block_size
        self.max_blocks_per_seq = -(-self.max_seq_len // BS)
        num_blocks = config.num_kv_blocks or (
            1 + config.max_batch_size * self.max_blocks_per_seq)
        self.state_mgr = DSStateManager(
            num_blocks=num_blocks, block_size=BS,
            max_batch=config.max_batch_size,
            max_blocks_per_seq=self.max_blocks_per_seq)

        # radix-tree prefix cache over the block pool (host-side policy:
        # the device programs do not change). The router's prefix-affinity
        # probe (Replica.prefix_score) reads it.
        self.prefix_cache = None
        pc_on, pc_min_match, pc_watermark = self._resolve_prefix_cache(
            model.config)
        if pc_on:
            self.prefix_cache = PrefixCache(
                self.state_mgr.allocator, BS,
                min_match_blocks=pc_min_match,
                max_blocks=config.prefix_cache_blocks,
                evict_watermark_pct=pc_watermark)
            self.state_mgr.prefix_cache = self.prefix_cache
            if self.telemetry is not None:
                self.telemetry.attach_prefix_cache(self.prefix_cache)

        self.kv_pool = None
        device_blocks = num_blocks
        if config.kv_host_offload:
            if config.device_kv_blocks < 2:
                raise ValueError(
                    "kv_host_offload requires device_kv_blocks >= 2")
            device_blocks = config.device_kv_blocks
            self.kv_pool = OffloadKVPool(model, num_blocks, device_blocks,
                                         BS, self.dtype, self.device)
        # offload decode dispatches by their number of groups
        self.offload_group_counts = Counter()
        self.cache = model.init_paged_cache(device_blocks, BS,
                                            dtype=self.dtype)

        # draft-model speculative decoding: the draft's own allocator and
        # KV pool over the same block geometry. With no draft model none of
        # this exists and the engine runs as without speculation.
        self._spec_k = 0
        self._spec_floor = 0.0
        self.draft_forward_counts = {"chunk": 0, "decode": 0}
        if config.spec_draft is True and draft_model is None:
            raise ValueError(
                "spec_draft=True requires a draft model (pass "
                "draft_model= to the engine)")
        if draft_model is not None and config.kv_host_offload:
            if config.spec_draft is True:
                raise ValueError(
                    "spec_draft=True is incompatible with "
                    "kv_host_offload: the draft pool has no offload "
                    "tier to keep residency honest — use one or the "
                    "other")
            draft_model = None            # "auto"/False resolve off
        if draft_model is not None:
            spec_on, spec_k, spec_floor = resolve_spec(
                config.spec_draft, config.spec_k, B=config.max_batch_size,
                NB=num_blocks, BS=BS, dtype=config.dtype, device=self.device)
            if spec_on:
                if draft_model.config.vocab_size != model.config.vocab_size:
                    raise ValueError(
                        f"draft/target vocab mismatch: "
                        f"{draft_model.config.vocab_size} vs "
                        f"{model.config.vocab_size} — speculation verifies "
                        f"draft token ids against target argmax, the "
                        f"vocabularies must be the same")
                if draft_model is not model:
                    if self.multi_rank:
                        shard_model(draft_model, self.topology)
                    draft_model.to_serving(self.device, self.dtype)
                    draft_model._weight_quant_fused = False
                self.draft_model = draft_model
                self._install_trace_state()     # now covers the draft
                self._spec_k = spec_k
                self._spec_floor = spec_floor
                self.state_mgr.draft_allocator = BlockedAllocator(
                    num_blocks)
                self.draft_cache = draft_model.init_paged_cache(
                    num_blocks, BS, dtype=self.dtype)

        self._pending = deque()
        self._results = {}            # uid -> generated tokens (finished)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(config.seed + 23)
        self._prefill_q = deque()     # uids mid-chunked-prefill (SplitFuse)
        # disaggregated prefill/decode: uids parked out of every decode
        # dispatch until their KV streams to a decode replica
        self._decode_hold = set()
        self._uid_next = 0
        self.forward_counts = {"prefill": 0, "chunk": 0, "decode": 0,
                               "verify": 0}
        log_dist(
            f"v2 engine ready: device={self.device} blocks="
            f"{num_blocks}x{BS} max_batch={config.max_batch_size}"
            + (f" device_kv_blocks={device_blocks}" if self.kv_pool
               else "")
            + (f" spec_k={self._spec_k}" if self.draft_model is not None
               else "")
            + (" prefix_cache" if self.prefix_cache is not None else ""),
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
        if self.kv_pool is not None \
                and mgr.blocks_needed(total) > self.kv_pool.D - 1:
            raise ValueError(
                f"request needs {mgr.blocks_needed(total)} KV blocks but "
                f"the device pool holds {self.kv_pool.D - 1} (+scratch); "
                "a single sequence's working set must fit on device — "
                "raise device_kv_blocks")
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
        requests are dropped; in-flight sequences are flushed through the
        prefix-cache-safe unref path (no tree insert: cache contents past
        the prefill frontier are unverified), their draft blocks and
        offload residency released; a finished-but-unfetched result is
        forgotten. Serving telemetry drops the request from its windows
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
        seq = self.state_mgr.get_sequence(uid)
        if seq.cow is not None:
            # admitted but the CoW slice copy never ran: drop the claim's
            # temporary source ref before the unref sweep
            self.state_mgr.cow_complete(seq)
        if self.kv_pool is not None:
            self.kv_pool.release(seq.blocks)
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
        self._refuse_multi_rank_handoff()
        if self.kv_pool is not None:
            raise RuntimeError(
                "KV handoff is incompatible with kv_host_offload: "
                "block payloads live in the host pool, not the device "
                "cache — run prefill-role replicas without offload")
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
            "cached_len": int(seq.cached_len),
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
        self._refuse_multi_rank_handoff()
        if self.kv_pool is not None:
            raise RuntimeError(
                "KV handoff is incompatible with kv_host_offload: "
                "imported blocks would bypass residency tracking — run "
                "decode-role replicas without offload")
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

    def _refuse_multi_rank_handoff(self):
        if self.multi_rank:
            raise NotImplementedError(
                f"the KV handoff of a multi-rank engine (each rank holds "
                f"its KV heads) is not ported yet {_TODO_REPLICAS}")

    def release_handoff(self, uid):
        """The decode side confirmed the import: drop the sequence here.
        ``retire`` inserts the verified prompt+first-token prefix into the
        local prefix cache (this replica's prefill wrote its KV) and
        releases blocks and slot; ``flush`` drops the descriptor without
        surfacing a result; telemetry forgets the request without counting
        a rejection and keeps its TTFT sample (the first token was produced
        here)."""
        self._decode_hold.discard(uid)
        self.state_mgr.retire(uid)
        self.state_mgr.flush(uid)
        if self.telemetry is not None:
            self.telemetry.on_handoff_out(uid)

    # ------------------------------------------------------------- programs
    def _serving_topology(self, topology):
        """The topology of a multi-rank engine (None on one rank): join the
        world (``comm.init_distributed``, a no-op once joined), then the
        caller's topology, which must be the one ``groups.initialize``
        installed (the comm layer and the MoE exchange read it), or one
        built from ``tensor_parallel`` / ``expert_parallel`` as the JAX
        engine builds its mesh (engine_v2.py:279-284)."""
        cfg = self.config
        if topology is None and cfg.tensor_parallel * cfg.expert_parallel \
                == 1:
            return None
        comm.init_distributed(device=self.device, verbose=False)
        if topology is None:
            topology = groups.initialize(groups.TopologyConfig(
                tensor_parallel_size=cfg.tensor_parallel,
                expert_parallel_size=cfg.expert_parallel))
        elif topology is not groups.get_topology():
            raise ValueError(
                "the engine's topology must be the one groups.initialize "
                "installed: the comm layer and the MoE exchange read it")
        for axis, want in (("tensor", cfg.tensor_parallel),
                           ("expert", cfg.expert_parallel)):
            if topology.axis_size(axis) != want:
                raise ValueError(
                    f"the topology's {axis} axis has "
                    f"{topology.axis_size(axis)} ranks, the config asks "
                    f"for {want}")
        return topology if topology.world_size > 1 else None

    def _agree(self, tokens):
        """Rank 0's tokens on every rank of a multi-rank engine (a
        broadcast over the world; ``tokens`` itself on one rank): every
        rank commits the same stream whatever its logits round to."""
        if not self.multi_rank:
            return tokens
        agreed = comm.broadcast(tokens, groups.MESH_AXES, 0)
        self._picks += tokens.numel()
        self._overridden += (agreed != tokens).sum()
        return agreed

    def agreement(self):
        """{"picks": the tokens this rank picked since the engine was
        built (one a batch slot each sample, draft proposal or verify
        argmax), "overridden": how many of them rank 0's broadcast
        replaced}: how far the ranks' logits (or their samplers) drift
        apart. 0 and 0 on one rank."""
        return {"picks": self._picks, "overridden": int(self._overridden)}

    def _resolve_prefix_cache(self, mcfg):
        """(enabled, min_match_blocks, evict_watermark_pct) of the prefix
        cache: off for a model with per-layer windows (GPT-Neo's
        ``attn_layer_windows``: True raises, "auto" resolves off, as the
        JAX engine refuses it, engine_v2.py:538-546), off when asked off
        or under KV host offload (True with offload raised in the config),
        else ``resolve_prefix_cache`` ("auto": the winner cache for the
        pool's bucket, the JAX cold defaults, off, on a miss). A
        ``sliding_window`` Llama is served as the JAX engine
        serves it: a cached block holds the KV of the same token prefix at
        the same absolute positions."""
        cfg = self.config
        if any(getattr(mcfg, "attn_layer_windows", ()) or ()):
            if cfg.prefix_cache is True:
                raise ValueError(
                    "prefix_cache=True on a sliding-window model "
                    "(attn_layer_windows set): a cached block's KV is "
                    "position-valid only inside each layer's window, so "
                    "reusing it under a shifted suffix serves wrong "
                    "attention — disable prefix_cache for this model")
            return False, 1, 0
        if cfg.prefix_cache is False or cfg.kv_host_offload:
            return False, 1, 0
        return resolve_prefix_cache(
            cfg.prefix_cache, cfg.prefix_cache_min_match,
            B=cfg.max_batch_size, NB=self.state_mgr.allocator.total_blocks + 1,
            BS=cfg.kv_block_size, dtype=cfg.dtype, device=self.device)

    def _install_trace_state(self):
        """(Re)apply THIS engine's kernel and autotune knobs: the process's
        dispatch state (``configure_serving``: "" = env / default; an
        earlier engine's explicit mode or cache path never leaks in) and
        the model attributes the paged programs read, the draft's too. At
        construction and before each program runs (JAX engine_v2.py:558-585
        does it in every program's trace), so engines sharing one model
        each dispatch under their own config; a no-op on the dispatch state
        when it is already installed."""
        from ...autotuning import kernel_dispatch
        cfg = self.config
        kernel_dispatch.configure_serving(mode=cfg.autotune_mode,
                                          cache_path=cfg.autotune_cache)
        kernel_dispatch.set_agreement(self._winners)
        for m in (self.model, self.draft_model):
            if m is not None:
                m.paged_kernel = cfg.paged_kernel
                m.paged_block_c = cfg.paged_block_c

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
        device (the caller's copy to the host is the dispatch's one
        sync)."""
        model = self.model
        tokens = self._dev(batch.tokens)
        lengths = self._dev(batch.lengths)
        tables = self._dev(batch.block_tables)
        temps = self._dev(batch.temps)
        top_ks = self._dev(batch.top_ks)
        toks = []
        self._install_trace_state()
        for _ in range(max(1, self.config.decode_steps_per_dispatch)):
            logits, self.cache = model.apply_paged_decode(
                tokens, lengths, self.cache, tables)
            self.forward_counts["decode"] += 1
            tokens = self._agree(self._sample_per_slot(
                logits, self._gen, temps, top_ks, all_greedy))
            lengths = lengths + 1
            toks.append(tokens)
        return torch.stack(toks)

    def _sample_one(self, logits, seq, all_greedy):
        return self._agree(self._sample_per_slot(
            logits, self._gen,
            torch.tensor([seq.temperature], dtype=torch.float32,
                         device=self.device),
            torch.tensor([seq.top_k], dtype=torch.int32, device=self.device),
            all_greedy))

    def _chunk_forward(self, seq, ids, tb, to, off, true_len, table,
                       all_greedy):
        """One chunk forward of ``seq`` -> its sampled token on the
        device."""
        self._install_trace_state()
        c_logits, self.cache = self.model.apply_paged_chunk(
            self._dev(ids), self.cache, self._dev(tb), self._dev(to), off,
            true_len, self._dev(table))
        self.forward_counts["chunk"] += 1
        return self._sample_one(c_logits, seq, all_greedy)

    def _apply_cow(self, seq):
        """Prefix-cache copy-on-write: copy the first ``plen`` token rows
        of block ``src`` into block ``dst`` in every layer's K and V pool
        (one slice copy a pool), queued on the compute stream ahead of the
        chunk that writes the rest of ``dst``, with no host sync. A shared
        block is never written in place: the sequence diverging inside it
        gets the matched slice in a fresh block, and prefill resumes
        there."""
        src, dst, plen = seq.cow
        with torch.inference_mode():
            for pools in self.cache.values():
                for p in pools:
                    p[dst, :, :plen].copy_(p[src, :, :plen])
        self.state_mgr.cow_complete(seq)   # drops the claim ref on src

    def _step_splitfuse_chunk(self):
        """Run one fused dispatch: the next chunk of the oldest
        prefilling sequence + n decode steps (chunk-only when nothing is
        decoding). Returns decode (uid, token) pairs. Prefix-cache hits
        ride this path even with SplitFuse off (the chunk's start offset
        skips the cached prefix); the chunk size then falls back to the
        prompt bucket."""
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

        if self.kv_pool is not None:
            # offload: a chunk-only dispatch over the resident history and
            # destination blocks, then the grouped decode keeps the running
            # sequences fed (the fused dispatch would need the union of
            # both working sets resident)
            live = seq.blocks[:mgr.blocks_needed(off + true_len)]
            # blocks from the chunk's first position on hold no earlier
            # tokens: this dispatch writes them, so slots but no upload
            first_fresh = -(-off // mgr.block_size)
            self.kv_pool.ensure(self.cache, live,
                                skip_upload=live[first_fresh:])
            dest = sorted({int(b) for b in tb[:true_len]})
            with torch.inference_mode():
                c_tok = self._chunk_forward(
                    seq, ids, self.kv_pool.translate(tb), to, off, true_len,
                    self.kv_pool.translate(table), seq.temperature == 0.0)
                c_tok = int(c_tok.cpu()[0])
            self.kv_pool.mark_dirty(dest)
            seq.prefill_offset = off + true_len
            if seq.prefill_offset >= len(seq.prompt):
                self._prefill_q.popleft()
                self._post_token(seq, c_tok)
            return self._step_offload_decode()

        batch = mgr.decode_batch(exclude=self._decode_hold)
        decoding = bool(batch.active.any())
        all_greedy = seq.temperature == 0.0 and not (
            decoding and bool(batch.temps.any()))
        with torch.inference_mode():
            c_tok = self._chunk_forward(seq, ids, tb, to, off, true_len,
                                        table, all_greedy)
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
            if not mgr.can_admit(len(req.prompt), req.max_new_tokens,
                                 prompt=req.prompt):
                break
            self._pending.popleft()
            slot, seq = mgr.admit(req.uid, req.prompt, req.max_new_tokens,
                                  req.eos_token_id,
                                  temperature=req.temperature,
                                  top_k=req.top_k)
            if seq.cow is not None:
                # partial-tail prefix hit: copy the matched slice into the
                # fresh block before any prefill touches it
                self._apply_cow(seq)
            if self.config.splitfuse_tokens or seq.cached_len:
                # SplitFuse: the prompt streams through chunk dispatches
                # interleaved with decodes — no bucketed prefill here.
                # Prefix-cache hits take the same path: the chunk's start
                # offset is what skips the cached prefix
                self._prefill_q.append(req.uid)
                continue
            T = len(req.prompt)
            T_pad = -(-max(T, 1) // bucket) * bucket
            ids = np.zeros((1, T_pad), np.int32)
            ids[0, :T] = req.prompt
            tb = np.zeros((T_pad,), np.int32)       # scratch for pads
            to = np.zeros((T_pad,), np.int32)
            tb[:T], to[:T] = mgr.token_placement(seq)
            prompt_blocks = seq.blocks[:mgr.blocks_needed(T)]
            if self.kv_pool is not None:
                # every prompt block is written whole by this dispatch:
                # slots only, no upload
                self.kv_pool.ensure(self.cache, prompt_blocks,
                                    skip_upload=prompt_blocks)
                tb = self.kv_pool.translate(tb)
            self._install_trace_state()
            with torch.inference_mode():
                logits, self.cache = self.model.apply_paged_prefill(
                    self._dev(ids), self.cache, self._dev(tb),
                    self._dev(to), T)
                self.forward_counts["prefill"] += 1
                tok = int(self._sample_one(logits, seq,
                                           seq.temperature == 0.0).cpu()[0])
            if self.kv_pool is not None:
                self.kv_pool.mark_dirty(prompt_blocks)
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
            if self.kv_pool is not None:
                # drop residency before the allocator recycles the ids
                self.kv_pool.release(seq.blocks)
            self.state_mgr.retire(seq.uid)
            self.state_mgr.flush(seq.uid)

    # ------------------------------------------------- KV host offload path
    def _seq_live_blocks(self, seq, n_steps=0):
        """Logical blocks a decode dispatch touches for ``seq``: the
        history it attends plus the tail blocks the next ``n_steps``
        writes land in."""
        last = seq.seen_tokens - 1 + max(0, n_steps - 1)
        hi = min(last // self.state_mgr.block_size, len(seq.blocks) - 1)
        return seq.blocks[:hi + 1]

    def _offload_decode_groups(self, batch, n_steps):
        """Greedy-pack active slots into dispatch groups whose combined
        working set fits the device pool."""
        mgr = self.state_mgr
        cap = self.kv_pool.D - 1
        groups = []
        cur, cur_blocks = [], set()
        for slot in np.nonzero(batch.active)[0]:
            seq = mgr.get_sequence(mgr._slots[slot])
            nb = set(self._seq_live_blocks(seq, n_steps))
            if cur and len(cur_blocks | nb) > cap:
                groups.append((cur, cur_blocks))
                cur, cur_blocks = [], set()
            cur.append(int(slot))
            cur_blocks |= nb
        if cur:
            groups.append((cur, cur_blocks))
        return groups

    def _step_offload_decode(self):
        """Grouped decode under KV host offload: each group's blocks are
        made device-resident (the next group's uploads staged on the side
        stream under the current group's decode), its tables translated
        to device slots, the other groups' slots masked (the decode keeps
        its fixed (max_batch, ...) shape), and its tail blocks marked
        dirty."""
        mgr = self.state_mgr
        pool = self.kv_pool
        n = max(1, self.config.decode_steps_per_dispatch)
        batch = mgr.decode_batch(exclude=self._decode_hold)
        if not batch.active.any():
            return []
        groups = self._offload_decode_groups(batch, n)
        self.offload_group_counts[len(groups)] += 1
        out = []
        prepared = pool.prepare(sorted(groups[0][1]))
        for gi, (slots_g, blocks_g) in enumerate(groups):
            pool.ensure(self.cache, sorted(blocks_g), prepared)
            prepared = (pool.prepare(sorted(groups[gi + 1][1]))
                        if gi + 1 < len(groups) else None)
            sub_active = np.zeros_like(batch.active)
            sub_active[slots_g] = batch.active[slots_g]
            tables = np.zeros_like(batch.block_tables)
            tokens = np.where(sub_active, batch.tokens, 0)
            lengths = np.where(sub_active, batch.lengths, 0)
            for s in slots_g:
                tables[s] = pool.translate(batch.block_tables[s])
            sub_batch = RaggedBatchWrapper(
                tokens=tokens, lengths=lengths, block_tables=tables,
                active=sub_active, temps=batch.temps, top_ks=batch.top_ks)
            with torch.inference_mode():
                toks = self._decode_steps(
                    sub_batch,
                    not bool(batch.temps[sub_active].any())).cpu().numpy()
            for s in slots_g:
                seq = mgr.get_sequence(mgr._slots[s])
                pool.mark_dirty(self._seq_live_blocks(seq, n)[
                    batch.lengths[s] // mgr.block_size:])
            out.extend(self._post_decode_tokens(sub_batch, toks))
        return out

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
        split-fuse chunk (fused with n decode steps) or a decode dispatch
        (grouped under offload; a speculative round for the sequences that
        speculate). Returns the (uid, token) decode pairs.

        A sequence that hits EOS or its budget mid-dispatch keeps decoding
        until the dispatch ends (its extra tokens are discarded; its
        writes land in its own tail slots or the scratch block)."""
        self._admit_pending()
        if self._prefill_q:
            return self._step_splitfuse_chunk()
        if self.state_mgr.n_active == 0:
            return []
        if self.kv_pool is not None:
            return self._step_offload_decode()
        if self.draft_model is not None:
            return self._step_spec_decode()
        return self._plain_decode()

    def _plain_decode(self, uids=None):
        """n fused decode steps over the given slots (all active slots but
        the held ones when ``uids`` is None)."""
        batch = self.state_mgr.decode_batch(uids, exclude=self._decode_hold)
        if not batch.active.any():
            return []
        with torch.inference_mode():
            toks = self._decode_steps(
                batch, not bool(batch.temps.any())).cpu().numpy()
        return self._post_decode_tokens(batch, toks)

    # ------------------------------------------------- speculative decoding
    def _spec_candidate(self, seq):
        """Greedy, not floor-latched, and far enough from its budget tail
        that a full k-token span stays inside the blocks allocated up
        front: tail sequences ride plain decode, so speculation never
        writes past a block table."""
        return (self.draft_model is not None and seq.spec_on
                and seq.temperature == 0.0
                and len(seq.prompt) + seq.max_new_tokens
                - seq.seen_tokens >= self._spec_k)

    @property
    def spec_pending(self):
        """True when the next step() would run a verify dispatch: the
        replica gates its ``serve_verify`` fault point on this."""
        if self.draft_model is None or self._prefill_q:
            return False
        mgr = self.state_mgr
        for uid in mgr._slots:
            if uid is None or uid in self._decode_hold:
                continue
            seq = mgr.get_sequence(uid)
            if seq.generated and self._spec_candidate(seq):
                return True
        return False

    def _step_spec_decode(self):
        """Partition the decoding slots into a SPEC set (greedy, latched
        on, the draft pool has room) and a PLAIN set. The spec set runs
        propose -> verify -> host acceptance; the plain set runs the plain
        decode dispatch, so low-acceptance traffic latches off per
        sequence and pays the plain-decode cost."""
        mgr = self.state_mgr
        spec, plain = [], []
        for uid in list(mgr._slots):
            if uid is None or uid in self._decode_hold:
                continue
            seq = mgr.get_sequence(uid)
            if not seq.generated:
                continue
            if not self._spec_candidate(seq):
                plain.append(uid)
                continue
            if not seq.draft_blocks and not mgr.alloc_draft(seq):
                plain.append(uid)     # draft pool full: plain decode
                continue
            while seq.draft_len < seq.seen_tokens - 2:
                self._draft_catchup(seq)
            spec.append(uid)
        out = []
        if spec:
            out.extend(self._spec_round(spec))
        if plain:
            out.extend(self._plain_decode(set(plain)))
        return out

    def _draft_catchup(self, seq):
        """Ingest one chunk of committed history into the draft's pool (the
        draft's prefill, through its chunk program): tokens [draft_len,
        seen-1) of prompt+generated, at their absolute positions in the
        sequence's draft blocks. It replays the real token history, so
        prompt tokens the prefix cache served (which the target never
        recomputed) are covered too. Logits are discarded."""
        mgr = self.state_mgr
        BS = mgr.block_size
        C = self.config.splitfuse_tokens or self.config.prompt_bucket
        hist = (seq.prompt if not seq.generated else np.concatenate(
            [seq.prompt, np.asarray(seq.generated, np.int32)]))
        off = seq.draft_len
        true_len = min(C, seq.seen_tokens - 1 - off)
        ids = np.zeros((1, C), np.int32)
        ids[0, :true_len] = hist[off:off + true_len]
        idx = np.arange(off, off + true_len)
        tb = np.zeros((C,), np.int32)
        to = np.zeros((C,), np.int32)
        tb[:true_len] = np.asarray(seq.draft_blocks, np.int32)[idx // BS]
        to[:true_len] = (idx % BS).astype(np.int32)
        table = np.zeros((self.max_blocks_per_seq,), np.int32)
        table[:len(seq.draft_blocks)] = seq.draft_blocks
        self._install_trace_state()
        with torch.inference_mode():
            _logits, self.draft_cache = self.draft_model.apply_paged_chunk(
                self._dev(ids), self.draft_cache, self._dev(tb),
                self._dev(to), off, true_len, self._dev(table))
        self.draft_forward_counts["chunk"] += 1
        seq.draft_len = off + true_len

    def _propose(self, pb):
        """A re-ingest step + ``spec_k`` greedy draft decode steps, each
        proposal feeding the next on the device. The re-ingest writes the
        second-to-last committed token's KV at its own position: after a
        fully accepted round that position holds nothing (the draft never
        saw its own last proposal fed back), after a partial round the
        rewrite is the same KV. Returns (B, k) proposals on the host."""
        draft = self.draft_model
        tokens2 = self._dev(pb.tokens)
        lengths = self._dev(pb.lengths)
        tables = self._dev(pb.block_tables)
        self._install_trace_state()
        with torch.inference_mode():
            _lg, self.draft_cache = draft.apply_paged_decode(
                tokens2[:, 0], lengths, self.draft_cache, tables)
            cur = tokens2[:, 1]
            lengths = lengths + 1
            props = []
            for _ in range(self._spec_k):
                logits, self.draft_cache = draft.apply_paged_decode(
                    cur, lengths, self.draft_cache, tables)
                # only greedy sequences speculate: the draft is greedy too
                cur = self._agree(logits.argmax(dim=-1).to(torch.int32))
                lengths = lengths + 1
                props.append(cur)
            out = torch.stack(props, dim=1).cpu().numpy()
        self.draft_forward_counts["decode"] += self._spec_k + 1
        return out

    def _verify(self, vb):
        """The target's greedy next token at all k+1 positions of every
        slot, in one ``apply_paged_verify`` pass (K5 per slot and layer, at
        C = k+1). -> (B, k+1) on the host."""
        self._install_trace_state()
        with torch.inference_mode():
            logits, self.cache = self.model.apply_paged_verify(
                self._dev(vb.tokens), vb.lengths, self.cache,
                self._dev(vb.block_tables))
            self.forward_counts["verify"] += 1
            return self._agree(logits.argmax(dim=-1).to(torch.int32)) \
                .cpu().numpy()

    def _spec_round(self, uids):
        """One propose / verify round for the spec set. Each sequence
        commits its accepted prefix plus the target's bonus token: every
        committed token is a target-argmax output, which keeps greedy
        streams identical to plain decode."""
        mgr, k = self.state_mgr, self._spec_k
        uid_set = set(uids)
        props = self._propose(mgr.propose_batch(uid_set))     # (B, k)
        proposals = {uid: props[slot]
                     for slot, uid in enumerate(mgr._slots)
                     if uid in uid_set}
        vb = mgr.verify_batch(proposals, k)
        for uid in uids:
            mgr.begin_spec(mgr.get_sequence(uid), proposals[uid])
        try:
            nxt = self._verify(vb)                            # (B, k+1)
        except BaseException:
            # an interrupted verify must not leave speculative tokens in
            # ``generated``: unwind before the failure propagates, or a
            # replica / router retry would replay corrupt state
            for uid in uids:
                mgr.rollback_spec(mgr.get_sequence(uid))
            raise
        out = []
        for slot, uid in enumerate(list(mgr._slots)):
            if uid is None or uid not in uid_set:
                continue
            seq = mgr.get_sequence(uid)
            mgr.rollback_spec(seq)
            pre_seen = seq.seen_tokens
            d, t = proposals[uid], nxt[slot]
            a = longest_accept(d, t)
            commit = [int(x) for x in d[:a]] + [int(t[a])]
            seq.spec_rounds += 1
            seq.spec_accepted += a
            frac = a / k
            seq.spec_ema = frac if seq.spec_ema is None else \
                (1 - SPEC_EMA_ALPHA) * seq.spec_ema + SPEC_EMA_ALPHA * frac
            if self.telemetry is not None:
                self.telemetry.on_spec_round(
                    uid, accepted=a, proposed=k, committed=len(commit))
            out.extend(self._post_tokens(seq, commit))
            if uid in self._results or uid not in mgr._seqs:
                continue                        # retired mid-span
            # the draft holds the committed history through seen-1 on a
            # partial round, seen-2 on a full one (its own last proposal
            # was never fed back; the re-ingest covers the gap)
            seq.draft_len = pre_seen + (a if a < k else k - 1)
            if seq.spec_rounds >= SPEC_MIN_ROUNDS \
                    and seq.spec_ema < self._spec_floor:
                # acceptance floor: latch plain decode for this sequence
                # and return its draft blocks
                seq.spec_on = False
                mgr.drop_draft(seq)
        return out

    def _post_tokens(self, seq, tokens):
        """Feed a committed span (accepted proposals + bonus) one token at
        a time: EOS or the budget retires mid-span and the tail is
        discarded, as ``_post_decode_tokens`` discards post-finish dispatch
        tokens. Returns the accepted (uid, token) pairs."""
        out = []
        uid = seq.uid
        for tok in tokens:
            if uid in self._results:
                break
            self._post_token(seq, tok)
            out.append((uid, tok))
        return out

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
