"""Ragged-batch state management for the v2 serving engine.

Own copy of ``deepspeed_tpu/inference/v2/ragged.py`` without the
speculation and prefix-cache branches:
  * ``DSSequenceDescriptor`` — one live sequence: tokens seen, KV blocks
    held, generation state.
  * ``RaggedBatchWrapper`` — the fixed-shape metadata for one engine step
    (token ids, lengths, block tables) as host numpy arrays; the engine
    uploads them to the device.
  * ``DSStateManager`` — owns the allocator and the id -> descriptor map,
    builds a RaggedBatchWrapper for each step.

``prefix_cache`` and ``draft_allocator`` stay None; the methods that
would use them raise ``NotImplementedError`` naming the ROADMAP item.
"""

from dataclasses import dataclass, field

import numpy as np

from .blocked_allocator import BlockedAllocator

_PREFIX_CACHE_TODO = ("prefix cache is not ported yet "
                      "(ROADMAP Queue 1, serving: prefix cache)")
_SPEC_TODO = ("speculative decoding is not ported yet "
              "(ROADMAP Queue 1, serving: speculative decoding)")


@dataclass
class DSSequenceDescriptor:
    uid: int
    prompt: np.ndarray                    # (T,) int32
    max_new_tokens: int
    eos_token_id: int = -1
    temperature: float = 0.0              # per-request sampling params
    top_k: int = 0
    blocks: list = field(default_factory=list)
    generated: list = field(default_factory=list)
    done: bool = False
    # Dynamic SplitFuse: prompt tokens already written to the cache; a
    # sequence decodes only once the whole prompt is in
    prefill_offset: int = 0

    @property
    def seen_tokens(self):
        return len(self.prompt) + len(self.generated)


@dataclass
class RaggedBatchWrapper:
    """Fixed-shape step metadata (B = engine max_batch)."""
    tokens: np.ndarray        # (B,) int32 — next input token per slot
    lengths: np.ndarray       # (B,) int32 — tokens already in cache
    block_tables: np.ndarray  # (B, MB) int32 — scratch-0 padded
    active: np.ndarray        # (B,) bool
    temps: np.ndarray = None  # (B,) f32 — per-slot temperature (0=greedy)
    top_ks: np.ndarray = None  # (B,) int32 — per-slot top-k (0=off)


class DSStateManager:
    def __init__(self, num_blocks, block_size, max_batch, max_blocks_per_seq):
        self.allocator = BlockedAllocator(num_blocks)
        self.block_size = block_size
        self.max_batch = max_batch
        self.max_blocks_per_seq = max_blocks_per_seq
        self._seqs = {}                  # uid -> descriptor
        self._slots = [None] * max_batch  # batch slot -> uid
        self.prefix_cache = None
        self.draft_allocator = None

    # ------------------------------------------------------------- tracking
    @property
    def n_active(self):
        return sum(s is not None for s in self._slots)

    @property
    def free_slots(self):
        """Open batch slots: the router's cheap per-replica load probe
        (can_admit answers "this request now"; this answers "how
        loaded")."""
        return sum(s is None for s in self._slots)

    def get_sequence(self, uid):
        return self._seqs[uid]

    def free_slot(self):
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def blocks_needed(self, n_tokens):
        return -(-n_tokens // self.block_size)

    def can_admit(self, prompt_len, max_new, prompt=None):
        """Whether a request fits a slot and the pool now. ``prompt`` is
        the JAX signature's prefix-cache probe; without a prefix cache it
        changes nothing."""
        total = prompt_len + max_new
        if total > self.max_blocks_per_seq * self.block_size:
            return False  # can never fit; admit() would raise
        if self.free_slot() is None:
            return False
        return self.allocator.free_blocks >= self.blocks_needed(total)

    def admit(self, uid, prompt, max_new_tokens, eos_token_id=-1,
              temperature=0.0, top_k=0):
        """Allocate blocks for the full prompt+generation budget and bind
        the sequence to a batch slot. Returns (slot, descriptor)."""
        slot = self.free_slot()
        assert slot is not None, "no free batch slot"
        prompt = np.asarray(prompt, np.int32)
        total = len(prompt) + max_new_tokens
        cap = self.max_blocks_per_seq * self.block_size
        if total > cap:
            raise ValueError(f"prompt+max_new={total} exceeds per-sequence "
                             f"KV capacity {cap}")
        seq = DSSequenceDescriptor(uid=uid, prompt=prompt,
                                   max_new_tokens=max_new_tokens,
                                   eos_token_id=eos_token_id,
                                   temperature=temperature, top_k=top_k)
        seq.blocks = self.allocator.allocate(self.blocks_needed(total))
        self._seqs[uid] = seq
        self._slots[slot] = uid
        return slot, seq

    def admit_imported(self, uid, prompt, generated, max_new_tokens,
                       blocks, eos_token_id=-1, temperature=0.0,
                       top_k=0):
        """Bind a handed-off sequence (disaggregated prefill/decode): its
        prompt's KV was prefilled on another replica and has just landed
        in ``blocks``, allocated from this pool and whole-owned, so the
        descriptor enters the decode batch directly: ``prefill_offset``
        covers the whole prompt and ``generated`` already holds the first
        token the prefill side produced. Returns (slot, descriptor)."""
        slot = self.free_slot()
        assert slot is not None, "no free batch slot"
        assert uid not in self._seqs, f"uid {uid} already live here"
        seq = DSSequenceDescriptor(
            uid=uid, prompt=np.asarray(prompt, np.int32),
            max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
            temperature=temperature, top_k=top_k)
        seq.blocks = list(blocks)
        seq.generated = [int(t) for t in generated]
        seq.prefill_offset = len(seq.prompt)
        self._seqs[uid] = seq
        self._slots[slot] = uid
        return slot, seq

    def cow_complete(self, seq):
        raise NotImplementedError(_PREFIX_CACHE_TODO)

    def retire(self, uid):
        """Release the sequence's blocks and slot; keep the descriptor
        (the caller reads .generated) until ``flush``."""
        seq = self._seqs[uid]
        self.allocator.free(seq.blocks)
        seq.blocks = []
        seq.done = True
        self._slots[self._slots.index(uid)] = None

    def flush(self, uid):
        seq = self._seqs.pop(uid)
        if seq.blocks:
            self.allocator.free(seq.blocks)
            if self._slots.count(uid):
                self._slots[self._slots.index(uid)] = None

    # ------------------------------------------------------- speculation
    def alloc_draft(self, seq):
        raise NotImplementedError(_SPEC_TODO)

    def drop_draft(self, seq):
        raise NotImplementedError(_SPEC_TODO)

    def begin_spec(self, seq, proposals):
        raise NotImplementedError(_SPEC_TODO)

    def rollback_spec(self, seq, keep=0):
        raise NotImplementedError(_SPEC_TODO)

    def propose_batch(self, uids):
        raise NotImplementedError(_SPEC_TODO)

    def verify_batch(self, proposals, k):
        raise NotImplementedError(_SPEC_TODO)

    # ---------------------------------------------------------- step builds
    def token_placement(self, seq):
        """(token_blocks, token_offsets) for prefilling ``seq``'s prompt
        (the caller pads; pad positions map to the scratch block)."""
        T = len(seq.prompt)
        idx = np.arange(T)
        blocks = np.asarray(seq.blocks, np.int32)[idx // self.block_size]
        offs = (idx % self.block_size).astype(np.int32)
        return blocks, offs

    def decode_batch(self, uids=None, exclude=None):
        """RaggedBatchWrapper for one decode step over all active slots.
        ``exclude``: uids parked out of decode entirely (a prefill-role
        replica holds finished prefills there until their KV handoff
        lands on a decode replica). ``uids`` (a subset, the speculative
        scheduler's split) raises until speculative decoding lands."""
        if uids is not None:
            raise NotImplementedError(_SPEC_TODO)
        B, MB = self.max_batch, self.max_blocks_per_seq
        tokens = np.zeros((B,), np.int32)
        lengths = np.zeros((B,), np.int32)
        tables = np.zeros((B, MB), np.int32)   # scratch
        active = np.zeros((B,), bool)
        temps = np.zeros((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        for slot, uid in enumerate(self._slots):
            if uid is None or (exclude is not None and uid in exclude):
                continue
            seq = self._seqs[uid]
            if not seq.generated:
                # still prefilling (SplitFuse chunks in flight)
                continue
            active[slot] = True
            temps[slot] = seq.temperature
            top_ks[slot] = seq.top_k
            # input token = last generated; not yet in the cache, so its
            # write position is seen_tokens - 1
            tokens[slot] = seq.generated[-1]
            lengths[slot] = seq.seen_tokens - 1
            nb = len(seq.blocks)
            tables[slot, :nb] = seq.blocks
        return RaggedBatchWrapper(tokens=tokens, lengths=lengths,
                                  block_tables=tables, active=active,
                                  temps=temps, top_ks=top_ks)
