"""Ragged-batch state management for the v2 serving engine.

Own copy of ``deepspeed_tpu/inference/v2/ragged.py`` (host-side
bookkeeping; the engine uploads the arrays it builds):
  * ``DSSequenceDescriptor`` — one live sequence: tokens seen, KV blocks
    held, generation state, its prefix-cache claim and its speculation
    state.
  * ``RaggedBatchWrapper`` — the fixed-shape metadata for one engine step
    (token ids, lengths, block tables) as host numpy arrays.
  * ``DSStateManager`` — owns the allocator and the id -> descriptor map,
    builds a RaggedBatchWrapper for each step (decode, the draft's
    propose, the target's verify), claims and releases prefix-cache
    blocks, and holds each speculating sequence's draft-pool blocks.
"""

from dataclasses import dataclass, field

import numpy as np

from .blocked_allocator import BlockedAllocator


@dataclass
class DSSequenceDescriptor:
    uid: int
    prompt: np.ndarray                    # (T,) int32
    max_new_tokens: int
    eos_token_id: int = -1
    temperature: float = 0.0              # per-request sampling params
    top_k: int = 0                        # (FastGen per-request config)
    blocks: list = field(default_factory=list)
    generated: list = field(default_factory=list)
    done: bool = False
    # Dynamic SplitFuse: prompt tokens already written to the cache; a
    # sequence decodes only once the whole prompt is in (the legacy
    # bucketed prefill writes it all at once)
    prefill_offset: int = 0
    # Prefix cache: leading prompt tokens whose KV came from the radix
    # tree (prefill_offset starts here — those tokens are never
    # recomputed); ``cow`` = (src_block, dst_block, plen) when the
    # matched tail is partial and the engine owes a device-side
    # copy-on-write of the first plen tokens before prefill resumes
    cached_len: int = 0
    cow: tuple = None
    # Speculative decoding (draft-model propose + batched verify):
    # ``spec_on`` is the per-sequence eligibility latch — the engine
    # clears it permanently when the acceptance EMA falls below the
    # floor or the draft pool cannot hold the sequence, and the
    # sequence rides plain decode from then on. ``draft_blocks`` is the
    # sequence's slice of the DRAFT allocator (always whole-owned: the
    # draft cache never feeds the prefix cache, so rollback/free is a
    # strict free). ``draft_len`` counts COMMITTED tokens whose KV the
    # draft cache holds (positions 0..draft_len-1); the propose
    # program's re-ingest step covers a one-token gap, so the sequence
    # is spec-eligible while draft_len >= seen_tokens - 2.
    # ``spec_inflight`` brackets a proposal span tentatively appended
    # to ``generated`` between begin_spec and rollback_spec.
    spec_on: bool = True
    spec_inflight: int = 0
    draft_blocks: list = field(default_factory=list)
    draft_len: int = 0
    spec_ema: float = None
    spec_rounds: int = 0
    spec_accepted: int = 0

    @property
    def seen_tokens(self):
        return len(self.prompt) + len(self.generated)

    def cur_allocated_capacity(self, block_size):
        return len(self.blocks) * block_size


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
        # engine-attached radix tree (prefix_cache.py); when set, admit
        # matches prompts against it and retire inserts finished
        # prefixes back — all block lifetimes then run through
        # refcounts (unref) instead of strict whole-ownership free()
        self.prefix_cache = None
        # engine-attached DRAFT-pool allocator (speculative decoding):
        # when set, retire/flush also release each sequence's
        # draft_blocks so no exit path (EOS, cancel, deadline
        # withdrawal mid-speculation) can leak draft blocks
        self.draft_allocator = None

    # ------------------------------------------------------------- tracking
    @property
    def n_active(self):
        return sum(s is not None for s in self._slots)

    @property
    def free_slots(self):
        """Open batch slots — the router's cheap per-replica load
        probe (can_admit answers "this request now"; this answers
        "how loaded")."""
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
        total = prompt_len + max_new
        if total > self.max_blocks_per_seq * self.block_size:
            return False  # can never fit; admit() would raise
        if self.free_slot() is None:
            return False
        needed = self.blocks_needed(total)
        avail = self.allocator.free_blocks
        if self.prefix_cache is not None:
            if prompt is not None:
                # matched blocks are reused, not allocated; the rest of
                # the pool counts free-or-evictable, minus the match
                # itself (its blocks may be the evictable ones, and
                # claiming pins them)
                k = len(self.prefix_cache.match(prompt).blocks)
                needed -= k
                avail += max(
                    0, self.prefix_cache.evictable_blocks - k)
            else:
                avail = self.allocator.available_blocks
        return avail >= needed

    def admit(self, uid, prompt, max_new_tokens, eos_token_id=-1,
              temperature=0.0, top_k=0):
        """Allocate blocks for the full prompt+generation budget and bind
        the sequence to a batch slot. With a prefix cache attached, the
        prompt's longest cached prefix is claimed first (refcount bumps,
        no allocation) and only the remainder is allocated; prefill then
        starts at ``cached_len``. Returns (slot, descriptor)."""
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
        m = None
        if self.prefix_cache is not None:
            m = self.prefix_cache.match(prompt)
            self.prefix_cache.claim(m)   # refs matched blocks + stats
        if m is not None and m.hit:
            k = len(m.blocks)
            fresh = self.allocator.allocate(self.blocks_needed(total) - k)
            seq.blocks = list(m.blocks) + fresh
            seq.cached_len = m.cached_len
            seq.prefill_offset = m.cached_len
            if m.cow_src is not None:
                # the partial tail lands in the first fresh block; the
                # engine copies the matched slice there on device
                seq.cow = (m.cow_src, seq.blocks[k], m.cow_plen)
        else:
            seq.blocks = self.allocator.allocate(self.blocks_needed(total))
        self._seqs[uid] = seq
        self._slots[slot] = uid
        return slot, seq

    def admit_imported(self, uid, prompt, generated, max_new_tokens,
                       blocks, eos_token_id=-1, temperature=0.0,
                       top_k=0):
        """Bind a handed-off sequence (disaggregated prefill/decode):
        the prompt's KV was prefilled on ANOTHER replica and just
        landed in ``blocks`` — allocated from THIS pool's allocator and
        whole-owned (refcount 1) — so the descriptor enters the decode
        batch directly: ``prefill_offset`` covers the full prompt and
        ``generated`` already holds the first token produced by the
        prefill side. ``cached_len`` stays 0: the blocks were imported,
        not claimed from this replica's radix tree (retire will insert
        the verified prefix into the local tree like any other
        sequence). Returns (slot, descriptor)."""
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
        """The engine's device-side CoW slice copy landed: drop the
        claim's temporary ref on the source block."""
        src, _dst, _plen = seq.cow
        self.prefix_cache.cow_release(src)
        seq.cow = None

    def retire(self, uid):
        """Release the sequence's blocks and slot; keep the descriptor
        (the caller reads .generated) until ``flush``. With a prefix
        cache, the finished prompt+generation prefix is inserted into
        the tree and every block is unreffed exactly once (tree-adopted
        blocks live on; the rest return to the free list). generated[-1]
        is excluded from the insert: the final sampled token's KV write
        may not have landed (it is written — if at all — by the
        dispatch's over-decode)."""
        seq = self._seqs[uid]
        if self.prefix_cache is not None:
            tokens = seq.prompt if not seq.generated else np.concatenate(
                [seq.prompt, np.asarray(seq.generated[:-1], np.int32)])
            self.prefix_cache.release(tokens, seq.blocks)
        else:
            self.allocator.free(seq.blocks)
        seq.blocks = []
        self.drop_draft(seq)
        seq.done = True
        self._slots[self._slots.index(uid)] = None

    def flush(self, uid):
        seq = self._seqs.pop(uid)
        self.drop_draft(seq)
        if seq.blocks:
            if self.prefix_cache is not None:
                # cancelled mid-flight: cache contents past the prefill
                # frontier are unverified — drop refs without inserting
                for b in seq.blocks:
                    self.allocator.unref(b)
            else:
                self.allocator.free(seq.blocks)
            if self._slots.count(uid):
                self._slots[self._slots.index(uid)] = None

    # ------------------------------------------------------- speculation
    def alloc_draft(self, seq):
        """Reserve the sequence's DRAFT-pool blocks (same block count as
        its target budget — the draft cache mirrors the sequence's
        position range). Returns False (and latches ``spec_on`` off)
        when the draft pool cannot hold it; the sequence then rides
        plain decode, it is never an admission failure."""
        if self.draft_allocator is None or not seq.spec_on:
            return False
        needed = len(seq.blocks)
        if self.draft_allocator.free_blocks < needed:
            seq.spec_on = False
            return False
        seq.draft_blocks = self.draft_allocator.allocate(needed)
        return True

    def drop_draft(self, seq):
        """Return the sequence's draft blocks (fallback latch, retire,
        cancel — every path that ends speculation frees here, so the
        draft allocator closes at zero leaked blocks)."""
        if seq.draft_blocks:
            self.draft_allocator.free(seq.draft_blocks)
            seq.draft_blocks = []

    def begin_spec(self, seq, proposals):
        """Tentatively append the draft's proposals: ``seen_tokens``
        includes the in-flight span for the duration of the verify
        dispatch, and ``rollback_spec`` unwinds it. Target/prefix-cache
        block state is deliberately untouched — rollback must never
        disturb refcounts (the sequence's blocks cover its full budget
        up-front, so a speculative span never allocates)."""
        assert seq.spec_inflight == 0, "nested speculation span"
        seq.generated.extend(int(t) for t in proposals)
        seq.spec_inflight = len(proposals)

    def rollback_spec(self, seq, keep=0):
        """Unwind the in-flight span down to its first ``keep`` accepted
        tokens: rejected tokens leave ``generated``/``seen_tokens``, and
        the cache positions they wrote are now past the committed
        frontier — masked dead by every attention path and overwritten
        when real tokens land there. Returns the number unwound."""
        drop = seq.spec_inflight - keep
        assert drop >= 0
        if drop:
            del seq.generated[-drop:]
        seq.spec_inflight = 0
        return drop

    # ---------------------------------------------------------- step builds
    def token_placement(self, seq):
        """(token_blocks, token_offsets) for prefilling ``seq``'s prompt
        padded to T_pad (caller pads); positions past the prompt map to the
        scratch block."""
        T = len(seq.prompt)
        idx = np.arange(T)
        blocks = np.asarray(seq.blocks, np.int32)[idx // self.block_size]
        offs = (idx % self.block_size).astype(np.int32)
        return blocks, offs

    def decode_batch(self, uids=None, exclude=None):
        """RaggedBatchWrapper for one decode step over all active slots.
        ``uids``: optional subset — the speculative scheduler splits a
        step into a spec set and a plain set, and the plain set's decode
        dispatch must carry only its own slots. ``exclude``: uids parked
        out of decode entirely — a prefill-role replica holds finished
        prefills here until their KV handoff lands on a decode replica."""
        B, MB = self.max_batch, self.max_blocks_per_seq
        tokens = np.zeros((B,), np.int32)
        lengths = np.zeros((B,), np.int32)
        tables = np.zeros((B, MB), np.int32)   # scratch
        active = np.zeros((B,), bool)
        temps = np.zeros((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        for slot, uid in enumerate(self._slots):
            if uid is None or (uids is not None and uid not in uids) \
                    or (exclude is not None and uid in exclude):
                continue
            seq = self._seqs[uid]
            if not seq.generated:
                # still prefilling (SplitFuse chunks in flight): no
                # first token yet, nothing to decode
                continue
            active[slot] = True
            temps[slot] = seq.temperature
            top_ks[slot] = seq.top_k
            # input token = last generated (prefill produced the first);
            # it is not yet in the cache, so its write position is
            # seen_tokens - 1
            tokens[slot] = seq.generated[-1]
            lengths[slot] = seq.seen_tokens - 1
            nb = len(seq.blocks)
            tables[slot, :nb] = seq.blocks
        return RaggedBatchWrapper(tokens=tokens, lengths=lengths,
                                  block_tables=tables, active=active,
                                  temps=temps, top_ks=top_ks)

    def propose_batch(self, uids):
        """Draft-side metadata for one propose dispatch over the spec
        set: tokens (B, 2) = [re-ingest token (position seen-2), start
        token (position seen-1)], lengths (B,) = seen_tokens - 2, block
        tables over the DRAFT pool. The re-ingest token erases the
        draft's one-token catch-up gap: after a fully-accepted round
        the draft never saw its own last proposal's KV, and after a
        partial round the rewrite is byte-idempotent — so eligibility
        never needs per-sequence gap bookkeeping beyond draft_len."""
        B, MB = self.max_batch, self.max_blocks_per_seq
        tokens = np.zeros((B, 2), np.int32)
        lengths = np.zeros((B,), np.int32)
        tables = np.zeros((B, MB), np.int32)
        active = np.zeros((B,), bool)
        for slot, uid in enumerate(self._slots):
            if uid is None or uid not in uids:
                continue
            seq = self._seqs[uid]
            hist = (seq.prompt[-1] if len(seq.generated) < 2
                    else seq.generated[-2])
            tokens[slot] = (int(hist), int(seq.generated[-1]))
            lengths[slot] = seq.seen_tokens - 2
            nb = len(seq.draft_blocks)
            tables[slot, :nb] = seq.draft_blocks
        return RaggedBatchWrapper(tokens=tokens, lengths=lengths,
                                  block_tables=tables, active=active)

    def verify_batch(self, proposals, k):
        """Target-side metadata for one verify dispatch: tokens
        (B, k+1) = [last committed token, then the k proposals],
        lengths (B,) = seen_tokens - 1 (the first input token's write
        position, exactly the plain-decode contract), target block
        tables. ``proposals``: {uid: [k draft tokens]}. Build this
        BEFORE begin_spec — the last committed token must not be a
        proposal."""
        B, MB = self.max_batch, self.max_blocks_per_seq
        tokens = np.zeros((B, k + 1), np.int32)
        lengths = np.zeros((B,), np.int32)
        tables = np.zeros((B, MB), np.int32)
        active = np.zeros((B,), bool)
        for slot, uid in enumerate(self._slots):
            if uid is None or uid not in proposals:
                continue
            seq = self._seqs[uid]
            assert seq.spec_inflight == 0, \
                "verify_batch must precede begin_spec"
            active[slot] = True
            tokens[slot, 0] = seq.generated[-1]
            tokens[slot, 1:] = proposals[uid]
            lengths[slot] = seq.seen_tokens - 1
            nb = len(seq.blocks)
            tables[slot, :nb] = seq.blocks
        return RaggedBatchWrapper(tokens=tokens, lengths=lengths,
                                  block_tables=tables, active=active)
