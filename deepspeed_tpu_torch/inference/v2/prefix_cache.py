"""Radix-tree prefix cache over the paged KV block pool.

Own copy of ``deepspeed_tpu/inference/v2/prefix_cache.py`` (host-side
bookkeeping, standard library only; the device only ever sees the block
ids it hands out). Serving traffic repeats itself (shared system prompts,
few-shot templates, multi-turn chat), and the KV a finished sequence
computed for its prompt+generation prefix is the KV any later request
with the same token prefix would recompute. So keep it: a token-keyed
radix tree whose nodes own *full* KV blocks (one node = one
``block_size``-token block, edge label = the block's token tuple), each
holding one reference in the :class:`BlockedAllocator`.

On admission the scheduler matches the new prompt against the tree
(block-granular longest prefix, plus a token-granular partial tail for
copy-on-write); matched blocks slot into the sequence's block table with
refcount bumps and chunked prefill starts after the cached length. Shared
blocks (refcount > 1) are never written in place: the one write that
could land in a shared block is the partial tail, and the engine copies
the matched slice into a fresh block on the device first (the CoW copy).
On release the finished prefix is inserted back; eviction is LRU over
zero-reference leaves and runs inside ``BlockedAllocator.allocate`` under
admission pressure, so "free" means free-or-evictable.

Invariants:
  * a match never exceeds ``len(prompt) - 1`` tokens: the last prompt
    token is always recomputed, so the first sampled token comes from a
    real forward, never from a cache lookup;
  * tree nodes hold exactly one allocator ref each; sequences add one ref
    per shared block; eviction only touches refcount-1 leaves, and an
    in-use path is pinned transitively (a matched child implies a matched,
    hence reffed, parent);
  * greedy decode is token-identical cache-on vs cache-off.

``"auto"`` resolves through the autotune winner cache (op
``prefix_cache``, the bucket ``ops/cuda/_common.prefix_cache_bucket``), falling
back to :data:`PREFIX_CACHE_DEFAULTS`, the JAX package's cold-cache
defaults, on a miss.
"""

from dataclasses import dataclass, field

# what "auto" resolves to on a cold winner cache: off, so an "auto" engine's
# admission path is the prefix_cache=False one until a measured search on
# the card proves the cache for its pool shape
PREFIX_CACHE_DEFAULTS = {
    "enabled": 0,
    "min_match_blocks": 1,
    "evict_watermark_pct": 0,     # 0 = evict on demand inside allocate
}


def resolve_prefix_cache(setting, min_match, B, NB, BS, dtype, device=None):
    """Resolve engine ``prefix_cache`` / ``prefix_cache_min_match``: "auto"
    consults the autotune winner cache for this pool-shape bucket (falling
    back to :data:`PREFIX_CACHE_DEFAULTS` on a miss); True/False and ints
    force. Returns (enabled, min_match_blocks, evict_watermark_pct)."""
    win = None
    if setting == "auto" or min_match == "auto":
        from ...ops.cuda._common import (dispatch, dtype_name,
                                         prefix_cache_bucket)
        win = dispatch("prefix_cache", prefix_cache_bucket(B, NB, BS),
                       dtype_name(dtype), dict(PREFIX_CACHE_DEFAULTS),
                       device=device)
    enabled = bool(win["enabled"]) if setting == "auto" else bool(setting)
    mm = int(win["min_match_blocks"]) if min_match == "auto" \
        else int(min_match)
    wm = int(win["evict_watermark_pct"]) if win is not None else 0
    return enabled, mm, wm


@dataclass
class PrefixMatch:
    """Result of matching one prompt against the tree.

    ``blocks`` are the fully-matched block ids in prompt order
    (``cached_len`` covers them plus the partial tail). When ``cow_src`` is
    set, the first ``cow_plen`` tokens of the next block also match an
    existing block: the admitter allocates a fresh destination block and
    device-copies that slice (the CoW path) before prefill resumes at
    ``cached_len``.
    """
    blocks: list = field(default_factory=list)
    nodes: list = field(default_factory=list)
    cached_len: int = 0
    cow_src: int = None        # block id to copy the tail slice from
    cow_plen: int = 0          # tokens of that block that match
    cow_node: object = None

    @property
    def hit(self):
        return self.cached_len > 0


class _Node:
    __slots__ = ("key", "block", "children", "parent", "last_used")

    def __init__(self, key, block, parent):
        self.key = key            # tuple of block_size token ints
        self.block = block        # KV block id (tree holds one ref)
        self.children = {}        # key tuple -> _Node
        self.parent = parent
        self.last_used = 0


class PrefixCache:
    """Host-side radix tree + eviction policy. Single-threaded like the
    scheduler that owns it."""

    def __init__(self, allocator, block_size, min_match_blocks=1,
                 max_blocks=0, evict_watermark_pct=0):
        self.allocator = allocator
        self.block_size = int(block_size)
        self.min_match_blocks = max(1, int(min_match_blocks))
        # 0 = bounded only by the pool; > 0 caps tree-held blocks
        self.max_blocks = max(0, int(max_blocks))
        # > 0: after each release, evict cold leaves until at least this
        # percentage of the pool is on the free list
        self.evict_watermark_pct = max(0, min(100, int(evict_watermark_pct)))
        self.root = _Node(key=None, block=None, parent=None)
        self.tree_blocks = 0
        self._clock = 0           # LRU tick (monotonic, deterministic)
        # counters (ServingTelemetry reads stats())
        self.lookups = 0
        self.hits = 0
        self.cached_tokens = 0
        self.evicted_blocks = 0
        self.cow_copies = 0
        self.inserted_blocks = 0
        allocator.set_evictor(self)

    # -------------------------------------------------------------- matching
    def _keys(self, tokens, n):
        BS = self.block_size
        return [tuple(int(t) for t in tokens[i * BS:(i + 1) * BS])
                for i in range(n)]

    def match(self, prompt):
        """Longest-prefix match of ``prompt`` (1-D int tokens) against the
        tree. Pure: no refs taken, no stats, no LRU updates, so admission
        probes (``can_admit``, the router's ``prefix_score``) may call it;
        the admit path makes it effective with :meth:`claim`."""
        BS = self.block_size
        T = len(prompt)
        m = PrefixMatch()
        if T < 2 or self.tree_blocks == 0:
            return m
        # full blocks matchable under the "last prompt token is always
        # recomputed" cap: block i is usable only if (i+1)*BS <= T-1
        node = self.root
        max_full = min(len(prompt) // BS, (T - 1) // BS)
        for key in self._keys(prompt, max_full):
            child = node.children.get(key)
            if child is None:
                break
            node = child
            m.nodes.append(child)
            m.blocks.append(child.block)
        k = len(m.blocks)
        if k < self.min_match_blocks:
            return PrefixMatch()
        m.cached_len = k * BS
        # token-granular partial tail: the next block may share a strict
        # prefix with an existing child (divergence mid-block, or a fully
        # cached prompt hitting the T-1 cap), matched via CoW
        max_plen = min(BS, T - 1 - m.cached_len)
        if max_plen > 0:
            rest = [int(t) for t in
                    prompt[m.cached_len:m.cached_len + BS]]
            best, best_plen = None, 0
            for key, child in node.children.items():
                plen = 0
                for a, b in zip(rest, key):
                    if a != b:
                        break
                    plen += 1
                if plen > best_plen:
                    best, best_plen = child, plen
            if best is not None:
                m.cow_node = best
                m.cow_src = best.block
                m.cow_plen = min(best_plen, max_plen)
                m.cached_len += m.cow_plen
        return m

    def claim(self, m):
        """Make a match effective for an admitted sequence: one allocator
        ref per matched block (pins them against eviction and marks them
        shared: nobody writes them in place), plus one on the CoW source
        until the device copy lands (:meth:`cow_release`). Also the
        stats/LRU point: called exactly once per admission, hit or miss."""
        self.lookups += 1
        if not m.hit:
            return
        self.hits += 1
        self.cached_tokens += m.cached_len
        self._clock += 1
        for node in m.nodes:
            self.allocator.ref(node.block)
            node.last_used = self._clock
        if m.cow_node is not None:
            self.allocator.ref(m.cow_node.block)
            m.cow_node.last_used = self._clock

    def cow_release(self, block):
        """Drop the claim ref on a CoW source once the slice copy is
        issued (the copy made the fresh block self-contained)."""
        self.allocator.unref(block)
        self.cow_copies += 1

    # ------------------------------------------------------------- insertion
    def insert(self, tokens, blocks):
        """Walk/extend the tree with the full blocks of ``tokens`` backed
        by the sequence's ``blocks``. Existing nodes are reused (the
        sequence's duplicate block is not adopted and dies with the
        caller's unref); new nodes take one allocator ref. Partial tail
        blocks are never inserted: tree nodes are always full."""
        self._clock += 1
        node = self.root
        nfull = len(tokens) // self.block_size
        for i, key in enumerate(self._keys(tokens, nfull)):
            child = node.children.get(key)
            if child is None:
                if self.max_blocks and self.tree_blocks >= self.max_blocks:
                    self.evict(1 + self.tree_blocks - self.max_blocks)
                    if self.tree_blocks >= self.max_blocks:
                        break     # everything left is in use; stop here
                b = blocks[i]
                self.allocator.ref(b)
                child = _Node(key=key, block=b, parent=node)
                node.children[key] = child
                self.tree_blocks += 1
                self.inserted_blocks += 1
            node = child
            node.last_used = self._clock
        return node

    def release(self, tokens, blocks):
        """Sequence release: insert the finished prompt+generation prefix,
        then drop the sequence's own reference on every block exactly once
        (tree-adopted blocks live on at refcount >= 1; unshared tails
        return to the free list)."""
        if len(blocks) > 0:
            self.insert(tokens, blocks)
        for b in blocks:
            self.allocator.unref(b)
        if self.evict_watermark_pct:
            want = (self.allocator.total_blocks
                    * self.evict_watermark_pct) // 100
            if self.allocator.free_blocks < want:
                self.evict(want - self.allocator.free_blocks)

    # -------------------------------------------------------------- eviction
    def _walk(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    @property
    def evictable_blocks(self):
        """Blocks reclaimable under pressure: tree nodes nobody but the
        tree references (closed downward: a reffed child implies a reffed
        parent, so repeated leaf eviction reaches all of them)."""
        return sum(1 for n in self._walk()
                   if self.allocator.refcount(n.block) == 1)

    def evict(self, n):
        """LRU eviction of zero-ref leaves until ``n`` blocks are freed or
        nothing evictable remains. Returns blocks freed. Called by
        ``BlockedAllocator.allocate`` under admission pressure and by the
        watermark policy."""
        freed = 0
        while freed < n:
            best = None
            for cand in self._walk():
                if cand.children \
                        or self.allocator.refcount(cand.block) != 1:
                    continue
                if best is None or cand.last_used < best.last_used:
                    best = cand
            if best is None:
                break
            del best.parent.children[best.key]
            self.allocator.unref(best.block)
            self.tree_blocks -= 1
            self.evicted_blocks += 1
            freed += 1
        return freed

    # ------------------------------------------------------------- telemetry
    def stats(self):
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate_pct": round(100.0 * self.hits / self.lookups, 2)
            if self.lookups else 0.0,
            "cached_tokens": self.cached_tokens,
            "tree_blocks": self.tree_blocks,
            "inserted_blocks": self.inserted_blocks,
            "evicted_blocks": self.evicted_blocks,
            "cow_copies": self.cow_copies,
        }
