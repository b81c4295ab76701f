"""KV-block allocator: free list + per-block reference counts.

Own copy of ``deepspeed_tpu/inference/v2/blocked_allocator.py`` (host-side
bookkeeping; the device only ever sees block-id tensors).

Block 0 is RESERVED as the scratch block: pad tokens, inactive batch slots
and decode writes past a sequence's table land there, so the allocator
never hands it out.

Reference counting: ``allocate`` hands out blocks at refcount 1; ``ref`` /
``unref`` take and drop extra references (the block returns to the free
list at zero); :meth:`free` is the strict whole-ownership release and
raises on double-free and on free-while-referenced. The evictor hook
is the prefix cache (``prefix_cache.PrefixCache`` registers itself): under
pressure ``allocate`` evicts its cold leaves, so admission counts
free-or-evictable blocks.
"""


class BlockedAllocator:
    SCRATCH = 0

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (1 scratch + 1 usable)")
        self._num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))  # pop() -> block 1
        self._refs = {}        # block id -> refcount (allocated blocks only)
        self._evictor = None   # .evictable_blocks / .evict(n) (prefix cache)

    @property
    def total_blocks(self):
        return self._num_blocks - 1  # scratch excluded

    @property
    def free_blocks(self):
        return len(self._free)

    @property
    def available_blocks(self):
        """Free-or-evictable: what admission control may count on."""
        n = len(self._free)
        if self._evictor is not None:
            n += self._evictor.evictable_blocks
        return n

    def set_evictor(self, evictor):
        """Register the reclaim hook (``evictable_blocks`` property +
        ``evict(n) -> freed``); None detaches."""
        self._evictor = evictor

    def refcount(self, block):
        """Current refcount (0 = free / never allocated)."""
        return self._refs.get(block, 0)

    def allocate(self, n: int):
        """-> list of n block ids at refcount 1; evicts from the
        registered evictor under pressure; raises if still short."""
        if n > len(self._free) and self._evictor is not None:
            self._evictor.evict(n - len(self._free))
        if n > len(self._free):
            raise RuntimeError(
                f"out of KV blocks: want {n}, have {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def ref(self, block):
        """Take an additional reference on an allocated block."""
        if block not in self._refs:
            raise ValueError(
                f"ref of block {block} that is not allocated")
        self._refs[block] += 1

    def unref(self, block):
        """Drop one reference; the block returns to the free list at
        zero. Returns True if this call freed it."""
        c = self._refs.get(block)
        if c is None:
            raise ValueError(
                f"unref of block {block} that holds no references "
                f"(double-free)")
        if c == 1:
            del self._refs[block]
            self._free.append(block)
            return True
        self._refs[block] = c - 1
        return False

    def free(self, blocks):
        """Strict whole-ownership release: every block must be allocated
        exactly once (refcount 1). Validates the entire list before
        mutating anything, so a bad id never half-applies."""
        seen = set()
        for b in blocks:
            if b == self.SCRATCH:
                raise ValueError("cannot free the scratch block")
            if b in seen or not (0 < b < self._num_blocks) \
                    or b not in self._refs:
                raise ValueError(f"double-free / bad block {b}")
            if self._refs[b] > 1:
                raise ValueError(
                    f"free of block {b} with refcount {self._refs[b]} — "
                    f"still referenced (shared prefix block? unref "
                    f"instead)")
            seen.add(b)
        for b in blocks:
            del self._refs[b]
        self._free.extend(blocks)
