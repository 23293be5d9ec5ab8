"""Paged KV-cache pool: refcounted, prefix-cached block tables over a shared
per-layer arena (port of ``repro/serving/kv_pool.py``: the same bookkeeping
over a torch arena).

The arena is a pair of device tensors shaped (L, n_blocks, block_size, Hkv,
hd) (see `transformer.init_paged_cache`). Unlike the JAX pool, which swaps
in updated copies, this one updates the arena in place: the serving step
writes K/V into it, copy-on-write copies rows with `index_copy_`, and
defrag permutes it with `index_select` and copies the result back. The pool manages the *host-side*
free list and hands out ordered block lists; sequences index the arena
through (padded) block tables inside the jitted model functions.

Block 0 is reserved as the null/scratch block: block-table padding points at
it, and padded batch slots write into it. It is never allocated.

Prefix caching (vLLM-style):

  * Every *full* block of a prompt gets a chain hash -- hash of its token
    ids chained on the parent block's hash -- registered in a hash -> block
    index once its KV has actually been written.
  * A new request walks its prompt's full-block chain through the index and
    maps its block table onto the matched arena rows (`match_prefix` +
    `share`), bumping each block's refcount instead of allocating.
  * Blocks whose refcount drops to 0 but that are still registered move to
    an LRU "cached-free" list: they remain reclaimable (counted in
    `num_free`, evicted oldest-first when `alloc` runs dry) but stay
    matchable until actually evicted, so prefixes survive their donor.
  * A shared (or registered) block that a sequence needs to *write* -- the
    last partial block when a match is capped mid-block -- is copied on
    write (`copy_on_write`): fresh block, device row copy, old refcount
    dropped. Full shared blocks are never written, so COW is the only write
    path into shared state.

Double-free safety: the free and cached-free sets are explicit, so re-freeing
a specific block id (or freeing with refcount 0) raises instead of silently
corrupting the aggregate count.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from typing import Dict, Iterable, List, Optional, Sequence as Seq

import numpy as np
import torch

from repro_torch.models import transformer

from .faults import ArenaAllocFault

NULL_BLOCK = 0


def chain_hashes(tokens: Seq, block_size: int,
                 n_tokens: Optional[int] = None) -> List[int]:
    """Chain hash per *full* block of `tokens[:n_tokens]`: block i's hash
    covers all token ids up to and including block i (via the parent link),
    so equal hashes imply equal whole prefixes, not just equal blocks.
    SHA-256-based (as vLLM hardened its prefix cache to be): deterministic
    across processes and collision-resistant even against adversarial token
    sequences, unlike Python's builtin hash()."""
    n = len(tokens) if n_tokens is None else min(n_tokens, len(tokens))
    out: List[int] = []
    parent = 0
    for i in range(n // block_size):
        chunk = np.asarray(tokens[i * block_size:(i + 1) * block_size],
                           np.int64).tobytes()
        digest = hashlib.sha256(parent.to_bytes(16, "little") + chunk)
        parent = int.from_bytes(digest.digest()[:16], "little")
        out.append(parent)
    return out


class PagedKVPool:
    def __init__(self, cfg, *, n_blocks: int, block_size: int,
                 dtype=torch.float32, enable_prefix_cache: bool = False,
                 device="cuda"):
        if n_blocks < 2:
            raise ValueError("need at least one allocatable block besides "
                             "the reserved null block")
        arena = transformer.init_paged_cache(cfg, n_blocks, block_size, dtype,
                                             device=device)
        self.k = arena["k"]
        self.v = arena["v"]
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.enable_prefix_cache = enable_prefix_cache
        self._free = deque(range(1, n_blocks))          # block 0 reserved
        self._free_set = set(self._free)
        self.refcount: Dict[int, int] = {}              # block -> live owners
        # prefix index: chain hash <-> block id (1:1), plus the LRU of
        # registered blocks with no live owner (evictable, still matchable).
        # _hash_to_chunk keeps each entry's (parent hash, block token ids)
        # so a match verifies content along the whole chain, never trusting
        # the hash alone (a collision must not map onto foreign KV).
        self._hash_to_block: Dict[int, int] = {}
        self._block_to_hash: Dict[int, int] = {}
        self._hash_to_chunk: Dict[int, tuple] = {}
        self._cached_free: "OrderedDict[int, None]" = OrderedDict()
        self.peak_used = 0
        # telemetry
        self.total_allocs = 0          # fresh block allocations
        self.hit_blocks = 0            # block allocations avoided via sharing
        self.cow_copies = 0
        self.evictions = 0             # cached-free blocks reclaimed by alloc
        # fault injection: when armed, the next alloc() calls raise
        # ArenaAllocFault *before* mutating any pool state
        self._fail_next_allocs = 0

    # -- accounting ---------------------------------------------------------

    @property
    def num_total(self) -> int:
        """Allocatable blocks (excludes the null block)."""
        return self.n_blocks - 1

    @property
    def num_free(self) -> int:
        """Immediately allocatable: truly free + evictable cached blocks."""
        return len(self._free) + len(self._cached_free)

    @property
    def num_used(self) -> int:
        return self.num_total - self.num_free

    @property
    def num_cached(self) -> int:
        """Registered prefix blocks (live + cached-free)."""
        return len(self._hash_to_block)

    @property
    def utilization(self) -> float:
        return self.num_used / self.num_total

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    # -- alloc / free -------------------------------------------------------

    def can_alloc(self, n: int) -> bool:
        return n <= self.num_free

    def arm_alloc_failure(self, n: int = 1) -> None:
        """Fault injection: make the next `n` alloc() calls raise
        `ArenaAllocFault` before touching any pool state (the caller's
        degradation path sees exactly what a real exhaustion at that call
        site would, minus the exhaustion)."""
        self._fail_next_allocs = max(self._fail_next_allocs, n)

    def alloc(self, n: int) -> List[int]:
        if self._fail_next_allocs > 0:
            self._fail_next_allocs -= 1
            raise ArenaAllocFault(
                f"injected allocation failure (want {n} blocks)")
        if n > self.num_free:
            raise RuntimeError(f"KV pool exhausted: want {n} blocks, "
                               f"{self.num_free} free")
        out = []
        for _ in range(n):
            if self._free:
                b = self._free.popleft()
                self._free_set.discard(b)
            else:
                # reclaim the least-recently-freed cached block
                b, _ = self._cached_free.popitem(last=False)
                self._unregister(b)
                self.evictions += 1
            self.refcount[b] = 1
            out.append(b)
        self.total_allocs += n
        self.peak_used = max(self.peak_used, self.num_used)
        return out

    def share(self, ids: Iterable[int]) -> None:
        """Add an owner to each block (a prefix-cache hit). Blocks on the
        cached-free list are revived in place."""
        for b in ids:
            if b in self._free_set:
                raise ValueError(f"sharing free block {b}")
            if b in self._cached_free:
                del self._cached_free[b]
                self.refcount[b] = 1
            else:
                self.refcount[b] += 1
            self.hit_blocks += 1
        self.peak_used = max(self.peak_used, self.num_used)

    def free_blocks(self, ids: Iterable[int]) -> None:
        """Drop one owner per block; a block with no owners left returns to
        the free list (or the cached-free LRU if it is a registered prefix
        block). Freeing an already-free block id raises."""
        for b in ids:
            if b == NULL_BLOCK:
                raise ValueError("freeing the reserved null block")
            if b in self._free_set or b in self._cached_free:
                raise ValueError(f"double free of block {b}")
            rc = self.refcount.get(b, 0)
            if rc < 1:
                raise ValueError(f"freeing unallocated block {b}")
            if rc > 1:
                self.refcount[b] = rc - 1
                continue
            del self.refcount[b]
            if b in self._block_to_hash:
                self._cached_free[b] = None      # evictable, still matchable
            else:
                self._free.append(b)
                self._free_set.add(b)

    # -- prefix cache -------------------------------------------------------

    def _unregister(self, b: int) -> None:
        h = self._block_to_hash.pop(b, None)
        if h is not None:
            self._hash_to_block.pop(h, None)
            self._hash_to_chunk.pop(h, None)

    def match_prefix(self, tokens: Seq,
                     hashes: Optional[List[int]] = None) -> List[int]:
        """Longest chain of registered full blocks covering a prefix of
        `tokens`. Returns the matched block ids in position order *without*
        taking ownership -- callers commit with `share`. Pass precomputed
        `hashes` (chain_hashes of the same tokens) to skip rehashing.

        Content-checked on top of the SHA-256 chain: each candidate entry's
        stored (parent hash, block tokens) must equal this prompt's -- by
        induction along the chain equal entries imply equal whole prefixes,
        so even a hash collision degrades to a cache miss, never to foreign
        KV."""
        if not self.enable_prefix_cache:
            return []
        bs = self.block_size
        if hashes is None:
            hashes = chain_hashes(tokens, bs)
        out = []
        for i, h in enumerate(hashes):
            b = self._hash_to_block.get(h)
            parent = hashes[i - 1] if i else 0
            if b is None or self._hash_to_chunk[h] != (
                    parent, tuple(tokens[i * bs:(i + 1) * bs])):
                break
            out.append(b)
        return out

    def register_prefix(self, tokens: Seq, block_ids: Seq[int],
                        n_tokens: int,
                        hashes: Optional[List[int]] = None) -> int:
        """Register the full blocks of `tokens[:n_tokens]` (whose KV the
        caller has written through `block_ids`) in the prefix index.
        First writer wins: hashes already mapped to a different block keep
        the existing mapping. Pass precomputed `hashes` covering at least
        n_tokens // block_size blocks to skip rehashing (chunked prefill
        registers after every chunk). Returns the newly indexed count."""
        if not self.enable_prefix_cache:
            return 0
        bs = self.block_size
        n_full = min(n_tokens, len(tokens)) // bs
        if hashes is None:
            hashes = chain_hashes(tokens, bs, n_tokens)
        added = 0
        for i in range(n_full):
            h = hashes[i]
            b = block_ids[i]
            if h in self._hash_to_block or b in self._block_to_hash:
                continue
            self._hash_to_block[h] = b
            self._block_to_hash[b] = h
            self._hash_to_chunk[h] = (hashes[i - 1] if i else 0,
                                      tuple(tokens[i * bs:(i + 1) * bs]))
            added += 1
        return added

    def copy_on_write(self, b: int) -> int:
        """Give the caller a private, writable copy of block `b`: allocate a
        fresh block, copy the arena rows on device, and drop one owner from
        `b`. Required before writing any block that is shared (refcount > 1)
        or registered in the prefix index (its contents must stay equal to
        its hash)."""
        [new] = self.alloc(1)
        dst = torch.tensor([new], device=self.k.device)
        self.k.index_copy_(1, dst, self.k[:, b:b + 1])
        self.v.index_copy_(1, dst, self.v[:, b:b + 1])
        self.free_blocks([b])
        self.cow_copies += 1
        return new

    def rollback(self, block_ids: Seq[int], n_tokens: int) -> List[int]:
        """Truncate a sequence's block list to cover exactly `n_tokens`
        cached positions, freeing the surplus tail blocks (speculative
        decoding rolls back the blocks that held rejected draft K/V).

        Freeing only drops owners, deepest block first, so a block that
        others share or the prefix index maps keeps its contents. The kept
        partially filled tail block (the sequence's next write lands in it)
        must end up private and unregistered, and that never raises:

          * owned by this sequence alone but registered: it leaves the
            prefix index (its content is about to change), no block needed;
          * shared with another live sequence: copied on write when a block
            can be had (free, or a cached-free one evicted, as `alloc`
            does); when none can, the tail is dropped too and only the full
            blocks below `n_tokens` are kept.

        Here the port departs from the JAX pool, whose rollback raises
        "KV pool exhausted" in the last case. Returns the kept block list:
        the caller's cache length becomes ``min(n_tokens, len(kept) *
        block_size)``; the caller must not free the surplus again."""
        keep = self.blocks_for(n_tokens)
        if keep > len(block_ids):
            raise ValueError(
                f"rollback to {n_tokens} tokens needs {keep} blocks but the "
                f"sequence owns only {len(block_ids)}")
        kept = list(block_ids[:keep])
        self.free_blocks(reversed(list(block_ids[keep:])))
        if not (n_tokens % self.block_size and kept):
            return kept
        tail = kept[-1]
        if self.refcount[tail] == 1:
            self._unregister(tail)
        elif self.num_free:
            kept[-1] = self.copy_on_write(tail)
        else:
            self.free_blocks([kept.pop()])
        return kept

    def needs_cow(self, b: int) -> bool:
        return self.refcount.get(b, 0) > 1 or b in self._block_to_hash

    def is_cached_free(self, b: int) -> bool:
        """True if `b` is a registered block with no live owner (reviving it
        via `share` removes it from the allocatable budget)."""
        return b in self._cached_free

    # -- invariants ---------------------------------------------------------

    def check_invariants(self, sequences: Optional[Seq] = None) -> None:
        """Full pool consistency check; raises RuntimeError on corruption.

        Pool-only invariants (always checked): block conservation -- free,
        cached-free, and owned sets are pairwise disjoint and together cover
        every allocatable block; the free deque and free set agree; the
        aggregate counters match the sets; the prefix index is a bijection
        over non-free blocks with a content chunk stored per entry.

        With `sequences` (every live owner of pool blocks), additionally:
        refcounts equal the number of owning sequences per block, no table
        holds a duplicate or free block, and the partial tail block a decode
        write would land in is never shared or registered.

        The JAX package's tests use it as their fuzz oracle; the port's
        tests call it after pool surgery (COW, defrag, preemption).
        """
        def _req(cond: bool, msg: str) -> None:
            if not cond:
                raise RuntimeError(f"KV pool invariant violated: {msg}")

        free = set(self._free)
        cached_free = set(self._cached_free)
        owned = set(self.refcount)
        _req(free == self._free_set, "free deque and free set disagree")
        _req(not (free & cached_free), "block both free and cached-free")
        _req(not (free & owned), "block both free and owned")
        _req(not (cached_free & owned), "block both cached-free and owned")
        _req(free | cached_free | owned == set(range(1, self.n_blocks)),
             "block conservation: free + cached-free + owned != all blocks")
        _req(self.num_free == len(free) + len(cached_free),
             "num_free disagrees with the free sets")
        _req(self.num_free + len(owned) == self.num_total,
             "num_free + owned != num_total")
        _req(all(rc >= 1 for rc in self.refcount.values()),
             "owned block with refcount < 1")
        _req(len(self._hash_to_block) == len(self._block_to_hash),
             "prefix index is not a bijection")
        _req(set(self._hash_to_chunk) == set(self._hash_to_block),
             "prefix index entry without a content chunk")
        for h, b in self._hash_to_block.items():
            _req(self._block_to_hash.get(b) == h,
                 f"prefix index asymmetry at block {b}")
            _req(b not in free, f"registered block {b} on the free list")
        if sequences is None:
            return
        counts: Dict[int, int] = {}
        for seq in sequences:
            for b in set(seq.block_ids):
                counts[b] = counts.get(b, 0) + 1
        _req(counts == self.refcount,
             "refcounts disagree with sequence ownership")
        for seq in sequences:
            _req(len(set(seq.block_ids)) == len(seq.block_ids),
                 f"duplicate block in table of request {seq.req_id}")
            for b in seq.block_ids:
                _req(0 < b < self.n_blocks,
                     f"request {seq.req_id} table points at block {b}")
                _req(b not in free and b not in cached_free,
                     f"request {seq.req_id} table points at freed block {b}")
            tail = seq.cache_len // self.block_size
            if seq.cache_len % self.block_size and tail < len(seq.block_ids):
                _req(not self.needs_cow(seq.block_ids[tail]),
                     f"request {seq.req_id} decode-write tail block "
                     f"{seq.block_ids[tail]} is shared or registered")

    # -- defrag -------------------------------------------------------------

    def defrag(self, sequences: Seq) -> Dict[int, int]:
        """Compact live blocks to the lowest arena indices.

        Permutes the arena rows on device (one gather per array, copied back
        into the same storage) and rewrites
        each sequence's `block_ids` in place, so long-running churn cannot
        scatter a sequence's blocks across the arena. Refcount-aware: a block
        shared by several sequences maps to one new row (every sharer's table
        is rewritten to it) and keeps its refcount and prefix-index entry.
        Cached-free blocks (registered, no live owner) are evicted -- defrag
        reclaims them as contiguous free space. Returns the old -> new block
        id mapping.
        """
        mapping: Dict[int, int] = {}
        nxt = 1
        for seq in sequences:
            for b in seq.block_ids:
                if b in mapping:
                    continue                     # shared with an earlier seq
                mapping[b] = nxt
                nxt += 1
        self.evictions += len(self._cached_free)
        for b in list(self._cached_free):
            self._unregister(b)
        self._cached_free.clear()
        if all(old == new for old, new in mapping.items()):
            self._free = deque(range(nxt, self.n_blocks))
            self._free_set = set(self._free)
            return mapping  # already compact; skip the device gather
        # build a full permutation: new row i reads old row perm[i]
        perm = np.empty(self.n_blocks, np.int32)
        perm[0] = NULL_BLOCK
        for old, new in mapping.items():
            perm[new] = old
        spare = [b for b in range(1, self.n_blocks) if b not in mapping]
        perm[nxt:] = spare
        pj = torch.from_numpy(perm).to(self.k.device)
        self.k.copy_(torch.index_select(self.k, 1, pj))
        self.v.copy_(torch.index_select(self.v, 1, pj))
        for seq in sequences:
            seq.block_ids = [mapping[b] for b in seq.block_ids]
        self.refcount = {mapping[b]: rc for b, rc in self.refcount.items()}
        b2h = {mapping[b]: h for b, h in self._block_to_hash.items()
               if b in mapping}
        self._block_to_hash = b2h
        self._hash_to_block = {h: b for b, h in b2h.items()}
        self._hash_to_chunk = {h: c for h, c in self._hash_to_chunk.items()
                               if h in self._hash_to_block}
        self._free = deque(range(nxt, self.n_blocks))
        self._free_set = set(self._free)
        return mapping
