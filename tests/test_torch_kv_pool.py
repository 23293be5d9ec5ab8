"""The port's paged KV pool over a torch arena: the bookkeeping is a copy of
the JAX package's, the arena operations are new (in-place `index_copy_` for
copy-on-write, `index_select` for defrag), so these tests check that the
arena rows move with the block ids and that the pool's invariants hold."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.serving import (ArenaAllocFault, PagedKVPool, SamplingParams,
                                 Scheduler, Sequence)


@pytest.fixture
def cfg():
    return reduced(get_config("gpt2"))


def _pool(cfg, n_blocks=12, bs=4, prefix=True):
    pool = PagedKVPool(cfg, n_blocks=n_blocks, block_size=bs, device="cpu",
                       enable_prefix_cache=prefix)
    # every block's rows hold their own id, so moves are visible
    ids = torch.arange(n_blocks, dtype=torch.float32)[None, :, None, None, None]
    pool.k.copy_(ids.expand_as(pool.k))
    pool.v.copy_(-ids.expand_as(pool.v))
    return pool


def test_copy_on_write_copies_rows_in_place(cfg):
    pool = _pool(cfg)
    k_storage = pool.k.data_ptr()
    [b] = pool.alloc(1)
    pool.share([b])                       # two owners
    new = pool.copy_on_write(b)
    assert new != b and pool.refcount[b] == 1 and pool.refcount[new] == 1
    assert pool.k.data_ptr() == k_storage          # updated in place
    assert torch.all(pool.k[:, new] == b) and torch.all(pool.v[:, new] == -b)
    assert pool.cow_copies == 1
    pool.check_invariants()


def test_defrag_moves_rows_with_their_blocks(cfg):
    pool = _pool(cfg)
    a = Sequence(0, [1, 2, 3, 4, 5], SamplingParams(), 0.0)
    b = Sequence(1, [6, 7, 8], SamplingParams(), 1.0)
    pool.alloc(3)                                  # blocks 1-3: freed below
    a.block_ids = pool.alloc(2)                    # 4, 5
    b.block_ids = pool.alloc(1)                    # 6
    pool.free_blocks([1, 2, 3])
    pool.share(b.block_ids)                        # shared with a as well
    a.block_ids = a.block_ids + b.block_ids
    before_a = [int(pool.k[0, x, 0, 0, 0]) for x in a.block_ids]
    before_b = [int(pool.k[0, x, 0, 0, 0]) for x in b.block_ids]
    mapping = pool.defrag([a, b])
    assert sorted(mapping.values()) == [1, 2, 3]
    assert a.block_ids == [1, 2, 3] and b.block_ids == [3]
    assert [int(pool.k[0, x, 0, 0, 0]) for x in a.block_ids] == before_a
    assert [int(pool.k[0, x, 0, 0, 0]) for x in b.block_ids] == before_b
    assert [int(pool.v[0, x, 0, 0, 0]) for x in a.block_ids] == \
        [-x for x in before_a]
    pool.check_invariants([a, b])


def test_alloc_fault_defers_admission_without_state_change(cfg):
    pool = _pool(cfg)
    sched = Scheduler(pool, max_prefill_tokens=8, chunked_prefill=True,
                      mixed=True)
    seq = Sequence(0, list(range(10)), SamplingParams(max_new_tokens=2), 0.0)
    sched.add(seq)
    pool.arm_alloc_failure(1)
    free0 = pool.num_free
    assert sched.schedule() is None                # admission deferred
    assert sched.alloc_fault_degrades == 1 and pool.num_free == free0
    assert seq.block_ids == [] and list(sched.waiting) == [seq]
    with pytest.raises(ArenaAllocFault):
        pool.arm_alloc_failure(1)
        pool.alloc(1)
    plan = sched.schedule()                        # the retry goes through
    assert plan.roles == ["prefill"] and plan.windows == [8]
    pool.check_invariants([seq])


# ------------------------------------------------ rollback under pressure
# The port's copy of tests/test_prefix_cache.py's PoolHarness: the
# scheduler's admission (match / cap / share / COW / alloc) and release
# paths against a real pool. Its rollback takes the cache length the pool
# leaves: a kept partial tail shared with another live sequence is dropped
# when no block can be had for its copy (the JAX pool raises there).

class PoolHarness:
    def __init__(self, cfg, n_blocks=8, block_size=2, vocab=3):
        self.pool = PagedKVPool(cfg, n_blocks=n_blocks, block_size=block_size,
                                enable_prefix_cache=True, device="cpu")
        self.vocab = vocab
        self.seqs = {}
        self.next_id = 0

    def admit(self, tokens):
        pool, bs = self.pool, self.pool.block_size
        target = len(tokens)
        matched = pool.match_prefix(tokens)
        cached = min(len(matched) * bs, target - 1)
        kept = -(-cached // bs)
        matched = matched[:kept]
        need_new = pool.blocks_for(target) - kept
        need_cow = 1 if cached % bs else 0
        revive = sum(1 for b in matched if pool.is_cached_free(b))
        if need_new + need_cow + revive > pool.num_free:
            return None
        pool.share(matched)
        blocks = list(matched)
        if need_cow:
            blocks[-1] = pool.copy_on_write(blocks[-1])
        if need_new > 0:
            blocks.extend(pool.alloc(need_new))
        seq = Sequence(self.next_id, list(tokens), SamplingParams(),
                       float(self.next_id))
        self.next_id += 1
        seq.block_ids = blocks
        seq.cache_len = seq.prefill_cursor = target
        pool.register_prefix(tokens, blocks, target)
        self.seqs[seq.req_id] = seq
        return seq.req_id

    def free(self, sid):
        seq = self.seqs.pop(sid)
        self.pool.free_blocks(seq.block_ids)
        seq.block_ids = []

    def rollback(self, sid, n_tokens):
        seq = self.seqs[sid]
        n_tokens = min(n_tokens, seq.cache_len)
        seq.block_ids = self.pool.rollback(seq.block_ids, n_tokens)
        seq.cache_len = seq.prefill_cursor = min(
            n_tokens, len(seq.block_ids) * self.pool.block_size)

    def defrag(self):
        self.pool.defrag(sorted(self.seqs.values(),
                                key=lambda s: s.arrival_time))

    def check(self):
        self.pool.check_invariants(self.seqs.values())


@pytest.fixture
def tiny_cfg():
    return reduced(get_config("gpt2")).replace(vocab=8)


def test_rollback_with_no_free_block_keeps_invariants(tiny_cfg):
    """The case the JAX pool fails (tests/test_prefix_cache.py's state
    machine): 8 blocks of 2, admit 9 tokens then 4, roll the second back to
    3 tokens. Its kept tail is registered but its own, so it leaves the
    index instead of being copied; with a second owner and no block free,
    it is dropped."""
    h = PoolHarness(tiny_cfg)
    h.admit([0, 1, 2, 0, 1, 2, 0, 1, 2])
    sid = h.admit([2, 2, 1, 1])
    assert h.pool.num_free == 0
    tail = h.seqs[sid].block_ids[1]
    h.rollback(sid, 3)
    h.check()
    assert h.seqs[sid].block_ids[1] == tail and h.seqs[sid].cache_len == 3
    assert not h.pool.needs_cow(tail) and h.pool.cow_copies == 0
    # a second owner of the (re-registered) tail, and still no free block
    h.pool.register_prefix([2, 2, 1, 1], h.seqs[sid].block_ids, 4)
    other = Sequence(99, [2, 2, 1, 1], SamplingParams(), 99.0)
    other.block_ids = list(h.seqs[sid].block_ids)
    other.cache_len = 4
    h.pool.share(other.block_ids)
    h.seqs[99] = other
    h.rollback(sid, 3)
    h.check()
    assert h.seqs[sid].block_ids == other.block_ids[:1]
    assert h.seqs[sid].cache_len == 2 and h.pool.refcount[tail] == 1


def test_rollback_seeded_walk_keeps_invariants(tiny_cfg):
    """A seeded random walk of admit, free, double free, rollback and
    defrag, with the pool's invariants checked after every step. Half the
    admits repeat a live sequence's prompt, so shared partial tails meet a
    full pool; the walk must take every branch of rollback's tail plan."""
    taken = {"unregister": 0, "copy": 0, "drop": 0}
    for seed in range(4):
        rng = np.random.default_rng(seed)
        h = PoolHarness(tiny_cfg)
        bs = h.pool.block_size
        for _ in range(200):
            op = ["admit", "admit", "free", "double_free", "rollback",
                  "defrag"][int(rng.integers(6))]
            sids = list(h.seqs)
            if op == "admit":
                if sids and rng.random() < 0.5:
                    h.admit(h.seqs[sids[int(rng.integers(len(sids)))]].prompt)
                else:
                    n = int(rng.integers(1, 4 * bs + 2))
                    h.admit(rng.integers(0, h.vocab, size=n).tolist())
            elif op == "free" and sids:
                h.free(sids[int(rng.integers(len(sids)))])
            elif op == "rollback" and sids:
                sid = sids[int(rng.integers(len(sids)))]
                seq = h.seqs[sid]
                n = int(rng.integers(0, seq.cache_len + 1))
                tail = seq.block_ids[-(-n // bs) - 1] if n % bs else None
                own_registered = tail is not None and \
                    h.pool.refcount[tail] == 1 and h.pool.needs_cow(tail)
                copies = h.pool.cow_copies
                h.rollback(sid, n)
                taken["unregister"] += own_registered
                taken["copy"] += h.pool.cow_copies - copies
                taken["drop"] += seq.cache_len < n
            elif op == "double_free" and sids:
                sid = sids[int(rng.integers(len(sids)))]
                blocks = list(h.seqs[sid].block_ids)
                h.free(sid)
                gone = [b for b in blocks if h.pool.refcount.get(b, 0) == 0]
                if gone:
                    with pytest.raises(ValueError):
                        h.pool.free_blocks(gone)
            elif op == "defrag":
                h.defrag()
            h.check()
        for sid in list(h.seqs):
            h.free(sid)
        h.check()
        assert h.pool.num_free == h.pool.num_total
    assert all(taken.values()), taken
