"""The port's paged KV pool over a torch arena: the bookkeeping is a copy of
the JAX package's, the arena operations are new (in-place `index_copy_` for
copy-on-write, `index_select` for defrag), so these tests check that the
arena rows move with the block ids and that the pool's invariants hold."""

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
    sched = Scheduler(pool, max_prefill_tokens=8, chunked_prefill=True)
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
