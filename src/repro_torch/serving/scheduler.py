"""Continuous-batching scheduler (port of ``repro/serving/scheduler.py``).

Policy (vLLM-v0 style, adapted to fixed-shape buckets):

  * Admission is FCFS from the waiting queue, gated by the free-block
    budget. With prefix caching on, a prompt's full-block chain is first
    matched against the pool's prefix index: matched blocks are shared
    (refcounted) instead of allocated, the match is capped at prompt-1
    tokens (at least one token must run to produce logits), and a cap that
    lands mid-block copies that block on write before the sequence may fill
    its tail.
  * With `mixed` (the engine's `fused_step`) every step is one mixed plan:
    prefill windows first (chunk continuation and admission), then decode
    rows, each one token plus its draft budget; plans carry `windows`,
    `draft_lens` and `roles`. Without it each step is either one prefill
    batch or one decode batch, as in the JAX package's pre-fusion
    scheduler: prefill is preferred, but never twice in a row while
    sequences are decoding, and with FCFS preemption order the oldest
    request always progresses. Either way a plan stream compares one to
    one with the JAX scheduler's.
  * Speculative decoding (`spec_draft_len` > 0): each decode row gets a
    draft budget, oldest first, out of what the prefill windows left of the
    token budget (the verify pass is a (kd + 1)-token window, the compute
    shape of a prefill chunk), capped by the request's own token limit.
    Block demand covers the whole speculative span (cache_len .. cache_len
    + kd); under pressure the scheduler sheds draft lookahead before it
    preempts anyone, so speculation can never deadlock the pool.
  * Chunked prefill: a prompt prefills in `max_prefill_tokens`-sized chunks
    across steps (the per-sequence `prefill_cursor` tracks progress).
    Blocks are allocated per chunk, not for the whole prompt up front.
  * When the pool cannot cover the decode rows' next KV writes, running
    sequences are preempted youngest-first (recompute-style eviction: blocks
    freed, sequence requeued at the *front* of the waiting queue with its
    generated tokens kept). A preempted sequence's filled full blocks are
    registered in the prefix index first, so -- capacity permitting -- its
    resume re-prefills only the un-cached suffix.

Progress guarantee: the engine validates that the pool can hold at least one
maximal sequence, so a lone running sequence can always allocate its next
block and the oldest request can always eventually run to completion.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import deque
from typing import Deque, List, Optional, Set

from .faults import ArenaAllocFault
from .kv_pool import PagedKVPool, chain_hashes
from .request import Sequence, SequenceStatus


@dataclasses.dataclass
class StepPlan:
    kind: str                  # "prefill" | "decode" | "mixed"
    seqs: List[Sequence]
    # prefill / mixed: live tokens each row runs this step: the chunk window
    # starting at prefill_cursor for prefill rows, 1 + draft_lens[i] for
    # mixed decode / verify rows (the verify span, bonus position included)
    windows: Optional[List[int]] = None
    # decode / mixed: tokens each sequence may draft this round (0 = plain
    # decode; always 0 for prefill rows and without speculative decoding)
    draft_lens: Optional[List[int]] = None
    # mixed only: per-row role -- "prefill" (chunk window), "decode" (plain
    # next-token row) or "verify" (speculative round with draft_lens[i] > 0)
    roles: Optional[List[str]] = None


class Scheduler:
    def __init__(self, pool: PagedKVPool, *, max_prefill_batch: int = 8,
                 max_prefill_tokens: int = 2048, max_decode_batch: int = 32,
                 chunked_prefill: bool = False, spec_draft_len: int = 0,
                 mixed: bool, obs=None):
        self.pool = pool
        # optional Observability (repro_torch.obs): block-alloc spans and
        # preemption instants; None (standalone scheduler tests): no-ops
        self._obs = obs
        self._span = (obs.span if obs is not None
                      else lambda name, **kw: contextlib.nullcontext())
        self.max_prefill_batch = max_prefill_batch
        self.max_prefill_tokens = max_prefill_tokens
        self.max_decode_batch = max_decode_batch
        self.chunked_prefill = chunked_prefill
        self.spec_draft_len = spec_draft_len
        # fused-step mode: every schedule() emits one "mixed" plan instead
        # of alternating phase-segregated prefill / decode plans; no default,
        # so the engine's `fused_step` is the one place the choice is made
        self.mixed = mixed
        self.waiting: Deque[Sequence] = deque()
        self.running: List[Sequence] = []
        self.num_preemptions = 0
        # allocation failures (injected or real transients) absorbed by
        # degrading the step instead of crashing
        self.alloc_fault_degrades = 0
        self._last_was_prefill = False

    # -- queue ops ----------------------------------------------------------

    def add(self, seq: Sequence) -> None:
        self.waiting.append(seq)

    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self.running)

    def _preempt_youngest(self, keep: Optional[Sequence] = None) -> bool:
        """Evict the youngest running sequence (never `keep`). Returns False
        when there is nothing evictable."""
        for victim in sorted(self.running, key=lambda s: s.arrival_time,
                             reverse=True):
            if victim is keep:
                continue
            self.running.remove(victim)
            if self.pool.enable_prefix_cache:
                # keep the evicted KV matchable: resume (or any request with
                # the same prefix) re-prefills only the un-cached suffix
                self.pool.register_prefix(victim.prefill_tokens(),
                                          victim.block_ids, victim.cache_len)
            # free tail-first so the cached-free LRU evicts chain tails
            # before the heads that every matching prefix needs
            self.pool.free_blocks(reversed(victim.block_ids))
            victim.preempt()
            self.waiting.appendleft(victim)
            self.num_preemptions += 1
            if self._obs is not None and self._obs.tracer.enabled:
                self._obs.tracer.instant("preempt", cat="sched",
                                         req=victim.req_id)
            return True
        return False

    # -- step composition ---------------------------------------------------

    def _grow_window(self, seq: Sequence, want: int) -> int:
        """Allocate blocks so `seq` can prefill `want` more tokens; shrinks
        the window to what the free-block budget covers. Returns the granted
        window (0 = no progress possible)."""
        if want <= 0:
            return 0
        bs = self.pool.block_size
        avail = (len(seq.block_ids) + self.pool.num_free) * bs \
            - seq.prefill_cursor
        window = min(want, avail)
        if window <= 0:
            return 0
        need = self.pool.blocks_for(seq.prefill_cursor + window) \
            - len(seq.block_ids)
        if need > 0:
            try:
                with self._span("alloc", blocks=need, req=seq.req_id):
                    seq.block_ids.extend(self.pool.alloc(need))
            except ArenaAllocFault:
                # degrade: this row skips its chunk this step and retries
                # next step (nothing was allocated, nothing to unwind)
                self.alloc_fault_degrades += 1
                return 0
        return window

    def _try_admit(self, seq: Sequence, want: int,
                   pending: Set[int]) -> Optional[int]:
        """Admit a waiting sequence: match its prefix chain against the
        cache, share matched blocks, COW a mid-block cap, and allocate the
        first window. Returns the granted window, 0 to defer the sequence to
        the next step (its prefix is being written by this very batch), or
        None when the block budget cannot cover admission."""
        tokens = seq.prefill_tokens()
        target = len(tokens)
        bs = self.pool.block_size
        matched: List[int] = []
        hashes: List[int] = []
        if self.pool.enable_prefix_cache:
            # the prompt is immutable while waiting: hash it once and keep
            # the chain on the sequence across failed admission retries and
            # for per-chunk registration (preempt() clears it)
            if not seq.prefix_hashes:
                seq.prefix_hashes = chain_hashes(tokens, bs)
            hashes = seq.prefix_hashes
            if hashes and hashes[0] in pending:
                # an earlier admission in this same batch is about to write
                # and register this prefix; wait one step and share it
                return 0
            matched = self.pool.match_prefix(tokens, hashes)
        while True:
            cached = min(len(matched) * bs, target - 1)
            kept = -(-cached // bs)
            matched = matched[:kept]
            window = target - cached
            if self.chunked_prefill:
                window = min(window, max(want, 1))
            # block budget: fresh blocks for the window, one COW copy if the
            # match cap lands mid-block, and revived cached-free blocks all
            # come out of num_free
            need_new = self.pool.blocks_for(cached + window) - kept
            need_cow = 1 if cached % bs else 0
            revive = sum(1 for b in matched if self.pool.is_cached_free(b))
            if need_new + need_cow + revive <= self.pool.num_free:
                break
            if not matched:
                return None
            # share + COW overhead does not fit: degrade gracefully by
            # dropping the least-valuable cached block (the chain tail) and
            # recomputing its tokens instead
            matched = matched[:-1]
        hit0 = self.pool.hit_blocks
        try:
            self.pool.share(matched)
            seq.block_ids = list(matched)
            if need_cow:
                seq.block_ids[-1] = self.pool.copy_on_write(seq.block_ids[-1])
                # the COW'd tail is not an avoided allocation (its KV is
                # still reused, which num_cached_tokens reflects)
                self.pool.hit_blocks -= 1
            if need_new > 0:
                with self._span("alloc", blocks=need_new, req=seq.req_id):
                    seq.block_ids.extend(self.pool.alloc(need_new))
        except ArenaAllocFault:
            # degrade: unwind the partial admission (drop the shared owners,
            # restore the hit accounting) and defer the sequence; it stays
            # at the front of the waiting queue and retries next step
            self.pool.free_blocks(reversed(seq.block_ids))
            seq.block_ids = []
            self.pool.hit_blocks = hit0
            self.alloc_fault_degrades += 1
            return None
        seq.prefill_cursor = cached
        seq.cache_len = cached
        # a resumed sequence matching blocks it registered at its own
        # preemption is not a cross-request cache win: count it separately
        # so the cache hit rate is not double-counted by preemption churn
        if seq.num_preemptions > 0:
            seq.num_resume_cached_tokens += cached
        else:
            seq.num_cached_tokens += cached
        seq.status = SequenceStatus.PREFILL
        pending.update(hashes[:(cached + window) // bs])
        return window

    def _try_prefill(self) -> Optional[StepPlan]:
        batch: List[Sequence] = []
        windows: List[int] = []
        budget = self.max_prefill_tokens
        # 1. continue partially-prefilled running sequences, oldest first
        if self.chunked_prefill:
            for seq in sorted(self.running, key=lambda s: s.arrival_time):
                if seq.status != SequenceStatus.PREFILL:
                    continue
                if len(batch) >= self.max_prefill_batch or budget <= 0:
                    break
                window = self._grow_window(
                    seq, min(seq.prefill_remaining, budget))
                if window == 0:
                    # block-starved (free list empty, tail block full):
                    # younger sequences with in-block slack can still
                    # advance without allocating — no stealing possible
                    continue
                batch.append(seq)
                windows.append(window)
                budget -= window
        # 2. admit new / resumed sequences FCFS
        pending: Set[int] = set()
        while self.waiting and len(batch) < self.max_prefill_batch:
            seq = self.waiting[0]
            if not self.chunked_prefill and batch \
                    and seq.prefill_remaining > budget:
                break
            if self.chunked_prefill and batch and budget <= 0:
                break
            window = self._try_admit(seq, budget, pending)
            if window is None or window == 0:
                break
            batch.append(self.waiting.popleft())
            windows.append(window)
            budget -= window
        if not batch:
            return None
        for seq in batch:
            if seq not in self.running:
                self.running.append(seq)
        return StepPlan("prefill", batch, windows)

    def _grant_draft_budgets(self, batch: List[Sequence],
                             budget: Optional[int] = None) -> List[int]:
        """Per-sequence draft budget for this round, oldest first (`batch`
        is oldest-first). The verify pass is a (kd + 1)-token window, the
        compute shape of a prefill chunk, so drafts come out of the prefill
        token budget: one position per decode row is free and sum(kd) is
        capped at `budget` (default: what the token budget has left after
        those; a mixed plan passes what its prefill windows left). No
        sequence drafts past its own token limit (the round emits at most
        kd + 1 tokens)."""
        if self.spec_draft_len <= 0:
            return [0] * len(batch)
        if budget is None:
            budget = max(0, self.max_prefill_tokens - len(batch))
        out = []
        for seq in batch:
            kd = min(self.spec_draft_len, budget,
                     max(0, seq.sampling.max_new_tokens
                         - seq.num_generated - 1))
            out.append(kd)
            budget -= kd
        return out

    def _try_decode(self) -> Optional[StepPlan]:
        """A phase-segregated decode plan: every decoding sequence, oldest
        first, up to max_decode_batch, with its draft budget and blocks for
        its next-token and speculative K/V writes. Under block pressure
        draft budgets shrink by one per row before the youngest running
        sequence (never the oldest of the batch) is preempted."""
        while True:
            ready = [s for s in self.running
                     if s.status == SequenceStatus.DECODE]
            if not ready:
                return None
            batch = sorted(ready,
                           key=lambda s: s.arrival_time)[:self.max_decode_batch]
            draft_lens = self._grant_draft_budgets(batch)
            while True:
                # blocks to cover each sequence's next-token K/V write plus
                # its speculative lookahead (cache_len .. cache_len + kd)
                deficits = []
                need = 0
                for seq, kd in zip(batch, draft_lens):
                    want = self.pool.blocks_for(seq.cache_len + 1 + kd)
                    deficits.append(max(0, want - len(seq.block_ids)))
                    need += deficits[-1]
                if need <= self.pool.num_free:
                    try:
                        if need > 0:
                            with self._span("alloc", blocks=need):
                                for seq, deficit in zip(batch, deficits):
                                    if deficit:
                                        seq.block_ids.extend(
                                            self.pool.alloc(deficit))
                    except ArenaAllocFault:
                        # degrade and re-grant: blocks already extended stay
                        # owned; the recomputed deficits skip them
                        self.alloc_fault_degrades += 1
                        continue
                    return StepPlan("decode", batch, draft_lens=draft_lens)
                if any(draft_lens):
                    # shed speculative lookahead before evicting anyone: a
                    # shorter draft is strictly cheaper than a recompute
                    draft_lens = [max(0, kd - 1) for kd in draft_lens]
                    continue
                if self._preempt_youngest(keep=batch[0]):
                    break              # recompose the batch
                raise RuntimeError(
                    "KV pool too small for a single sequence; raise n_blocks")

    def _mixed_decode_part(self, pre_seqs: List[Sequence],
                           pre_windows: List[int]):
        """Decode / verify rows of a mixed plan: every decoding sequence,
        oldest first, up to max_decode_batch, with its draft budget and
        blocks for its next-token and speculative K/V writes. Under block
        pressure draft budgets shrink by one per row before anyone is
        preempted. Preemption protects the oldest plan member overall; one
        that evicts one of this very plan's prefill rows drops that row from
        the plan (its blocks are already freed and the sequence is
        requeued; nothing has run yet). Returns (rows, draft_lens)."""
        while True:
            ready = [s for s in self.running
                     if s.status == SequenceStatus.DECODE]
            if not ready:
                return [], []
            batch = sorted(ready, key=lambda s: s.arrival_time
                           )[:self.max_decode_batch]
            budget = max(0, self.max_prefill_tokens - sum(pre_windows)
                         - len(batch))
            draft_lens = self._grant_draft_budgets(batch, budget)
            while True:
                deficits = []
                need = 0
                for seq, kd in zip(batch, draft_lens):
                    want = self.pool.blocks_for(seq.cache_len + 1 + kd)
                    deficits.append(max(0, want - len(seq.block_ids)))
                    need += deficits[-1]
                if need <= self.pool.num_free:
                    try:
                        if need > 0:
                            with self._span("alloc", blocks=need):
                                for seq, deficit in zip(batch, deficits):
                                    if deficit:
                                        seq.block_ids.extend(
                                            self.pool.alloc(deficit))
                    except ArenaAllocFault:
                        # degrade and re-grant: blocks already extended stay
                        # owned; the recomputed deficits skip them
                        self.alloc_fault_degrades += 1
                        continue
                    return batch, draft_lens
                if any(draft_lens):
                    # shed speculative lookahead before evicting anyone: a
                    # shorter draft is strictly cheaper than a recompute
                    draft_lens = [max(0, kd - 1) for kd in draft_lens]
                    continue
                keep = min(pre_seqs + batch, key=lambda s: s.arrival_time)
                if self._preempt_youngest(keep=keep):
                    for i in range(len(pre_seqs) - 1, -1, -1):
                        if pre_seqs[i].status == SequenceStatus.WAITING:
                            pre_seqs.pop(i)
                            pre_windows.pop(i)
                    break              # recompose the decode rows
                raise RuntimeError(
                    "KV pool too small for a single sequence; raise n_blocks")

    def _schedule_mixed(self) -> Optional[StepPlan]:
        """One fused step: prefill windows first (chunk continuation +
        admission, exactly `_try_prefill`), then decode / verify rows
        funded by the leftover token budget -- all in a single mixed
        StepPlan. Prefill-first plus FCFS admission and oldest-protected preemption
        preserves the split scheduler's no-starvation guarantee; decode
        rows cost one token each regardless, so they always ride along."""
        pre = self._try_prefill()
        pre_seqs = list(pre.seqs) if pre is not None else []
        pre_windows = list(pre.windows) if pre is not None else []
        dec_batch, draft_lens = self._mixed_decode_part(pre_seqs, pre_windows)
        if not pre_seqs and not dec_batch:
            prefill_work = bool(self.waiting) or any(
                s.status == SequenceStatus.PREFILL for s in self.running)
            if not (prefill_work and self.running):
                return None
            # every runnable sequence is mid-prefill but starved of blocks:
            # evict youngest-first until the oldest can advance (the split
            # path's recovery)
            oldest = min(self.running, key=lambda s: s.arrival_time)
            while self._preempt_youngest(keep=oldest):
                pre = self._try_prefill()
                if pre is not None:
                    pre_seqs = list(pre.seqs)
                    pre_windows = list(pre.windows)
                    break
            if not pre_seqs:
                raise RuntimeError(
                    "KV pool too small for a single sequence; raise n_blocks")
        return StepPlan(
            "mixed", pre_seqs + dec_batch,
            windows=pre_windows + [1 + kd for kd in draft_lens],
            draft_lens=[0] * len(pre_seqs) + draft_lens,
            roles=(["prefill"] * len(pre_seqs)
                   + ["verify" if kd else "decode" for kd in draft_lens]))

    def schedule(self) -> Optional[StepPlan]:
        """The next step's plan (None when nothing can run): one mixed plan
        with `mixed`, else one phase-segregated prefill or decode plan."""
        if self.mixed:
            return self._schedule_mixed()
        decode_possible = any(s.status == SequenceStatus.DECODE
                              for s in self.running)
        prefill_work = bool(self.waiting) or any(
            s.status == SequenceStatus.PREFILL for s in self.running)
        prefer_prefill = prefill_work and not (
            self._last_was_prefill and decode_possible)
        plan = None
        if prefer_prefill:
            plan = self._try_prefill()
        if plan is None and decode_possible:
            plan = self._try_decode()
        if plan is None and prefill_work and not prefer_prefill:
            plan = self._try_prefill()
        if plan is None and prefill_work and not decode_possible \
                and self.running:
            # every runnable sequence is mid-prefill but starved of blocks:
            # evict youngest-first until the oldest can advance
            oldest = min(self.running, key=lambda s: s.arrival_time)
            while self._preempt_youngest(keep=oldest):
                plan = self._try_prefill()
                if plan is not None:
                    break
            if plan is None:
                raise RuntimeError(
                    "KV pool too small for a single sequence; raise n_blocks")
        self._last_was_prefill = plan is not None and plan.kind == "prefill"
        return plan

    def finish(self, seq: Sequence) -> None:
        """Release a finished sequence's resources. Registered prefix blocks
        survive on the pool's cached-free list (tail-first, so eviction
        reclaims chain tails before shared heads) until evicted."""
        self.running.remove(seq)
        self.pool.free_blocks(reversed(seq.block_ids))
        seq.block_ids = []

    def cancel(self, seq: Sequence) -> None:
        """Remove a sequence from wherever it sits (waiting queue or running
        set) and release its blocks: deadline expiry, health-guard failure,
        and stall eviction all route through here. Idempotent-safe against
        the queue/running split; freeing mirrors `finish` (tail-first)."""
        if seq in self.running:
            self.running.remove(seq)
        else:
            try:
                self.waiting.remove(seq)
            except ValueError:
                pass
        if seq.block_ids:
            self.pool.free_blocks(reversed(seq.block_ids))
            seq.block_ids = []
