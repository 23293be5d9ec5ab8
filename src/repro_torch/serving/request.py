"""Request/Sequence lifecycle objects for the continuous-batching engine
(a copy of ``repro/serving/request.py`` without the fields of the parts not
ported yet: shadow audit, deadlines).

A `Sequence` tracks one request through
    WAITING -> PREFILL -> DECODE -> FINISHED
with preemption (recompute-style eviction) looping it back to WAITING: the
KV blocks are dropped and on re-admission the prompt *plus the tokens
generated so far* are re-prefilled, so generation resumes exactly where it
stopped. Per-request LAMP telemetry (selected / valid KQ-product counts from
the paged attention path) accumulates across prefill, decode, and resumes.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np


class SequenceStatus(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    max_new_tokens: int = 32
    temperature: float = 0.0        # 0 = greedy
    seed: int = 0                   # per-request sampling stream
    stop_token: Optional[int] = None
    top_k: int = 0                  # 0 = unfiltered; else sample from the
                                    # top-k logits only (also the filter the
                                    # speculative accept rule scores against)


@dataclasses.dataclass
class LampStats:
    """Accumulated LAMP recompute telemetry for one request."""
    selected: float = 0.0           # KQ products recomputed in high precision
    valid: float = 0.0              # KQ products inside the causal mask
    # per-layer breakdown (length n_layers once populated; each sums to the
    # scalar above) -- populated by the engine's per-layer step counts
    by_layer_selected: Optional[np.ndarray] = None
    by_layer_valid: Optional[np.ndarray] = None

    @property
    def recompute_rate(self) -> float:
        return self.selected / self.valid if self.valid > 0 else 0.0

    @property
    def layer_rates(self) -> List[float]:
        if self.by_layer_selected is None:
            return []
        return [float(s / v) if v else 0.0 for s, v in
                zip(self.by_layer_selected, self.by_layer_valid)]

    def add(self, selected: float, valid: float) -> None:
        self.selected += float(selected)
        self.valid += float(valid)

    def add_layers(self, selected, valid) -> None:
        """Accumulate one step's per-layer (L,) counts (and the totals)."""
        selected = np.asarray(selected, np.float64)
        valid = np.asarray(valid, np.float64)
        if self.by_layer_selected is None:
            self.by_layer_selected = np.zeros_like(selected)
            self.by_layer_valid = np.zeros_like(valid)
        self.by_layer_selected += selected
        self.by_layer_valid += valid
        self.add(selected.sum(), valid.sum())


class Sequence:
    """One request's mutable serving state."""

    def __init__(self, req_id: int, prompt: List[int],
                 sampling: SamplingParams, arrival_time: float):
        self.req_id = req_id
        self.prompt = list(prompt)
        self.sampling = sampling
        self.arrival_time = arrival_time
        self.status = SequenceStatus.WAITING
        self.generated: List[int] = []
        self.block_ids: List[int] = []
        # tokens whose KV is in the arena (prompt + generated - 1 once
        # decoding: the latest sampled token's KV is written by the next step)
        self.cache_len = 0
        # prefill progress: tokens of prefill_tokens() already in the arena
        # (prefix-cache hits + completed chunks); equals cache_len while the
        # sequence is mid-prefill, frozen at the prefill target afterwards
        self.prefill_cursor = 0
        # prompt tokens served from the prefix cache. Cross-request hits
        # (first admission) and this sequence re-hitting its *own* KV after
        # a preemption are tracked separately: resume self-hits are not
        # avoided work relative to a never-preempted run, so folding them
        # into num_cached_tokens would inflate the cache hit rate
        self.num_cached_tokens = 0
        self.num_resume_cached_tokens = 0
        # chain hashes of prefill_tokens(), computed once at admission so
        # per-chunk registration does not rehash the whole prefix
        self.prefix_hashes: List[int] = []
        self.num_preemptions = 0
        # speculative decoding: tokens this request drafted and how many of
        # those drafts the verifier accepted (across all rounds)
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.first_token_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.finish_reason: Optional[str] = None
        self.lamp = LampStats()

    # -- lifecycle ----------------------------------------------------------

    @property
    def is_finished(self) -> bool:
        return self.status == SequenceStatus.FINISHED

    def prefill_tokens(self) -> List[int]:
        """Tokens to run at (re-)prefill: prompt plus anything generated
        before a preemption."""
        return self.prompt + self.generated

    @property
    def prefill_target(self) -> int:
        return len(self.prompt) + len(self.generated)

    @property
    def prefill_remaining(self) -> int:
        return self.prefill_target - self.prefill_cursor

    @property
    def num_generated(self) -> int:
        return len(self.generated)

    @property
    def last_token(self) -> int:
        return self.generated[-1] if self.generated else self.prompt[-1]

    @property
    def total_len(self) -> int:
        """Max cache positions this request can ever need."""
        return len(self.prompt) + self.sampling.max_new_tokens

    @property
    def spec_acceptance_rate(self) -> float:
        """Fraction of drafted tokens the verifier accepted (in [0, 1])."""
        return (self.spec_accepted / self.spec_drafted
                if self.spec_drafted else 0.0)

    def on_token(self, token: int, now: float) -> None:
        if self.first_token_time is None:
            self.first_token_time = now
        self.generated.append(token)

    def should_stop(self) -> Optional[str]:
        if self.generated and self.generated[-1] == self.sampling.stop_token:
            return "stop_token"
        if self.num_generated >= self.sampling.max_new_tokens:
            return "length"
        return None

    def finish(self, reason: str, now: float) -> None:
        self.status = SequenceStatus.FINISHED
        self.finish_reason = reason
        self.finish_time = now

    def preempt(self) -> None:
        """Recompute-style eviction: drop KV, keep generated tokens."""
        assert not self.is_finished
        self.status = SequenceStatus.WAITING
        self.block_ids = []
        self.cache_len = 0
        self.prefill_cursor = 0
        self.prefix_hashes = []
        self.num_preemptions += 1

    # -- metrics ------------------------------------------------------------

    def latency(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Sequence(id={self.req_id}, status={self.status.value}, "
                f"prompt={len(self.prompt)}, gen={self.num_generated}, "
                f"blocks={len(self.block_ids)}, preempt={self.num_preemptions})")
