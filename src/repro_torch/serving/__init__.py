"""Continuous-batching LAMP serving engine on the fused step.

  request.py   -- Request/Sequence lifecycle (a copy of the JAX package's)
  faults.py    -- the fault types the pool and scheduler raise
  kv_pool.py   -- paged KV pool: refcounted block tables over a torch arena,
                  chain-hashed prefix index with copy-on-write sharing
  scheduler.py -- FCFS admission, chunked prefill, preemption, mixed plans
  sampling.py  -- per-row greedy / Gumbel-max sampling
  engine.py    -- the step loop over ``models.transformer.paged_mixed_step``
"""

from .engine import EngineConfig, LampEngine, RequestOutput
from .faults import ArenaAllocFault
from .kv_pool import PagedKVPool
from .request import SamplingParams, Sequence, SequenceStatus
from .scheduler import Scheduler, StepPlan

__all__ = ["EngineConfig", "LampEngine", "RequestOutput", "ArenaAllocFault",
           "PagedKVPool", "SamplingParams", "Sequence", "SequenceStatus",
           "Scheduler", "StepPlan"]
