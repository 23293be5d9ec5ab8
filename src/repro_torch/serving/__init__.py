"""Continuous-batching LAMP serving engine on the fused step.

  request.py   -- Request/Sequence lifecycle (a copy of the JAX package's)
  faults.py    -- deterministic fault injection (a copy of the JAX
                  package's): seeded, hash-sampled fault sites (NaN
                  poisoning, allocation failure, draft corruption, fused-step
                  anomaly, stall) replayable bit for bit; drives the engine's
                  health guard, recovery ladder and watchdog under test
  kv_pool.py   -- paged KV pool: refcounted block tables over a torch arena,
                  chain-hashed prefix index with copy-on-write sharing
  scheduler.py -- FCFS admission, chunked prefill, preemption, mixed plans
  sampling.py  -- per-row greedy / Gumbel-max sampling
  engine.py    -- the step loop over ``models.transformer.paged_mixed_step``
"""

from .engine import EngineConfig, LampEngine, QueueFullError, RequestOutput
from .faults import (FAULT_SITES, ArenaAllocFault, FaultConfig, FaultError,
                     FaultInjector, StepLaunchFault, fault_hash)
from .kv_pool import PagedKVPool
from .request import SamplingParams, Sequence, SequenceStatus
from .scheduler import Scheduler, StepPlan

__all__ = ["EngineConfig", "LampEngine", "RequestOutput", "PagedKVPool",
           "SamplingParams", "Sequence", "SequenceStatus", "Scheduler",
           "StepPlan", "QueueFullError", "FAULT_SITES", "FaultConfig",
           "FaultInjector", "FaultError", "ArenaAllocFault",
           "StepLaunchFault", "fault_hash"]
