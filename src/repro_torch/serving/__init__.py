"""Continuous-batching LAMP serving engine.

  request.py   -- Request/Sequence lifecycle (a copy of the JAX package's)
  faults.py    -- deterministic fault injection (a copy of the JAX
                  package's): seeded, hash-sampled fault sites (NaN
                  poisoning, allocation failure, draft corruption, fused-step
                  anomaly, stall) replayable bit for bit; drives the engine's
                  health guard, recovery ladder and watchdog under test
  kv_pool.py   -- paged KV pool: refcounted block tables over a torch arena,
                  chain-hashed prefix index with copy-on-write sharing
  scheduler.py -- FCFS admission, chunked prefill, preemption; mixed or
                  phase-segregated plans
  sampling.py  -- per-row greedy / Gumbel-max sampling on JAX's threefry
                  keys and bits
  speculative.py -- LAMP self-draft speculative decoding
  policy.py    -- adaptive LAMP policy controller (a copy of the JAX
                  package's): per-layer thresholds toward target recompute
                  rates, load-aware degradation of draft length and rule
  engine.py    -- the step loop over ``models.transformer.paged_mixed_step``
                  (or, phase-segregated, its prefill / decode / speculative
                  sub-steps), with the shadow audit (``repro_torch.obs.audit``)
"""

from repro_torch.obs.audit import AuditConfig

from .engine import EngineConfig, LampEngine, QueueFullError, RequestOutput
from .faults import (FAULT_SITES, ArenaAllocFault, FaultConfig, FaultError,
                     FaultInjector, StepLaunchFault, fault_hash)
from .kv_pool import PagedKVPool
from .policy import (MODE_NAMES, MODE_NORMAL, MODE_RELAXED, MODE_SHED,
                     PolicyActions, PolicyConfig, PolicyController,
                     PolicySignals)
from .request import SamplingParams, Sequence, SequenceStatus
from .scheduler import Scheduler, StepPlan
from .speculative import SpecConfig

__all__ = [
    "EngineConfig", "LampEngine", "RequestOutput", "PagedKVPool",
    "SamplingParams", "Sequence", "SequenceStatus", "Scheduler", "StepPlan",
    "SpecConfig", "PolicyConfig", "PolicyController", "PolicySignals",
    "PolicyActions", "MODE_NAMES", "MODE_NORMAL", "MODE_RELAXED",
    "MODE_SHED", "AuditConfig", "QueueFullError", "FAULT_SITES", "FaultConfig",
    "FaultInjector", "FaultError", "ArenaAllocFault", "StepLaunchFault",
    "fault_hash",
]
