"""Deterministic fault injection for the serving engine (chaos testing; the
port's copy of ``repro/serving/faults.py``).

A production engine's recovery paths are exactly the code that never runs
in a clean test suite. This module makes them run, *reproducibly*: every
fault decision is a pure function of (step, site, salt) through the same
splitmix64 mixing the shadow audit samples with (obs/audit.py), so a chaos
stream replays bit-for-bit -- the same steps fault, the same rows are
poisoned, the same allocations fail -- across processes and platforms.

Fault sites (each with its own rate knob):

  nan    -- poison one live row's step output: its returned health value
            goes non-finite and the KV positions the row wrote this step
            are overwritten with NaN in the arena, simulating a kernel
            that produced garbage for that row. The engine's health guard
            quarantines the row and the recovery ladder re-runs its
            window (which rewrites exactly the poisoned span).
  alloc  -- arm the KV pool to fail its next block allocation with
            `ArenaAllocFault` (raised before any pool state mutates). The
            scheduler degrades: the affected admission/window/decode
            grant is deferred or retried, never crashed.
  draft  -- corrupt one row's speculative draft proposals after the draft
            scan returns. No dedicated recovery exists because the verify
            pass *is* the recovery: corrupt proposals are rejected by the
            accept rule and the verifier's own token is emitted (greedy
            streams stay token-identical by construction).
  step   -- fail the fused mixed launch before it runs (`StepLaunchFault`);
            the engine degrades that step to the split-execution twin
            (`mixed_exec="split"`) and recovers.
  stall  -- wedge the engine for `stall_steps` consecutive steps (each
            reported as a `stall_s` latency spike): step() schedules
            nothing and makes no progress, exercising the
            run_to_completion stall watchdog, which clears the wedge and
            evicts the stalled rows instead of raising.

At most one fault fires per (site, step): sites are independent, replays
are stable under engine-internal refactors (the hash keys on the engine
step counter, not wall time), and `max_faults` bounds the total chaos a
long stream absorbs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.audit import audit_hash

__all__ = ["FaultConfig", "FaultInjector", "FaultError", "ArenaAllocFault",
           "StepLaunchFault", "fault_hash", "FAULT_SITES"]

FAULT_SITES = ("nan", "alloc", "draft", "step", "stall")

# stable per-site key offsets for the hash (never reordered: replays of
# recorded chaos streams depend on them)
_SITE_IDS = {site: 0x5EED + 131 * i for i, site in enumerate(FAULT_SITES)}


class FaultError(RuntimeError):
    """Base class for injected faults (never raised by real failures)."""


class ArenaAllocFault(FaultError):
    """Simulated KV-pool block-allocation failure (raised by
    `PagedKVPool.alloc` when armed, before any pool state mutates)."""


class StepLaunchFault(FaultError):
    """Simulated fused-step launch failure (raised before the step's first
    launch, so no device or bookkeeping state has changed)."""


def fault_hash(step: int, site: str, salt: int = 0) -> float:
    """Deterministic (step, site, salt) -> [0, 1): the audit sampler's
    splitmix64 mixing with the site's stable id in the request slot."""
    return audit_hash(step, _SITE_IDS[site], salt)


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Fault-injection knobs (hashable: lives inside frozen EngineConfig).

    All rates are per-engine-step firing probabilities in [0, 1]; 0
    disables that site. `enabled=False` (the default) constructs no
    injector at all -- zero hot-path cost. `salt` is the replay key:
    the same stream with the same salt injects the same faults."""
    enabled: bool = False
    salt: int = 0
    nan_rate: float = 0.0       # poison one row's step output / written KV
    alloc_rate: float = 0.0     # fail the pool's next block allocation
    draft_rate: float = 0.0     # corrupt one row's draft proposals
    step_rate: float = 0.0      # fail the fused launch (-> split twin)
    stall_rate: float = 0.0     # wedge the engine for stall_steps steps
    stall_steps: int = 4        # consecutive wedged steps per stall event
    stall_s: float = 0.25       # simulated wall-clock cost per wedged step
    max_faults: int = 0         # total injection budget (0 = unbounded)

    def __post_init__(self):
        for f in ("nan_rate", "alloc_rate", "draft_rate", "step_rate",
                  "stall_rate"):
            r = getattr(self, f)
            if not 0.0 <= r <= 1.0:
                raise ValueError(f"fault {f} must be in [0, 1], got {r}")
        if self.stall_steps < 1:
            raise ValueError(
                f"fault stall_steps must be >= 1, got {self.stall_steps}")
        if self.stall_s < 0:
            raise ValueError(f"fault stall_s must be >= 0, got {self.stall_s}")
        if self.max_faults < 0:
            raise ValueError(
                f"fault max_faults must be >= 0, got {self.max_faults}")

    @property
    def any_rate(self) -> bool:
        return any(getattr(self, f"{s}_rate") > 0 for s in FAULT_SITES)


class FaultInjector:
    """Replayable fault scheduler + accounting.

    The engine asks `fires(step, site)` at each site's hook point; the
    decision is the pure hash above gated by the site's rate, the global
    `max_faults` budget, and a one-per-(site, step) latch (so the split
    twin re-executing a plan's sub-steps cannot double-inject). Injections
    the engine actually applied are recorded through `record`, which
    feeds `engine_faults_injected_total{site}` and a trace instant."""

    def __init__(self, config: FaultConfig, obs=None) -> None:
        self.config = config
        self._obs = obs
        self.injected = 0
        self.by_site: Dict[str, int] = {s: 0 for s in FAULT_SITES}
        self._fired_at: Dict[str, int] = {}
        self._stall_left = 0
        self._c_site = None
        if obs is not None:
            fam = obs.registry.counter(
                "engine_faults_injected_total",
                help="deterministic fault injections by site",
                labels=("site",))
            self._c_site = {s: fam.labels(s) for s in FAULT_SITES}

    # -- decisions ----------------------------------------------------------

    def fires(self, step: int, site: str) -> bool:
        rate = getattr(self.config, f"{site}_rate")
        if rate <= 0.0:
            return False
        if self.config.max_faults and self.injected >= self.config.max_faults:
            return False
        if self._fired_at.get(site) == step:
            return False
        return rate >= 1.0 or fault_hash(step, site, self.config.salt) < rate

    def pick_row(self, step: int, site: str,
                 req_ids: Sequence[int]) -> Optional[int]:
        """Deterministic victim row: the live request whose (step, request,
        site-salted) hash ranks first -- stable under batch composition of
        the *other* rows. None when the batch is empty."""
        if not req_ids:
            return None
        salt = self.config.salt ^ _SITE_IDS[site]
        return min(range(len(req_ids)),
                   key=lambda i: (audit_hash(step, int(req_ids[i]) + 1,
                                             salt), i))

    def record(self, step: int, site: str, **detail) -> None:
        """Mark one applied injection (latches the (site, step) pair)."""
        self.injected += 1
        self.by_site[site] += 1
        self._fired_at[site] = step
        if self._c_site is not None:
            self._c_site[site].inc()
        if self._obs is not None and self._obs.tracer.enabled:
            self._obs.tracer.instant(f"fault:{site}", cat="fault",
                                     step=step, **detail)

    # -- stall state --------------------------------------------------------

    def maybe_stall(self, step: int) -> bool:
        """True while the engine is wedged. A fresh stall event arms
        `stall_steps` wedged steps; each call consumes one."""
        if self._stall_left <= 0 and self.fires(step, "stall"):
            self._stall_left = self.config.stall_steps
            self.record(step, "stall", steps=self.config.stall_steps)
        if self._stall_left > 0:
            self._stall_left -= 1
            return True
        return False

    @property
    def stalled(self) -> bool:
        return self._stall_left > 0

    def clear_stall(self) -> None:
        """Watchdog recovery hook: end the current stall event early."""
        self._stall_left = 0

    # -- reporting ----------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        return {"enabled": True, "injected": self.injected,
                "by_site": dict(self.by_site)}
