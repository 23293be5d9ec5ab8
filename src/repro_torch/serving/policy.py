"""Adaptive LAMP policy controller: per-layer threshold actuation with
load-aware graceful degradation (the port's copy of
``repro/serving/policy.py``, which imports numpy only; the code is the
same line for line). In the port the per-layer thresholds are one (L,)
float32 tensor on the device that the CUDA kernel reads, written in place
by the engine's ``_policy_update``, and a rule-tier swap changes the
``site.rule`` the kernel is launched with; the words "traced operand" and
"recompile" below are the JAX engine's.

The static LAMP site config fixes one tau for every layer for the lifetime
of the process. This module closes the loop instead: each engine step the
controller reads the serving telemetry the engine already produces --
per-layer recompute rates, KV-pool utilization, preemption pressure, step
wall time, speculative acceptance -- and actuates three knobs:

  tau (per layer)   -- the LAMP selection threshold, threaded through the
                       jitted steps as a *traced (L,) operand* (scalar
                       prefetch in the pallas kernels), so moving it never
                       recompiles. Driven toward per-layer target recompute
                       rates by a multiplicative log-space law with a
                       deadband (hysteresis) and a clamped slew rate.
  draft_len         -- the speculative lookahead, a host integer the
                       scheduler reads per round (shortening it is
                       recompile-free).
  rule              -- the LAMP rule tier; under sustained pressure the
                       controller drops one tier (strict -> relaxed ->
                       none). Changing the rule is a static config change
                       (one recompile per tier per bucket), so it is the
                       *last* resort of the degradation ladder.

Degradation ladder (mode):

  NORMAL   -- track target recompute rates.
  RELAXED  -- pool utilization crossed util_high (or the step-latency SLO
              is missed): targets are scaled down by relaxed_target_scale
              (recompute less, run cheaper) and the draft length is
              halved. Exits back to NORMAL only below util_low -- the
              enter/exit gap is the mode hysteresis.
  SHED     -- utilization crossed shed_util or the pool started preempting:
              tau slews up at the full rate toward tau_max, speculation is
              shed when its acceptance rate is below shed_accept (accepted
              lookahead finishes sequences in fewer rounds and frees their
              blocks sooner, so high-value speculation is kept even under
              pressure), and (with degrade_rule) the rule drops one tier.
              Exits to RELAXED (never straight to NORMAL) once utilization
              is back under util_high and preemptions stop.

Every actuation is observable: `lamp_tau{layer}` gauges, a `policy_mode`
gauge, a `policy_actuations_total` counter, and (with tracing on) instant
events on the Chrome-trace timeline. `frozen=True` runs the whole loop --
signals, mode tracking, gauges -- but never actuates, which is the
token-identity control arm the differential tests pin.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

MODE_NORMAL = 0
MODE_RELAXED = 1
MODE_SHED = 2
MODE_NAMES = ("normal", "relaxed", "shed")

# one-tier graceful degradation of the LAMP rule under SHED: the relaxed
# rule (9) is FlashAttention-safe and cheaper than strict's full softmax;
# "none" is the pure low-precision forward (zero recompute)
_RULE_LADDER = {"strict": "relaxed", "relaxed_ln": "relaxed",
                "relaxed": "none", "none": "none"}


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Knobs of the adaptive LAMP policy loop (all host-side)."""
    enabled: bool = False
    # per-layer recompute-rate target; target_rates (len n_layers)
    # overrides the scalar for heterogeneous layer sensitivity
    target_rate: float = 0.05
    target_rates: Optional[Sequence[float]] = None
    # actuation clamps: tau stays in [tau_min, tau_max] and moves at most
    # max_step in log space per actuation (slew limit)
    tau_min: float = 1e-4
    tau_max: float = 0.9
    gain: float = 0.5
    max_step: float = 0.25
    # deadband hysteresis: no actuation while |rate - target| is within
    # deadband * target (prevents oscillation around the setpoint)
    deadband: float = 0.1
    # actuate every `interval` engine steps; rate EMA smoothing weight of
    # the newest sample
    interval: int = 1
    ema: float = 0.5
    # mode ladder thresholds (pool utilization in [0, 1]); util_high enters
    # RELAXED, util_low exits it, shed_util (or any preemption) enters SHED
    util_high: float = 0.92
    util_low: float = 0.75
    shed_util: float = 0.98
    # step-latency SLO (seconds); 0 disables the latency pressure signal
    latency_slo_s: float = 0.0
    # RELAXED scales the rate targets down by this factor
    relaxed_target_scale: float = 0.5
    # SHED knobs: drop speculation / drop the rule one ladder tier.
    # Speculation is only shed while the cumulative acceptance rate is
    # below shed_accept: low-value lookahead wastes pool blocks it holds,
    # but high-value lookahead finishes sequences in fewer rounds and
    # frees their blocks sooner than plain decode would -- shedding it
    # under memory pressure is counterproductive.
    shed_draft: bool = True
    shed_accept: float = 0.5
    degrade_rule: bool = True
    # observe-only: run signals, mode tracking, and gauges, actuate nothing
    frozen: bool = False

    def __post_init__(self):
        if not (0.0 < self.tau_min <= self.tau_max < 1.0):
            raise ValueError(
                f"need 0 < tau_min <= tau_max < 1, got "
                f"[{self.tau_min}, {self.tau_max}]")
        if self.max_step <= 0 or self.gain < 0:
            raise ValueError("max_step must be > 0 and gain >= 0")
        if not (0.0 < self.ema <= 1.0):
            raise ValueError(f"ema weight must be in (0, 1], got {self.ema}")
        if self.interval < 1:
            raise ValueError(f"interval must be >= 1, got {self.interval}")
        if not (0.0 <= self.util_low <= self.util_high <= self.shed_util):
            raise ValueError(
                "need util_low <= util_high <= shed_util, got "
                f"{self.util_low}/{self.util_high}/{self.shed_util}")


@dataclasses.dataclass
class PolicySignals:
    """One step's telemetry, as read from the engine."""
    layer_rates: Optional[np.ndarray]   # (L,) recompute rates, None if the
                                        # step produced no LAMP counts
    utilization: float                  # pool blocks-in-use fraction
    preemptions: int                    # cumulative scheduler preemptions
    step_latency_s: float               # wall time of the step
    spec_acceptance: float = 0.0        # cumulative draft acceptance rate
    recoveries: int = 0                 # cumulative engine recovery actions
                                        # (health-guard retries, alloc
                                        # deferrals, split fallbacks) -- a
                                        # recovering engine is a stressed
                                        # engine, so deltas act as pressure


@dataclasses.dataclass
class PolicyActions:
    """What the controller wants the engine to apply for the next step."""
    taus: np.ndarray                    # (L,) float32 thresholds
    mode: int
    rule: Optional[str]                 # None = the engine's base rule
    draft_len: int
    changed: bool                       # did anything actuate this update?


class PolicyController:
    """The feedback loop. Owns tau state in log space; `update()` ingests
    one `PolicySignals` and returns the `PolicyActions` to apply."""

    def __init__(self, config: PolicyConfig, n_layers: int, tau0,
                 *, base_rule: str = "relaxed", base_draft_len: int = 0,
                 obs=None):
        self.config = config
        self.n_layers = n_layers
        t0 = np.broadcast_to(np.asarray(tau0, np.float64),
                             (n_layers,)).copy()
        # base thresholds, returned verbatim while frozen (token identity);
        # the live log-tau state starts from the clamped version
        self._tau_base = t0.astype(np.float32)
        self._log_tau = np.log(np.clip(t0, config.tau_min, config.tau_max))
        if config.target_rates is not None:
            tr = np.asarray(list(config.target_rates), np.float64)
            if tr.shape != (n_layers,):
                raise ValueError(
                    f"target_rates must have length {n_layers}, "
                    f"got {tr.shape}")
            self._targets = tr
        else:
            self._targets = np.full((n_layers,), config.target_rate,
                                    np.float64)
        # audit-calibrated state (set_error_targets): replaces the
        # configured targets with error-model-derived ones, and optionally
        # carries the RELAXED guardrail mask (False = this layer's audited
        # flip rate exceeds its error budget; never relax it)
        self._relax_ok: Optional[np.ndarray] = None
        self.target_updates = 0
        self.base_rule = base_rule
        self.base_draft_len = base_draft_len
        self.mode = MODE_NORMAL
        self.mode_transitions = 0
        self.actuations = 0
        self._ema: Optional[np.ndarray] = None
        self._last_preemptions = 0
        self._last_recoveries = 0
        self._accept = 0.0
        self._updates = 0
        self._obs = obs
        if obs is not None:
            reg = obs.registry
            fam = reg.gauge("lamp_tau", help="live LAMP threshold by layer",
                            labels=("layer",))
            self._g_tau = [fam.labels(str(l)) for l in range(n_layers)]
            self._g_mode = reg.gauge(
                "policy_mode", help="0=normal 1=relaxed 2=shed")
            self._g_pressure = reg.gauge(
                "policy_pressure", help="pool utilization the policy saw")
            self._c_actuations = reg.counter(
                "policy_actuations_total",
                help="updates that moved tau, the rule, or the draft length")
            self._c_transitions = reg.counter(
                "policy_mode_transitions_total",
                help="degradation-ladder mode changes", labels=("to",))
            self._c_target_updates = reg.counter(
                "policy_target_updates_total",
                help="error-model calibrations applied to the rate targets")
            self._g_target = reg.gauge(
                "lamp_target_rate", help="live recompute-rate target by "
                "layer (audit-calibrated when the shadow audit is on)",
                labels=("layer",))
            for l in range(n_layers):
                self._g_target.labels(str(l)).set(float(self._targets[l]))
            for g, t in zip(self._g_tau, self._tau_base):
                g.set(float(t))
            self._g_mode.set(MODE_NORMAL)
        else:
            self._g_tau = None

    # -- the loop ------------------------------------------------------------

    @property
    def taus(self) -> np.ndarray:
        """Current thresholds (the base ones while frozen)."""
        if self.config.frozen:
            return self._tau_base
        return np.exp(self._log_tau).astype(np.float32)

    def set_error_targets(self, targets, relax_ok=None) -> None:
        """Install audit-calibrated per-layer recompute-rate targets.

        `targets` ((L,) float) comes from obs/error_model.py: the scalar
        default redistributed in proportion to each layer's amplified
        audited error. `relax_ok` ((L,) bool, optional) is the degradation
        guardrail: layers marked False have audited argmax flip rates over
        their error budget, so RELAXED keeps their *full* target (no
        relaxed_target_scale) and SHED holds their tau instead of slewing
        it toward tau_max -- load never buys throughput with tokens those
        layers are already visibly flipping. Overrides config.target_rate /
        config.target_rates until the next call."""
        t = np.asarray(targets, np.float64)
        if t.shape != (self.n_layers,):
            raise ValueError(
                f"targets must have shape ({self.n_layers},), got {t.shape}")
        if np.any(t <= 0.0) or np.any(t > 1.0):
            raise ValueError("targets must be in (0, 1]")
        self._targets = t
        if relax_ok is not None:
            ok = np.asarray(relax_ok, bool)
            if ok.shape != (self.n_layers,):
                raise ValueError(
                    f"relax_ok must have shape ({self.n_layers},), "
                    f"got {ok.shape}")
            self._relax_ok = ok
        else:
            self._relax_ok = None
        self.target_updates += 1
        if self._obs is not None:
            self._c_target_updates.inc()
            for l in range(self.n_layers):
                self._g_target.labels(str(l)).set(float(t[l]))
            if self._obs.tracer.enabled:
                self._obs.tracer.instant(
                    "policy_targets", cat="policy",
                    target_mean=round(float(t.mean()), 6),
                    target_max=round(float(t.max()), 6),
                    guarded=int(0 if self._relax_ok is None
                                else (~self._relax_ok).sum()))

    def _next_mode(self, sig: PolicySignals, d_preempt: int,
                   slo_miss: bool) -> int:
        c = self.config
        if self.mode == MODE_NORMAL:
            if sig.utilization >= c.shed_util or d_preempt > 0:
                return MODE_SHED
            if sig.utilization >= c.util_high or slo_miss:
                return MODE_RELAXED
        elif self.mode == MODE_RELAXED:
            if sig.utilization >= c.shed_util or d_preempt > 0:
                return MODE_SHED
            if sig.utilization <= c.util_low and not slo_miss:
                return MODE_NORMAL
        else:  # SHED exits one rung at a time (never straight to NORMAL)
            if sig.utilization < c.util_high and d_preempt == 0:
                return MODE_RELAXED
        return self.mode

    def update(self, sig: PolicySignals) -> PolicyActions:
        c = self.config
        self._updates += 1
        if sig.layer_rates is not None:
            r = np.asarray(sig.layer_rates, np.float64)
            self._ema = (r if self._ema is None
                         else c.ema * r + (1.0 - c.ema) * self._ema)
        d_preempt = max(0, sig.preemptions - self._last_preemptions)
        self._last_preemptions = sig.preemptions
        d_recover = max(0, sig.recoveries - self._last_recoveries)
        self._last_recoveries = sig.recoveries
        self._accept = sig.spec_acceptance
        # recovery pressure rides the slo_miss rail: a step that needed a
        # health-guard retry / alloc deferral / split fallback pushes the
        # ladder toward RELAXED and blocks the exit to NORMAL, exactly like
        # a latency-SLO miss
        slo_miss = (c.latency_slo_s > 0
                    and sig.step_latency_s > c.latency_slo_s) \
            or d_recover > 0

        new_mode = self._next_mode(sig, d_preempt, slo_miss)
        mode_changed = new_mode != self.mode
        if mode_changed:
            self.mode = new_mode
            self.mode_transitions += 1
            if self._obs is not None:
                self._c_transitions.labels(MODE_NAMES[new_mode]).inc()
                if self._obs.tracer.enabled:
                    self._obs.tracer.instant(
                        "policy_mode", cat="policy",
                        mode=MODE_NAMES[new_mode],
                        util=round(sig.utilization, 4),
                        preempt_delta=d_preempt)

        moved = False
        if not c.frozen and self._updates % c.interval == 0:
            moved = self._actuate_tau()
        # an "actuation" is an update that applies something to the engine;
        # frozen tracks modes for observability but never applies, so its
        # mode changes are not actuations
        changed = moved or (mode_changed and not c.frozen)

        rule = None
        draft = self._draft_for_mode()
        if not c.frozen and self.mode == MODE_SHED and c.degrade_rule:
            rule = _RULE_LADDER[self.base_rule]

        if self._obs is not None:
            self._g_mode.set(self.mode)
            self._g_pressure.set(sig.utilization)
            if changed:
                self._c_actuations.inc()
                taus = self.taus
                for g, t in zip(self._g_tau, taus):
                    g.set(float(t))
                if self._obs.tracer.enabled:
                    self._obs.tracer.instant(
                        "policy_actuate", cat="policy",
                        mode=MODE_NAMES[self.mode],
                        tau_mean=round(float(taus.mean()), 6),
                        tau_min=round(float(taus.min()), 6),
                        tau_max=round(float(taus.max()), 6),
                        draft_len=draft)
        if changed:
            self.actuations += 1
        return PolicyActions(taus=self.taus, mode=self.mode, rule=rule,
                             draft_len=draft, changed=changed)

    def _draft_for_mode(self) -> int:
        """Speculative lookahead under the current mode: full in NORMAL,
        and -- when acceptance says the lookahead is not earning its
        blocks -- halved (min 1) in RELAXED, shed in SHED. Accepting
        lookahead drains the pool (fewer rounds per sequence), so it is
        kept while the acceptance rate clears shed_accept."""
        c = self.config
        if c.frozen or self.mode == MODE_NORMAL:
            return self.base_draft_len
        if self._accept >= c.shed_accept:
            return self.base_draft_len
        if self.mode == MODE_RELAXED:
            return min(self.base_draft_len, max(1, self.base_draft_len // 2))
        return 0 if c.shed_draft else self.base_draft_len

    def _actuate_tau(self) -> bool:
        """One slew of the log-space threshold law. Returns True if any
        layer's tau moved."""
        c = self.config
        if self.mode == MODE_SHED:
            # pressure overrides tracking: push every layer toward tau_max
            # at the full slew rate (monotone pressure response) -- except
            # layers the audit guardrail froze out of relaxation, which
            # hold where they are
            dlog = np.full((self.n_layers,), c.max_step)
            if self._relax_ok is not None:
                dlog = np.where(self._relax_ok, dlog, 0.0)
        elif self._ema is None:
            return False
        else:
            if self.mode == MODE_RELAXED:
                # guardrail: scaled-down (cheaper) targets only for layers
                # whose audited flip rate is inside budget
                scaled = self._targets * c.relaxed_target_scale
                targets = (scaled if self._relax_ok is None
                           else np.where(self._relax_ok, scaled,
                                         self._targets))
            else:
                targets = self._targets
            eps = 1e-9
            dlog = np.clip(c.gain * np.log((self._ema + eps)
                                           / (targets + eps)),
                           -c.max_step, c.max_step)
            # deadband: inside the tolerance around the setpoint, hold
            dlog[np.abs(self._ema - targets) <= c.deadband * targets] = 0.0
        new = np.clip(self._log_tau + dlog,
                      np.log(c.tau_min), np.log(c.tau_max))
        moved = bool(np.any(new != self._log_tau))
        self._log_tau = new
        return moved

    # -- reporting -----------------------------------------------------------

    def stats(self) -> dict:
        taus = self.taus
        return {
            "enabled": self.config.enabled,
            "frozen": self.config.frozen,
            "mode": MODE_NAMES[self.mode],
            "mode_transitions": self.mode_transitions,
            "actuations": self.actuations,
            "tau_mean": float(taus.mean()),
            "tau_min": float(taus.min()),
            "tau_max": float(taus.max()),
            "rate_ema": ([] if self._ema is None
                         else [float(x) for x in self._ema]),
            "draft_len": self._draft_for_mode(),
            "targets": [float(x) for x in self._targets],
            "target_updates": self.target_updates,
            "guarded_layers": (0 if self._relax_ok is None
                               else int((~self._relax_ok).sum())),
        }
