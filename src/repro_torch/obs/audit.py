"""Online shadow-audit: measure the error LAMP actually realizes, live
(the port's copy of ``repro/obs/audit.py``, which imports numpy only; the
shadow forward is the port's ``transformer.paged_audit_window``).

The serving stack's telemetry observes recompute *rates* -- the paper's
control variable -- but never the *error* those rates are supposed to
suppress. This module closes that gap: on a deterministic sample of serving
steps the engine replays the step's rows through
`transformer.paged_audit_window` (LAMP arm + FP32 reference arm in lockstep,
gather path, non-donated arena, metrics-only return), so realized error is
measured in production without perturbing a single served token.

Sampling is a pure function of (step, request, salt) via a splitmix64-style
hash: re-running the same request stream audits the same rows, so an
accuracy regression seen in telemetry is *replayable* -- rerun with the same
salt and the same steps get audited again. Audited steps select up to
`max_rows` rows (ranked by the same hash) to bound the shadow batch and keep
overhead at the configured rate rather than at the row count.

Telemetry lands in the metrics registry and tracer as `lamp_audit_*` counters and
histograms, a Perfetto counter track, a bounded ring of recent audited steps
(surfaced by the hang diagnostic), and `stats()["audit"]`. When calibration
is on and a policy controller is attached, audited per-layer local errors
feed obs/error_model.py to derive per-layer recompute-rate targets and the
RELAXED guardrail mask (see `ShadowAuditor.maybe_calibrate`).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import Observability
from .error_model import attribute_flips, calibrate

__all__ = ["AuditConfig", "ShadowAuditor", "audit_hash", "select_rows"]

_MASK64 = (1 << 64) - 1

# relative-error histogram edges: 1e-8 .. 1, ~x10 per bucket, plus a linear
# top end so gross divergence is not one smeared bucket
ERR_EDGES = (1e-8, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 3.16e-2, 1e-1,
             3.16e-1, 1.0)
# top-k overlap is a fraction in [0, 1]
OVERLAP_EDGES = (0.0, 0.2, 0.4, 0.6, 0.8, 0.999)


def audit_hash(step: int, req_id: int, salt: int = 0) -> float:
    """Deterministic (step, request, salt) -> [0, 1) via splitmix64 mixing.

    Pure and platform-independent (no Python `hash`, which is salted per
    process): the audit decision for a given stream replays exactly."""
    x = (step * 0x9E3779B97F4A7C15
         + req_id * 0xBF58476D1CE4E5B9
         + salt * 0x94D049BB133111EB + 0x2545F4914F6CDD1D) & _MASK64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _MASK64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _MASK64
    x ^= x >> 31
    return x / 2.0 ** 64


def select_rows(step: int, req_ids: Sequence[int], rate: float, salt: int,
                max_rows: int) -> List[int]:
    """Indices of the rows audited at `step` (possibly empty).

    Two-level deterministic sampling: the *step* is audited with probability
    `rate` (hash of (step, salt) alone -- request id 0 reserved for the step
    draw), and an audited step shadow-runs up to `max_rows` of its rows,
    ranked by the per-(step, request) hash. Overhead therefore scales with
    `rate` (fraction of steps paying one bounded shadow launch), not with
    the batch size, while row choice stays replayable per request."""
    if rate <= 0.0 or not req_ids:
        return []
    if rate < 1.0 and audit_hash(step, 0, salt) >= rate:
        return []
    ranked = sorted(range(len(req_ids)),
                    key=lambda i: (audit_hash(step, int(req_ids[i]) + 1,
                                              salt), i))
    return sorted(ranked[:max(1, int(max_rows))])


@dataclasses.dataclass(frozen=True)
class AuditConfig:
    """Shadow-audit knobs (hashable: lives inside frozen EngineConfig).

    `rate` is the fraction of engine steps audited (0 disables the
    subsystem entirely -- no auditor is constructed, zero hot-path cost).
    An audited step shadow-runs at most `max_rows` of its rows in one
    extra shadow forward, so per-step overhead ~= rate * (audit forward /
    serving step); its cost on a card is measured, not assumed (the
    ``audit`` span beside the step's wall time). Calibration (on by default) only takes effect
    when the engine also has a policy controller attached."""
    rate: float = 0.0               # fraction of steps audited
    salt: int = 0                   # replay key for the sampling hash
    max_rows: int = 4               # shadow-batch row cap per audited step
    top_k: int = 5                  # overlap set size for topk telemetry
    ring_capacity: int = 64         # recent audited steps kept for stats()
    ema: float = 0.2                # EMA weight for smoothed error/flip rate
    calibrate: bool = True          # feed error-model targets to the policy
    calibrate_every: int = 4        # audited steps between target refreshes
    min_samples: int = 2            # audited steps before first calibration
    flip_budget: float = 0.02       # per-layer attributed flip-rate budget
    min_rate: float = 0.005         # target clamp floor (error model)
    max_rate: float = 0.5           # target clamp ceiling (error model)

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"audit rate must be in [0, 1], got {self.rate}")
        if not 0.0 < self.ema <= 1.0:
            raise ValueError(f"audit ema must be in (0, 1], got {self.ema}")
        for f in ("max_rows", "top_k", "ring_capacity", "calibrate_every",
                  "min_samples"):
            if getattr(self, f) < 1:
                raise ValueError(f"audit {f} must be >= 1")
        if not 0.0 <= self.flip_budget <= 1.0:
            raise ValueError("audit flip_budget must be in [0, 1]")
        if not 0.0 < self.min_rate <= self.max_rate <= 1.0:
            raise ValueError("audit rate clamp must satisfy "
                             "0 < min_rate <= max_rate <= 1")


class ShadowAuditor:
    """Accounting + calibration state for the shadow-audit subsystem.

    The engine owns scheduling and shadow execution (it knows plans
    and step buckets); this object owns everything downstream of the
    metrics dict the audit launch returns: registry counters/histograms,
    per-layer error EMAs, the audited-step ring, per-request accumulation,
    and the calibration pass into the policy controller."""

    def __init__(self, config: AuditConfig, n_layers: int,
                 obs: Observability) -> None:
        self.config = config
        self.n_layers = n_layers
        self.obs = obs
        L = n_layers
        # smoothed per-layer local/cumulative error and end-to-end flip rate
        self.kq_err = np.zeros((L,), np.float64)
        self.router_err = np.zeros((L,), np.float64)
        self.cum_err = np.zeros((L,), np.float64)
        self.flip_rate = 0.0
        self.logit_rel = 0.0
        self.audited_steps = 0
        self.audited_rows = 0
        self.calibrations = 0
        self.ring: Deque[Dict[str, Any]] = deque(maxlen=config.ring_capacity)
        self._last_targets: Optional[np.ndarray] = None
        self._last_relax_ok: Optional[np.ndarray] = None

        reg = obs.registry
        c = reg.counter("lamp_audit_steps_total",
                        help="engine steps shadow-audited")
        self._c_steps = c
        self._c_rows = reg.counter("lamp_audit_rows_total",
                                   help="request rows shadow-audited")
        self._c_flips = reg.counter(
            "lamp_audit_flips_total",
            help="audited rows whose greedy argmax token flipped "
                 "LAMP-vs-reference")
        err = reg.counter(
            "lamp_audit_layer_err_total",
            help="summed audited per-layer relative error by site "
                 "(kq/router = local shadow error, cum = carried "
                 "hidden-state drift); divide by lamp_audit_steps_total "
                 "for the mean",
            labels=("layer", "site"))
        self._c_kq = [err.labels(str(l), "kq") for l in range(L)]
        self._c_router = [err.labels(str(l), "router") for l in range(L)]
        self._c_cum = [err.labels(str(l), "cum") for l in range(L)]
        self._h_rel = reg.histogram(
            "lamp_audit_logit_rel_err", edges=ERR_EDGES,
            help="per audited row: final-logit relative L2 error")
        self._h_abs = reg.histogram(
            "lamp_audit_logit_max_abs_err", edges=ERR_EDGES,
            help="per audited row: final-logit max abs error")
        self._h_topk = reg.histogram(
            "lamp_audit_topk_overlap", edges=OVERLAP_EDGES,
            help="per audited row: top-k overlap LAMP-vs-reference")
        self._h_req = reg.histogram(
            "lamp_audit_request_cum_err", edges=ERR_EDGES,
            help="per finished request: mean audited logit relative error "
                 "over its audited steps")
        self._c_calib = reg.counter(
            "lamp_audit_calibrations_total",
            help="error-model target refreshes pushed to the policy")

    # -- sampling -----------------------------------------------------------

    def select(self, step: int, req_ids: Sequence[int]) -> List[int]:
        c = self.config
        return select_rows(step, req_ids, c.rate, c.salt, c.max_rows)

    # -- accounting ---------------------------------------------------------

    def account(self, step: int, seqs: Sequence[Any],
                metrics: Dict[str, np.ndarray]) -> None:
        """Fold one audit launch's metrics dict (numpy, per-layer arrays
        full-length, per-row arrays already sliced to the live rows which
        correspond 1:1 to `seqs`) into counters, EMAs and the ring."""
        n = len(seqs)
        kq = np.asarray(metrics["kq_err"], np.float64)
        router = np.asarray(metrics["router_err"], np.float64)
        cum = np.asarray(metrics["cum_err"], np.float64)
        rel = np.asarray(metrics["logit_rel"], np.float64)[:n]
        mabs = np.asarray(metrics["logit_max_abs"], np.float64)[:n]
        flip = np.asarray(metrics["flip"], np.float64)[:n]
        topk = np.asarray(metrics["topk"], np.float64)[:n]

        self._c_steps.inc()
        self._c_rows.inc(n)
        self._c_flips.inc(float(flip.sum()))
        for l in range(self.n_layers):
            self._c_kq[l].inc(float(kq[l]))
            self._c_router[l].inc(float(router[l]))
            self._c_cum[l].inc(float(cum[l]))
        for i in range(n):
            self._h_rel.observe(float(rel[i]))
            self._h_abs.observe(float(mabs[i]))
            self._h_topk.observe(float(topk[i]))

        a = self.config.ema
        first = self.audited_steps == 0
        blend = (lambda old, new: new) if first else (
            lambda old, new: (1 - a) * old + a * new)
        self.kq_err = blend(self.kq_err, kq)
        self.router_err = blend(self.router_err, router)
        self.cum_err = blend(self.cum_err, cum)
        self.flip_rate = float(blend(self.flip_rate, float(flip.mean())))
        self.logit_rel = float(blend(self.logit_rel, float(rel.mean())))
        self.audited_steps += 1
        self.audited_rows += n

        for i, seq in enumerate(seqs):
            seq.audit_samples += 1
            seq.audit_err_sum += float(rel[i])
            seq.audit_flips += int(flip[i])

        self.ring.append({
            "step": int(step), "rows": n,
            "flip_rate": float(flip.mean()),
            "logit_rel_err": float(rel.mean()),
            "topk_overlap": float(topk.mean()),
            "worst_layer": int(np.argmax(kq)) if kq.size else 0,
        })
        self.obs.tracer.counter("lamp_audit",
                                flip_rate=self.flip_rate,
                                logit_rel_err=self.logit_rel)

    def finish_request(self, seq: Any) -> None:
        """Per-request cumulative-error histogram, observed at finish."""
        if getattr(seq, "audit_samples", 0) > 0:
            self._h_req.observe(seq.audit_err_sum / seq.audit_samples)

    # -- calibration --------------------------------------------------------

    def maybe_calibrate(self, policy: Any) -> bool:
        """Push error-derived targets + the RELAXED guardrail mask into the
        policy controller. Returns True when a refresh happened."""
        c = self.config
        if (not c.calibrate or policy is None
                or self.audited_steps < c.min_samples
                or self.audited_steps % c.calibrate_every != 0):
            return False
        err = self.kq_err + self.router_err
        targets, ok = calibrate(
            err, self.flip_rate, policy.config.target_rate,
            flip_budget=c.flip_budget, min_rate=c.min_rate,
            max_rate=c.max_rate)
        policy.set_error_targets(targets, ok)
        self._last_targets, self._last_relax_ok = targets, ok
        self.calibrations += 1
        self._c_calib.inc()
        return True

    # -- inspection ---------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "enabled": True,
            "rate": self.config.rate,
            "audited_steps": self.audited_steps,
            "audited_rows": self.audited_rows,
            "flip_rate": self.flip_rate,
            "logit_rel_err": self.logit_rel,
            "layer_kq_err": [float(x) for x in self.kq_err],
            "layer_router_err": [float(x) for x in self.router_err],
            "layer_cum_err": [float(x) for x in self.cum_err],
            "attributed_flips": [float(x) for x in attribute_flips(
                self.flip_rate, self.kq_err + self.router_err)],
            "calibrations": self.calibrations,
        }
        if self._last_targets is not None:
            d["targets"] = [float(x) for x in self._last_targets]
            d["relax_ok"] = [bool(x) for x in self._last_relax_ok]
        return d

    def ring_tail(self, n: int = 8) -> List[str]:
        """Last n audited steps, formatted for the hang diagnostic."""
        return [
            (f"step={e['step']} rows={e['rows']} "
             f"flip_rate={e['flip_rate']:.3f} "
             f"logit_rel_err={e['logit_rel_err']:.2e} "
             f"topk={e['topk_overlap']:.2f} worst_layer={e['worst_layer']}")
            for e in list(self.ring)[-n:]
        ]
