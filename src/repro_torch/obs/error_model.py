"""Componentwise forward-error model: audited per-layer errors -> targets
(the port's copy of ``repro/obs/error_model.py``, which imports numpy only).

The calibration half of the shadow-audit loop (obs/audit.py measures, this
module converts). Framing, after El arar et al.'s componentwise forward-error
analysis and Budzinskiy et al.'s stability analysis of transformer stacks:
the end-to-end relative error of an L-layer composition is, to first order,
the sum of per-layer *local* errors each amplified by the downstream layers,

    e_total  <~  sum_l  e_l * prod_{m>l} (1 + c_m)  =  sum_l a_l * e_l,

where e_l is the error layer l itself injects (the audit's shadow
measurement: LAMP applied to the reference stream, against the reference)
and a_l the amplification of everything above it. LAMP's knob is the
per-layer recompute rate: more recompute at layer l shrinks e_l roughly in
proportion (the selective-recompute fraction bounds the residual rounding
mass the look-ahead rule lets through). Equalizing every layer's *amplified
contribution* against a uniform split of the total error budget therefore
allocates recompute in proportion to each layer's amplified error share --
layers that inject error the stack amplifies get a larger slice of the same
total recompute budget, quiet layers give theirs up.

All functions are pure numpy on tiny (L,) arrays -- no framework, no engine state
-- so they are trivially testable and callable from the audit hot path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["amplification", "derive_target_rates", "attribute_flips",
           "relax_mask", "calibrate"]

_EPS = 1e-12


def amplification(layer_err: np.ndarray) -> np.ndarray:
    """Downstream amplification factor a_l = prod_{m>l} (1 + e_m).

    Uses the audited local errors themselves as the per-layer gain proxy
    c_m ~= e_m (a layer that perturbs its input by e also perturbs a
    perturbation passing through it by ~e, first order). Computed in
    log-space for stability; a_{L-1} == 1 (the top layer has nothing above
    it to amplify its error)."""
    e = np.asarray(layer_err, np.float64).clip(min=0.0)
    log1p = np.log1p(e)
    # suffix-sum of log(1+e_m) over m > l
    tail = np.concatenate([np.cumsum(log1p[::-1])[::-1][1:], [0.0]])
    return np.exp(tail)


def derive_target_rates(layer_err: np.ndarray, base_rate: float, *,
                        min_rate: float = 0.005, max_rate: float = 0.5,
                        power: float = 0.5) -> np.ndarray:
    """Per-layer recompute-rate targets from audited local errors.

    Each layer's share of the (conserved) total recompute budget is
    proportional to its amplified error contribution a_l * e_l, tempered by
    `power` (0.5 by default: full proportional allocation over-reacts to the
    heavy-tailed error distributions audits actually measure; the square
    root still orders layers by error but caps the spread). The result is
    renormalized so mean(targets) == base_rate -- calibration *redistributes*
    the budget the operator configured, it never inflates it -- then clamped
    to [min_rate, max_rate] (every layer keeps a recompute floor: a layer
    audited quiet today still needs look-ahead coverage to notice when its
    inputs shift).

    With uniform errors this returns base_rate for every layer (the scalar
    default is the fixed point); a layer with above-average amplified error
    always gets a target above base_rate.
    """
    if not 0.0 < base_rate <= 1.0:
        raise ValueError(f"base_rate must be in (0, 1], got {base_rate}")
    e = np.asarray(layer_err, np.float64).clip(min=0.0)
    share = (amplification(e) * e + _EPS) ** power
    t = base_rate * share / max(share.mean(), _EPS)
    t = np.clip(t, min_rate, max_rate)
    return t.astype(np.float64)


def attribute_flips(flip_rate: float, layer_err: np.ndarray) -> np.ndarray:
    """Attribute the audited end-to-end argmax flip rate back to layers.

    The audit observes flips only at the output; the error model splits
    them by each layer's amplified share of the total error mass (the same
    first-order composition bound read backwards). Zero total error
    attributes zero flips everywhere."""
    e = np.asarray(layer_err, np.float64).clip(min=0.0)
    contrib = amplification(e) * e
    total = contrib.sum()
    if total <= _EPS:
        return np.zeros_like(contrib)
    return float(flip_rate) * contrib / total


def relax_mask(flip_rate: float, layer_err: np.ndarray,
               flip_budget: float) -> np.ndarray:
    """Boolean (L,) mask: True where the degradation ladder may RELAX the
    layer (scale its target down / push its tau up under load). A layer
    whose attributed flip rate already exceeds its error budget is *frozen
    out* of relaxation -- degrading it further trades user-visible token
    flips for throughput, which the guardrail forbids."""
    return attribute_flips(flip_rate, layer_err) <= float(flip_budget)


def calibrate(layer_err: np.ndarray, flip_rate: float, base_rate: float, *,
              flip_budget: float, min_rate: float = 0.005,
              max_rate: float = 0.5, power: float = 0.5,
              ) -> Tuple[np.ndarray, np.ndarray]:
    """One calibration pass: (target_rates, relax_ok) for the controller."""
    targets = derive_target_rates(layer_err, base_rate, min_rate=min_rate,
                                  max_rate=max_rate, power=power)
    ok = relax_mask(flip_rate, layer_err, flip_budget)
    return targets, ok
