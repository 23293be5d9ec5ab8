"""LAMP selection rules and exact condition numbers (port of
``repro/core/lamp.py``).

The paper's closed-form solutions of the LAMP problem for the elementary
transformer nonlinearities:

  * softmax, l1-normwise objective  -> threshold rule (8)       [Prop 3.3]
  * softmax, relaxed relative rule  -> rule (9), online-safe     [Sec 4.4]
  * softmax, length-normalized (9)  -> tau * sqrt(n_ref / n)     [App C.5]
  * RMS layer norm, componentwise   -> greedy prefix of the largest y_i^2
                                                                 [Prop 3.2]
  * entrywise activations           -> diagonal threshold        [Sec 3.1]

and the exact kappa evaluators: kappa_c of RMSNorm (Prop 3.1), kappa_1 of
softmax (Prop 3.3), kappa_c of softmax (App B).

All rules return boolean masks (True = recompute in high precision) over the
last axis; `where` restricts both the softmax domain and the selectable set.
Sorts are stable, as JAX's ``argsort`` is, so ties give JAX's masks.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

_NEG_INF = float("-inf")
_TINY = torch.finfo(torch.float32).tiny
_SQRT_HALF = float(np.sqrt(np.float32(0.5)))


def _masked(y: torch.Tensor, where: Optional[torch.Tensor], fill: float) -> torch.Tensor:
    if where is None:
        return y
    return torch.where(where, y, torch.full_like(y, fill))


def masked_softmax(y: torch.Tensor, where: Optional[torch.Tensor] = None,
                   dim: int = -1) -> torch.Tensor:
    """Numerically-stable softmax restricted to `where` (else prob 0)."""
    y = _masked(y, where, _NEG_INF)
    m = torch.amax(y, dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # all-masked rows
    e = torch.exp(y - m)
    if where is not None:
        e = torch.where(where, e, torch.zeros_like(e))
    s = torch.sum(e, dim=dim, keepdim=True)
    return e / torch.clamp(s, min=_TINY)


def select_softmax_strict(y: torch.Tensor, tau,
                          where: Optional[torch.Tensor] = None,
                          z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paper rule (8): q_j = 1 iff 2 z_j (1 - z_j) |y_j| > tau. `z` may pass
    a softmax of `y` the caller already computed."""
    if z is None:
        z = masked_softmax(y, where)
    mask = 2.0 * z * (1.0 - z) * torch.abs(y) > tau
    if where is not None:
        mask = mask & where
    return mask


def select_softmax_relaxed(y: torch.Tensor, tau,
                           where: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paper rule (9) in log space: s_j = y_j + log|y_j| (-inf at y_j = 0,
    which never selects); q_j = s_j > log(tau) + max_i s_i. `tau` may be a
    0-d tensor (the engine's per-layer threshold); log(0) = -inf then
    selects every finite s, as the static tau == 0 branch does."""
    static_tau = isinstance(tau, (int, float))
    if static_tau and not (0.0 <= tau < 1.0):
        raise ValueError(f"relaxed LAMP needs 0 <= tau < 1, got {tau}")
    s = _masked(y + torch.log(torch.abs(y)), where, _NEG_INF)
    smax = torch.amax(s, dim=-1, keepdim=True)
    if static_tau and tau == 0.0:
        mask = torch.isfinite(s)
    else:
        mask = s > torch.log(torch.as_tensor(tau, dtype=torch.float32,
                                             device=y.device)) + smax
    if where is not None:
        mask = mask & where
    return mask


def select_softmax_relaxed_ln(y: torch.Tensor, tau, row_lengths: torch.Tensor,
                              n_ref: int = 1024,
                              where: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Length-normalized relaxed rule (App C.5): tau_row = tau sqrt(n_ref / n),
    with `row_lengths` the valid length n of each softmax row."""
    s = _masked(y + torch.log(torch.abs(y)), where, _NEG_INF)
    smax = torch.amax(s, dim=-1, keepdim=True)
    n = torch.clamp(row_lengths, min=1).to(torch.float32)
    tau_row = torch.as_tensor(tau, dtype=torch.float32, device=y.device) \
        * torch.sqrt(n_ref / n)
    tau_row = torch.clamp(tau_row, max=1.0 - 1e-6)[..., None]
    mask = s > torch.log(tau_row) + smax
    if where is not None:
        mask = mask & where
    return mask


# ---------------------------------------------------------------------------
# RMSNorm rule (Props 3.1 / 3.2)
# ---------------------------------------------------------------------------

def select_rmsnorm(y: torch.Tensor, tau: float, axis: int = -1) -> torch.Tensor:
    """Greedy almost-optimal solution of componentwise LAMP for RMSNorm
    (Prop 3.2): sort the entries by descending square and select the
    smallest prefix s with sum_{i<=s} y_i^2 + 2 y_min^2 >= (2 - tau)
    ||y||^2. An exact-size mask by rank, so ties are safe."""
    y = torch.movedim(torch.as_tensor(y, dtype=torch.float32), axis, -1)
    y2 = y * y
    total = torch.sum(y2, dim=-1, keepdim=True)
    ymin2 = torch.amin(y2, dim=-1, keepdim=True)
    order = torch.argsort(-y2, dim=-1, stable=True)
    csum = torch.cumsum(torch.gather(y2, -1, order), dim=-1)
    need = (2.0 - tau) * total - 2.0 * ymin2
    # the smallest s >= 0 with prefix_sum(s) >= need, prefix_sum(0) = 0:
    # s = [need > 0] + #(csum < need), capped at n (select-all fallback)
    s = torch.sum(csum < need, dim=-1, keepdim=True) + (need > 0).long()
    s = torch.clamp(s, max=y.shape[-1])
    ranks = torch.argsort(order, dim=-1, stable=True)
    return torch.movedim(ranks < s, -1, axis)


def kappa_c_rmsnorm(y: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact kappa_c of RMSNorm (Prop 3.1), q not all ones. 1-D inputs."""
    y = torch.as_tensor(y, dtype=torch.float32)
    q = torch.as_tensor(q, dtype=torch.bool)
    y2 = y * y
    total = torch.sum(y2)
    n_out = torch.sum(~q)
    min_out = torch.amin(torch.where(~q, y2, torch.full_like(y2, float("inf"))))
    sum_in = torch.sum(torch.where(q, y2, torch.zeros_like(y2)))
    general = 2.0 * (1.0 - min_out / total) - sum_in / total
    single = torch.maximum(min_out / total, 1.0 - min_out / total)
    return torch.where(n_out == 1, single, general)


# ---------------------------------------------------------------------------
# Softmax kappa evaluators (for tests / analysis)
# ---------------------------------------------------------------------------

def kappa_1_softmax(y: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact l1-normwise kappa of softmax (Prop 3.3):
    2 max_{j not in Omega} z_j (1 - z_j) |y_j|. 1-D inputs; q not all ones."""
    y = torch.as_tensor(y, dtype=torch.float32)
    z = torch.softmax(y, dim=-1)
    crit = 2.0 * z * (1.0 - z) * torch.abs(y)
    q = torch.as_tensor(q, dtype=torch.bool)
    return torch.amax(torch.where(q, torch.full_like(crit, _NEG_INF), crit))


def kappa_c_softmax(y: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact componentwise kappa of softmax (App B):
    sum_{j not in Omega} z_j |y_j| + max_{i not in Omega} (1 - 2 z_i) |y_i|."""
    y = torch.as_tensor(y, dtype=torch.float32)
    q = torch.as_tensor(q, dtype=torch.bool)
    z = torch.softmax(y, dim=-1)
    u = z * torch.abs(y)
    v = (1.0 - 2.0 * z) * torch.abs(y)
    return torch.sum(torch.where(q, torch.zeros_like(u), u)) + \
        torch.amax(torch.where(q, torch.full_like(v, _NEG_INF), v))


# ---------------------------------------------------------------------------
# Entrywise activation rule (Sec 3.1)
# ---------------------------------------------------------------------------

def _elementwise_grad(phi: Callable[[torch.Tensor], torch.Tensor],
                      y: torch.Tensor) -> torch.Tensor:
    """phi'(y) elementwise, by autograd (the JAX package's vmap of grad)."""
    t = y.detach().reshape(-1).clone().requires_grad_(True)
    with torch.enable_grad():
        (d,) = torch.autograd.grad(phi(t).sum(), t)
    return d.reshape(y.shape)


def select_activation(y: torch.Tensor, tau: float,
                      phi: Callable[[torch.Tensor], torch.Tensor],
                      dphi: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                      eps: float = 1e-30) -> torch.Tensor:
    """Sec 3.1: M is diagonal with entries phi'(y) y / phi(y); select where
    its magnitude exceeds tau. `dphi` defaults to phi's derivative by
    autograd (`phi` elementwise)."""
    y = torch.as_tensor(y, dtype=torch.float32)
    d = _elementwise_grad(phi, y) if dphi is None else dphi(y)
    crit = torch.abs(d * y) / torch.clamp(torch.abs(phi(y)), min=eps)
    return crit > tau


def _gelu_exact(y: torch.Tensor) -> torch.Tensor:
    """The exact GELU as JAX writes it, y erfc(-y / sqrt 2) / 2: accurate
    where y is negative (1 + erf(y / sqrt 2) cancels there)."""
    return 0.5 * y * torch.special.erfc(-y * _SQRT_HALF)


def gelu_criterion(y: torch.Tensor) -> torch.Tensor:
    """|gelu'(y) y / gelu(y)| with the exact (erf) GELU."""
    y = torch.as_tensor(y, dtype=torch.float32)
    d = _elementwise_grad(_gelu_exact, y)
    return torch.abs(d * y) / torch.clamp(torch.abs(_gelu_exact(y)), min=1e-30)


# ---------------------------------------------------------------------------
# Bookkeeping
# ---------------------------------------------------------------------------

def recompute_rate(mask: torch.Tensor,
                   where: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fraction of the selectable entries flagged for recompute (the paper's
    metric: over the inner products inside the causal mask)."""
    if where is None:
        return torch.mean(mask.to(torch.float32))
    sel = torch.sum((mask & where).to(torch.float32))
    return sel / torch.clamp(torch.sum(where.to(torch.float32)), min=1.0)
