"""LAMP selection rules for softmax (port of ``repro/core/lamp.py:39-123``).

All rules return boolean masks (True = recompute in high precision) over the
last axis; `where` restricts both the softmax domain and the selectable set.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = float("-inf")
_TINY = torch.finfo(torch.float32).tiny


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
                          where: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paper rule (8): q_j = 1 iff 2 z_j (1 - z_j) |y_j| > tau."""
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
