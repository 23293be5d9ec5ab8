"""LAMP attention over materialized logits (port of
``repro/core/attention.py:46-179``): the gather path of the serving step and
the plain version the paged CUDA kernel is held against.

    y_low = dot_ps(q * scale, k^T, mu)        # PS(mu) KQ products
    mask  = LAMP rule (8) / (9) / LN-(9)      # look-ahead selection
    y     = where(mask, fp32 q k^T, y_low)    # selective recompute
    out   = softmax(y) @ v                    # everything else in FP32

Shapes: q (B, H, Tq, D), k and v (B, H, Tk, D); GQA heads are repeated by
the caller.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import lamp as L
from .mixed_matmul import dot_ps
from .policy import LampSite


class AttnAux(NamedTuple):
    recompute_rate: torch.Tensor   # scalar: selected / valid KQ products
    n_selected: torch.Tensor       # scalar, or (B, Tq) with reduce=False
    n_valid: torch.Tensor


def _query_positions(tq: int, offset, device) -> torch.Tensor:
    """Absolute query positions: (tq, 1) for a scalar offset, (B, 1, tq, 1)
    for a (B,) tensor of per-row offsets (partial prefill windows)."""
    qi = torch.arange(tq, device=device)[:, None]
    if isinstance(offset, (int, float)):
        return qi + int(offset)
    offset = torch.as_tensor(offset, device=device)
    if offset.ndim == 0:
        return qi + offset
    return qi + offset[:, None, None, None]


def _causal_where(tq: int, tk: int, offset, window: Optional[int],
                  device) -> torch.Tensor:
    qi = _query_positions(tq, offset, device)
    kj = torch.arange(tk, device=device)[None, :]
    ok = kj <= qi
    if window is not None:
        ok = ok & (kj > qi - window)
    return ok


def _select(y, site: LampSite, where, row_lengths=None, tau=None):
    if not site.enabled or site.rule == "none":
        return torch.zeros(y.shape, dtype=torch.bool, device=y.device)
    tau = site.tau if tau is None else tau
    if site.rule == "strict":
        return L.select_softmax_strict(y, tau, where=where)
    if site.rule == "relaxed":
        return L.select_softmax_relaxed(y, tau, where=where)
    if site.rule == "relaxed_ln":
        if row_lengths is None:
            raise ValueError("relaxed_ln needs row_lengths")
        return L.select_softmax_relaxed_ln(y, tau, row_lengths,
                                           n_ref=site.n_ref, where=where)
    raise ValueError(f"unsupported LAMP rule {site.rule!r}")


def attention_reference(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None,
                        window: Optional[int] = None, offset=0) -> torch.Tensor:
    """Uniform FP32 attention (the paper's reference)."""
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    y = torch.einsum("bhqd,bhkd->bhqk", q * scale, k)
    where = (_causal_where(q.shape[2], k.shape[2], offset, window, q.device)
             if causal else None)
    return torch.einsum("bhqk,bhkd->bhqd", L.masked_softmax(y, where), v)


def attention_lamp(q, k, v, site: LampSite, *, causal: bool = True,
                   scale: Optional[float] = None, window: Optional[int] = None,
                   offset=0, reduce: bool = True,
                   tau=None) -> Tuple[torch.Tensor, AttnAux]:
    """Materialized-softmax LAMP attention.

    `offset` may be a (B,) tensor: row b's queries sit at absolute positions
    offset[b] .. offset[b] + Tq - 1 against keys at 0 .. Tk - 1. `tau`
    (a float or 0-d tensor) overrides `site.tau`. With `reduce=False` the
    counts are (B, Tq), summed over heads and keys."""
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    dev = q.device
    scale = scale if scale is not None else D ** -0.5
    where = _causal_where(Tq, Tk, offset, window, dev) if causal else None
    wb = None if where is None else torch.broadcast_to(where, (B, H, Tq, Tk))

    qs = q * scale
    y_low = dot_ps(qs, k.transpose(-1, -2), site.mu,
                   granularity=site.granularity)
    if causal:
        n = _query_positions(Tq, offset, dev)[..., 0] + 1     # (Tq,) / (B,1,Tq)
        row_lengths = torch.clamp(n, 0, window if window is not None else Tk)
        row_lengths = torch.broadcast_to(row_lengths, (B, H, Tq))
    else:
        row_lengths = torch.full((B, H, Tq), Tk, device=dev)
    mask = _select(y_low, site, wb, row_lengths, tau=tau)

    y_exact = torch.einsum("bhqd,bhkd->bhqk", qs, k)
    y = torch.where(mask, y_exact, y_low)
    out = torch.einsum("bhqk,bhkd->bhqd", L.masked_softmax(y, wb), v)

    m = mask.to(torch.float32)
    if reduce:
        n_sel = m.sum()
        n_valid = (wb.to(torch.float32).sum() if wb is not None
                   else torch.tensor(float(mask.numel()), device=dev))
        rate = n_sel / torch.clamp(n_valid, min=1)
    else:
        n_sel = m.sum(dim=(1, 3))
        n_valid = (wb.to(torch.float32).sum(dim=(1, 3)) if wb is not None
                   else torch.full((B, Tq), float(H * Tk), device=dev))
        rate = n_sel.sum() / torch.clamp(n_valid.sum(), min=1)
    return out, AttnAux(rate, n_sel, n_valid)


def decode_attention_lamp(q, k_cache, v_cache, length, site: LampSite, *,
                          scale: Optional[float] = None,
                          window: Optional[int] = None, reduce: bool = True,
                          tau=None) -> Tuple[torch.Tensor, AttnAux]:
    """Single-token decode (port of ``repro/core/attention.py:386``):
    q (B, H, 1, D) against a cache (B, H, S, D) of which the first
    `length[b]` positions are valid (the last `window` of them with a
    sliding window). The relaxed_ln row length is `length` itself, not
    capped by the window, as in both JAX paths. With `reduce=False` the
    counts are (B,), summed over heads. `tau` overrides `site.tau`."""
    q = q.to(torch.float32)
    k_cache, v_cache = k_cache.to(torch.float32), v_cache.to(torch.float32)
    B, H, Tq, D = q.shape
    S = k_cache.shape[2]
    scale = scale if scale is not None else D ** -0.5
    length = torch.as_tensor(length, device=q.device)
    pos = torch.arange(S, device=q.device)[None, None, None, :]
    ln = length[:, None, None, None]
    ok = pos < ln
    if window is not None:
        ok = ok & (pos > ln - 1 - window)
    ok = torch.broadcast_to(ok, (B, H, Tq, S))
    kt = k_cache.transpose(-1, -2)
    qs = q * scale
    if site.enabled:
        y_low = dot_ps(qs, kt, site.mu, granularity=site.granularity)
        mask = _select(y_low, site, ok,
                       row_lengths=torch.broadcast_to(length[:, None, None],
                                                      (B, H, Tq)),
                       tau=tau)
        y = torch.where(mask, torch.matmul(qs, kt), y_low)
    else:
        y = torch.matmul(qs, kt)
        mask = torch.zeros(y.shape, dtype=torch.bool, device=y.device)
    z = L.masked_softmax(y, ok)
    out = torch.einsum("bhqk,bhkd->bhqd", z, v_cache)
    m, okf = mask.to(torch.float32), ok.to(torch.float32)
    if reduce:
        n_sel, n_valid = m.sum(), okf.sum()
    else:
        n_sel, n_valid = m.sum(dim=(1, 2, 3)), okf.sum(dim=(1, 2, 3))
    rate = n_sel.sum() / torch.clamp(n_valid.sum(), min=1)
    return out, AttnAux(rate, n_sel, n_valid)
