"""LAMP attention (port of ``repro/core/attention.py``): the gather path of
the serving step, the plain version the paged CUDA kernel is held against,
and the full-sequence attention of the paper's evaluation.

    y_low = dot_ps(q * scale, k^T, mu)        # PS(mu) KQ products
    mask  = LAMP rule (8) / (9) / LN-(9)      # look-ahead selection
    y     = where(mask, fp32 q k^T, y_low)    # selective recompute
    out   = softmax(y) @ v                    # everything else in FP32

Variants:
  * attention_reference     -- uniform FP32 (the paper's reference model)
  * attention_lamp          -- materialized logits, any rule; with
                               `random_key` the App C.4 control arm
  * chunked_attention       -- online softmax over KV blocks, O(T) memory
  * chunked_attention_lamp  -- relaxed LAMP fused with the online softmax:
                               the exact two-pass threshold, or the one-pass
                               running threshold (conservative)
  * decode_attention_lamp   -- one query a row against a KV cache

Shapes: q (B, H, Tq, D), k and v (B, H, Tk, D); GQA heads are repeated by
the caller. The JAX package's REPRO_BASELINE switch, which re-times old
TPU code paths, is not ported: the port takes its default branch.

``order`` says how the FP32 sums are taken. "dot_ps" (the default, held
against the JAX package): y_low by ``dot_ps``, the FP32 logits by one
matmul. "kernel": both in the order of the paged CUDA kernel
(``kernels/csrc/paged_attention.cu``), so that its plain versions give its
counts exactly: the FP32 logits d ascending with every product and sum
rounded (``slab_sums`` at mu 23 over one slab), y_low their PS(mu) rounding
at granularity 0 (or g >= D, or mu >= 23), else ``slab_sums`` in chunks of
g lanes (``dot_ps`` itself at g 1, where the two are bit-identical).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import lamp as L
from . import prng
from .mixed_matmul import dot_ps, slab_sums
from .numerics import round_to_mantissa
from .policy import LampSite

ORDERS = ("dot_ps", "kernel")

_NEG = -1e30
_TINY = torch.finfo(torch.float32).tiny


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
    if site.rule == "random":  # the control arm: the caller resamples
        raise ValueError("random rule is handled by attention_lamp(random_key=...)")
    raise ValueError(f"unsupported LAMP rule {site.rule!r}")


def _kernel_order(qs, kt, site: LampSite, exact_needed: bool):
    """(y_low, y_exact) in the paged kernel's order (module docstring);
    y_exact is y_low itself where neither the rule (rule "none" selects
    nothing) nor y_low needs it."""
    D = qs.shape[-1]
    mu, g = site.mu, site.granularity
    if mu >= 23 or g <= 0 or g >= D:
        y_exact = slab_sums(qs, kt, 23, D)
        return (y_exact if mu >= 23 else round_to_mantissa(y_exact, mu)), y_exact
    y_low = (dot_ps(qs, kt, mu, granularity=1) if g == 1
             else slab_sums(qs, kt, mu, g))
    return y_low, (slab_sums(qs, kt, 23, D) if exact_needed else y_low)


def _check_order(order: str) -> None:
    if order not in ORDERS:
        raise ValueError(f"order must be one of {ORDERS}, got {order!r}")


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


def _random_mask(mask, key, wb):
    """The App C.4 control: each row keeps its count of `mask` but takes
    its positions by random scores (``uniform(key, mask.shape)``, invalid
    slots last), ranked by a stable sort as the JAX package ranks them."""
    n_sel = torch.sum(mask, dim=-1, keepdim=True)
    scores = prng.uniform(torch.as_tensor(key, device=mask.device), mask.shape)
    if wb is not None:
        scores = torch.where(wb, scores, torch.full_like(scores, -1.0))
    order = torch.argsort(-scores, dim=-1, stable=True)
    # each slot's rank: the inverse permutation of `order` (JAX's second
    # argsort)
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(order.shape[-1], device=order.device)
        .expand_as(order).contiguous())
    mask = ranks < n_sel
    return mask if wb is None else mask & wb


def attention_lamp(q, k, v, site: LampSite, *, causal: bool = True,
                   scale: Optional[float] = None, window: Optional[int] = None,
                   offset=0, random_key=None, reduce: bool = True, tau=None,
                   order: str = "dot_ps") -> Tuple[torch.Tensor, AttnAux]:
    """Materialized-softmax LAMP attention.

    With `random_key` (a ``prng`` key) it runs the App C.4 control: each
    row recomputes as many products as the rule selects, at random
    positions. `offset` may be a (B,) tensor: row b's queries sit at
    absolute positions offset[b] .. offset[b] + Tq - 1 against keys at
    0 .. Tk - 1. `tau` (a float or 0-d tensor) overrides `site.tau`. With
    `reduce=False` the counts are (B, Tq), summed over heads and keys.
    `order`: see the module docstring."""
    _check_order(order)
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    dev = q.device
    scale = scale if scale is not None else D ** -0.5
    where = _causal_where(Tq, Tk, offset, window, dev) if causal else None
    wb = None if where is None else torch.broadcast_to(where, (B, H, Tq, Tk))

    qs = q * scale
    if order == "kernel":
        y_low, y_exact = _kernel_order(qs, k.transpose(-1, -2), site,
                                       site.rule != "none")
    else:
        y_low = dot_ps(qs, k.transpose(-1, -2), site.mu,
                       granularity=site.granularity)
        y_exact = torch.einsum("bhqd,bhkd->bhqk", qs, k)
    if causal:
        n = _query_positions(Tq, offset, dev)[..., 0] + 1     # (Tq,) / (B,1,Tq)
        row_lengths = torch.clamp(n, 0, window if window is not None else Tk)
        row_lengths = torch.broadcast_to(row_lengths, (B, H, Tq))
    else:
        row_lengths = torch.full((B, H, Tq), Tk, device=dev)
    mask = _select(y_low, site, wb, row_lengths, tau=tau)
    if random_key is not None:
        mask = _random_mask(mask, random_key, wb)
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


# ---------------------------------------------------------------------------
# Online-softmax (FlashAttention-style) variants
# ---------------------------------------------------------------------------

def _q_tiles(Tq: int, Tk: int, offset: int, window: Optional[int],
             block: int, q_tiles: int):
    """The causal q-tiling: (q0, tq, lo, kv_hi) of each query tile, whose
    queries attend to keys lo .. kv_hi - 1 only (the KV blocks inside its
    causal range), or None where the query axis is not tiled."""
    if not (q_tiles > 1 and Tq % q_tiles == 0 and Tq // q_tiles >= block):
        return None
    tq = Tq // q_tiles
    tiles = []
    for t in range(q_tiles):
        q0 = t * tq
        hi = min(Tk, q0 + tq + max(offset, 0))
        kv_hi = min(Tk, -(-hi // block) * block)
        lo = 0
        if window is not None:
            lo = max(0, (q0 + offset - window) // block * block)
        tiles.append((q0, tq, lo, kv_hi))
    return tiles


def _kv_blocks(k, v, block: int):
    """k and v zero-padded to whole blocks, and the number of blocks."""
    Tk = k.shape[2]
    nb = -(-Tk // block)
    pad = nb * block - Tk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    return k, v, nb


def _block_ok(bi: int, block: int, Tk: int, qi, causal: bool,
              window: Optional[int]):
    """Validity of KV block bi's keys for queries at positions qi (Tq, 1)."""
    kj = bi * block + torch.arange(block, device=qi.device)[None, :]
    ok = kj < Tk
    if causal:
        ok = ok & (kj <= qi)
        if window is not None:
            ok = ok & (kj > qi - window)
    return ok


def _online_update(m, l, acc, y, vc, ok=None):
    """One KV block of the online softmax: (m, l, acc) after logits y."""
    m_new = torch.maximum(m, torch.amax(y, dim=-1))
    p = torch.exp(y - m_new[..., None])
    if ok is not None:
        p = torch.where(ok, p, torch.zeros_like(p))
    corr = torch.exp(m - m_new)
    l = l * corr + torch.sum(p, dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vc)
    return m_new, l, acc


def chunked_attention(q, k, v, *, causal: bool = True,
                      scale: Optional[float] = None, block: int = 512,
                      window: Optional[int] = None, offset: int = 0,
                      q_tiles: int = 8) -> torch.Tensor:
    """O(T) memory online-softmax attention over KV blocks. Causal inputs
    are q-tiled as in `chunked_attention_lamp`."""
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    tiles = _q_tiles(Tq, Tk, offset, window, block, q_tiles) if causal else None
    if tiles is not None:
        return torch.cat([chunked_attention(
            q[:, :, q0:q0 + tq], k[:, :, lo:kv_hi], v[:, :, lo:kv_hi],
            causal=True, scale=scale, block=block, window=window,
            offset=offset + q0 - lo, q_tiles=1)
            for q0, tq, lo, kv_hi in tiles], dim=2)
    k, v, nb = _kv_blocks(k, v, block)
    qs = q * scale
    qi = torch.arange(Tq, device=q.device)[:, None] + offset
    m = torch.full((B, H, Tq), _NEG, device=q.device)
    l = torch.zeros((B, H, Tq), device=q.device)
    acc = torch.zeros((B, H, Tq, D), device=q.device)
    for bi in range(nb):
        kc, vc = (t[:, :, bi * block:(bi + 1) * block] for t in (k, v))
        y = torch.einsum("bhqd,bhkd->bhqk", qs, kc)
        ok = _block_ok(bi, block, Tk, qi, causal, window)
        m, l, acc = _online_update(m, l, acc,
                                   torch.where(ok, y, torch.full_like(y, _NEG)), vc)
    return acc / torch.clamp(l, min=_TINY)[..., None]


def chunked_attention_lamp(q, k, v, site: LampSite, *, causal: bool = True,
                           scale: Optional[float] = None, block: int = 512,
                           window: Optional[int] = None, offset: int = 0,
                           onepass: bool = False, q_tiles: int = 8,
                           ) -> Tuple[torch.Tensor, AttnAux]:
    """Relaxed LAMP (rule 9) fused with the online softmax (the paper's
    Sec 4.4). The relative threshold needs max_j |y_j| e^{y_j} a row:

      two-pass (default): pass 1 scans the KV blocks for the exact row max
      of s = y + log|y|; pass 2 selects, recomputes and accumulates the
      online softmax. Exactly rule (9).

      one-pass: each block is thresholded against the running max of s,
      which only grows, so early blocks can only over-select: the rate is
      at least the two-pass one.

    Causal inputs are q-tiled: the query axis is cut into `q_tiles` tiles,
    each scanning only the KV blocks inside its causal range (exact: masked
    blocks contribute nothing). At granularity 0 (cast-only) y_low is the
    PS(mu) rounding of the one FP32 product, which is also the exact arm.
    The counts are scalars (float32)."""
    if site.enabled and site.rule not in ("relaxed", "none"):
        raise ValueError("online LAMP requires the relaxed rule (paper Sec 4.4)")
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    dev = q.device
    scale = scale if scale is not None else D ** -0.5
    tiles = _q_tiles(Tq, Tk, offset, window, block, q_tiles) if causal else None
    if tiles is not None:
        outs, nsel, valid = [], 0, 0
        for q0, tq, lo, kv_hi in tiles:
            o, aux = chunked_attention_lamp(
                q[:, :, q0:q0 + tq], k[:, :, lo:kv_hi], v[:, :, lo:kv_hi],
                site, causal=True, scale=scale, block=block, window=window,
                offset=offset + q0 - lo, onepass=onepass, q_tiles=1)
            outs.append(o)
            nsel = nsel + aux.n_selected
            valid = valid + aux.n_valid
        return torch.cat(outs, dim=2), AttnAux(
            nsel / torch.clamp(valid, min=1), nsel, valid)

    k, v, nb = _kv_blocks(k, v, block)
    qs = q * scale
    qi = torch.arange(Tq, device=dev)[:, None] + offset
    log_tau = torch.log(torch.tensor(max(site.tau, 1e-30), dtype=torch.float32,
                                     device=dev)) if site.enabled else 0.0
    cast_only = site.enabled and site.granularity == 0

    def block_logits(bi):
        """(y_low, the FP32 logits or None, ok) of KV block bi."""
        kc = k[:, :, bi * block:(bi + 1) * block]
        y_exact = None
        if cast_only:
            y_exact = torch.einsum("bhqd,bhkd->bhqk", qs, kc)
            y = round_to_mantissa(y_exact, site.mu)
        elif site.enabled:
            y = dot_ps(qs, kc.transpose(-1, -2), site.mu,
                       granularity=site.granularity)
        else:
            y = torch.einsum("bhqd,bhkd->bhqk", qs, kc)
        return y, y_exact, _block_ok(bi, block, Tk, qi, causal, window)

    def log_crit(y, ok):
        s = y + torch.log(torch.abs(y))
        return torch.where(ok, s, torch.full_like(s, _NEG))

    smax = torch.full((B, H, Tq), _NEG, device=dev)
    if site.enabled and not onepass:
        for bi in range(nb):
            y, _, ok = block_logits(bi)
            smax = torch.maximum(smax, torch.amax(log_crit(y, ok), dim=-1))

    m = torch.full((B, H, Tq), _NEG, device=dev)
    l = torch.zeros((B, H, Tq), device=dev)
    acc = torch.zeros((B, H, Tq, D), device=dev)
    smax_run = torch.full((B, H, Tq), _NEG, device=dev)
    nsel = torch.zeros((), dtype=torch.float32, device=dev)
    for bi in range(nb):
        y, y_exact, ok = block_logits(bi)
        if site.enabled:
            s = log_crit(y, ok)
            if onepass:
                smax_run = torch.maximum(smax_run, torch.amax(s, dim=-1))
                thr = smax_run
            else:
                thr = smax
            sel = ok & (s > log_tau + thr[..., None])
            if y_exact is None:
                y_exact = torch.einsum("bhqd,bhkd->bhqk", qs,
                                       k[:, :, bi * block:(bi + 1) * block])
            y = torch.where(sel, y_exact, y)
            nsel = nsel + torch.sum(sel)
        y = torch.where(ok, y, torch.full_like(y, _NEG))
        m, l, acc = _online_update(m, l, acc, y,
                                   v[:, :, bi * block:(bi + 1) * block], ok)
    out = acc / torch.clamp(l, min=_TINY)[..., None]
    if causal:
        valid = torch.sum(torch.clamp(qi + 1, 0, window if window else Tk)
                          .to(torch.float32)) * B * H
    else:
        valid = torch.tensor(float(B) * H * Tq * Tk, device=dev)
    return out, AttnAux(nsel / torch.clamp(valid, min=1), nsel, valid)


def decode_attention_lamp(q, k_cache, v_cache, length, site: LampSite, *,
                          scale: Optional[float] = None,
                          window: Optional[int] = None, reduce: bool = True,
                          tau=None, order: str = "dot_ps"
                          ) -> Tuple[torch.Tensor, AttnAux]:
    """Single-token decode (port of ``repro/core/attention.py:386``):
    q (B, H, 1, D) against a cache (B, H, S, D) of which the first
    `length[b]` positions are valid (the last `window` of them with a
    sliding window). The relaxed_ln row length is `length` itself, not
    capped by the window, as in both JAX paths. With `reduce=False` the
    counts are (B,), summed over heads. `tau` overrides `site.tau`.
    `order`: see the module docstring."""
    _check_order(order)
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
        if order == "kernel":
            y_low, y_exact = _kernel_order(qs, kt, site, site.rule != "none")
        else:
            y_low = dot_ps(qs, kt, site.mu, granularity=site.granularity)
            y_exact = torch.matmul(qs, kt)
        mask = _select(y_low, site, ok,
                       row_lengths=torch.broadcast_to(length[:, None, None],
                                                      (B, H, Tq)),
                       tau=tau)
        y = torch.where(mask, y_exact, y_low)
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
