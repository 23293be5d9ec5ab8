"""Mixture-of-Experts FFN with top-k routing and sort-based capacity dispatch
(port of ``repro/models/moe.py:30-162``, the single-device path).

The router softmax is a LAMP site: the router logits are a matmul feeding a
softmax, and the selection rule flags the rows whose low-precision logits
could flip an expert choice, which then take the FP32 logits.

Dispatch is sort-based: every (token, choice) entry is ranked within its
expert by a stable sort of the expert ids, entries past the capacity C drop,
the kept ones are written to an (E, C, d) buffer, the experts run as two
batched matmuls, and each token's k results are combined back weighted by
the renormalized router probabilities. A dropped entry contributes nothing;
the residual path keeps its token finite.

Capacity depends on the whole bucket: tokens are flattened B-major and the
stable rank gives earlier rows and earlier window slots the capacity first,
padding included, so a caller that wants the JAX package's routing passes
exactly its bucket.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import lamp as LC
from repro_torch.core.mixed_matmul import dot_ps
from repro_torch.core.policy import LampSite


def moe_params(cfg, gen: torch.Generator, lead=()) -> Dict[str, torch.Tensor]:
    """The experts and router of one layer (of `lead` layers stacked: the
    block layout's (L,) axis), FP32 values drawn from `gen` with the JAX
    package's shapes and scales. The router stays FP32 in every model
    dtype; the caller casts the experts."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    wi_cols = 2 * ff if cfg.act in ("swiglu", "geglu") else ff

    def normal(shape, scale):
        return torch.randn(tuple(lead) + shape, generator=gen,
                           dtype=torch.float32) * scale

    return {"router": normal((d, E), d ** -0.5),
            "we_in": normal((E, d, wi_cols), d ** -0.5),
            "we_out": normal((E, ff, d), ff ** -0.5)}


def router_probs_lamp(x2d: torch.Tensor, router_w: torch.Tensor,
                      site: LampSite) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router probabilities of x2d (T, d) with LAMP evaluation: the PS(mu)
    logits where the rule leaves them, the FP32 ones where it selects.
    `site.rule` "relaxed" takes rule (9); every other rule takes the strict
    rule (8). Returns (probs (T, E), the share of logits recomputed)."""
    xf = x2d.float()
    if not site.enabled:
        return torch.softmax(xf @ router_w, dim=-1), \
            torch.zeros((), dtype=torch.float32, device=xf.device)
    y_low = dot_ps(xf, router_w, site.mu, granularity=site.granularity)
    if site.rule == "relaxed":
        mask = LC.select_softmax_relaxed(y_low, site.tau)
    else:
        mask = LC.select_softmax_strict(y_low, site.tau)
    y = torch.where(mask, xf @ router_w, y_low)
    return torch.softmax(y, dim=-1), torch.mean(mask.float())


def capacity(cfg, n_group: int, T: int, dropless: bool) -> int:
    """Expert capacity of a dispatch group of `n_group` tokens from a bucket
    of window width T: the worst case when `dropless`; at T == 1 (decode
    buckets) 4x headroom over perfect balance, at most the worst case;
    else `capacity_factor` over perfect balance."""
    E, k = cfg.n_experts, cfg.top_k
    if dropless:
        return n_group * k
    if T == 1:
        return min(n_group * k, max(1, math.ceil(n_group * k * 4 / E)))
    return max(1, math.ceil(n_group * k * cfg.capacity_factor / E))


def route(cfg, router_w: torch.Tensor, x2d: torch.Tensor, site: LampSite):
    """(probs (T, E), top-k gate weights renormalized (T, k), top-k expert
    ids (T, k), router LAMP rate) of the tokens x2d (T, d)."""
    probs, rate = router_probs_lamp(x2d, router_w, site)
    # a stable descending sort keeps the lower expert first on ties, as
    # lax.top_k does (torch.topk does not promise an order on ties)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :cfg.top_k], top_e[:, :cfg.top_k]
    top_p = top_p / torch.clamp(torch.sum(top_p, dim=-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e, rate


def slots(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each entry's rank among the entries of its expert, in entry order:
    the slot it takes in its expert's buffer (kept iff below capacity)."""
    order = torch.sort(flat_e, stable=True)[1]
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=flat_e.device))
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(flat_e.numel(), device=flat_e.device) \
        - seg_start[sorted_e]
    return pos


def _dispatch_group(cfg, p, xg, eg, pg, cap: int):
    """One dispatch group: xg (Ng, d) in the model's dtype, eg / pg (Ng, k)
    expert ids and gate weights. Returns (yg (Ng, d), kept share)."""
    Ng, d = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    dev = xg.device
    flat_e = eg.reshape(-1)                                         # (Ng*k,)
    pos = slots(flat_e, E)
    keep = pos < cap
    tok_idx = torch.arange(Ng, device=dev).repeat_interleave(k)
    # the kept entries own distinct (expert, slot) pairs; a dropped one
    # would add zeros, so it goes to a spare slot `cap` that is cut off
    # (a boolean index would wait on the device for its count)
    buf = torch.zeros((E, cap + 1, d), dtype=xg.dtype, device=dev)
    buf[flat_e, torch.where(keep, pos, cap)] = xg[tok_idx]
    h = torch.bmm(buf[:, :cap], p["we_in"])
    if cfg.act in ("swiglu", "geglu"):
        ff = p["we_out"].shape[1]
        g, u = h[..., :ff].float(), h[..., ff:].float()
        a = F.silu(g) if cfg.act == "swiglu" else F.gelu(g, approximate="tanh")
        h = (a * u).to(h.dtype)
    else:
        # tanh GELU whatever cfg.act names, as the JAX package's expert FFN
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    out_buf = torch.bmm(h, p["we_out"])
    y_tok = out_buf[flat_e, torch.clamp(pos, max=cap - 1)] * \
        keep[:, None].to(out_buf.dtype)
    contrib = (y_tok * pg.reshape(-1)[:, None].to(y_tok.dtype)).reshape(Ng, k, d)
    # the k contributions of a token added in order, each sum rounded to the
    # model's dtype, as the JAX package's scatter-add does them
    yg = torch.zeros((Ng, d), dtype=y_tok.dtype, device=dev)
    for j in range(k):
        yg = yg + contrib[:, j]
    return yg, torch.mean(keep.float())


def moe_apply(cfg, p, x: torch.Tensor, *, lamp_site: LampSite,
              num_groups: int = 1, dropless: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, T, d) -> (B, T, d) and the metrics `router_lamp_rate`,
    `kept_frac` and `moe_aux_loss`. `num_groups` splits the B-major tokens
    into independent dispatch groups (halved until it divides B * T);
    `dropless` sizes capacity for the worst case (``capacity``)."""
    B, T, d = x.shape
    E = cfg.n_experts
    N = B * T
    x2d = x.reshape(N, d)
    probs, top_p, top_e, rate = route(cfg, p["router"], x2d, lamp_site)
    G = num_groups
    while N % G:
        G //= 2
    Ng = N // G
    cap = capacity(cfg, Ng, T, dropless)
    ys, kept = [], []
    for g in range(G):
        s = slice(g * Ng, (g + 1) * Ng)
        yg, kg = _dispatch_group(cfg, p, x2d[s], top_e[s], top_p[s], cap)
        ys.append(yg)
        kept.append(kg)
    y = ys[0] if G == 1 else torch.cat(ys)
    # load-balancing auxiliary loss (Switch-style)
    me = torch.mean(F.one_hot(top_e[:, 0], E).float(), dim=0)
    pe = torch.mean(probs, dim=0)
    metrics = {"router_lamp_rate": rate,
               "kept_frac": torch.mean(torch.stack(kept)),
               "moe_aux_loss": E * torch.sum(me * pe)}
    return y.reshape(B, T, d).to(x.dtype), metrics

