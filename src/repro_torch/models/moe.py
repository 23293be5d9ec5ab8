"""Mixture-of-Experts FFN with top-k routing and sort-based capacity dispatch
(port of ``repro/models/moe.py``).

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

`moe_dispatch` picks the implementation as the JAX package's does: the
expert-parallel `moe_apply_ep` under an ambient mesh (``distributed.
sharding.set_mesh``) whose `model` axis (> 1) divides the experts, else
`moe_apply`. Every MoE call site of the models goes through it.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import lamp as LC
from repro_torch.core.mixed_matmul import dot_ps
from repro_torch.core.policy import LampSite
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as SH


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
    out_buf = _experts(cfg, buf[:, :cap], p["we_in"], p["we_out"])
    y_tok = out_buf[flat_e, torch.clamp(pos, max=cap - 1)] * \
        keep[:, None].to(out_buf.dtype)
    return _combine(y_tok, pg, Ng, k), torch.mean(keep.float())


def _experts(cfg, buf, w_in, w_out):
    """The experts' FFN on their buffers: buf (E, C, d) -> (E, C, d)."""
    h = torch.bmm(buf, w_in)
    if cfg.act in ("swiglu", "geglu"):
        ff = w_out.shape[1]
        g, u = h[..., :ff].float(), h[..., ff:].float()
        a = F.silu(g) if cfg.act == "swiglu" else F.gelu(g, approximate="tanh")
        h = (a * u).to(h.dtype)
    else:
        # tanh GELU whatever cfg.act names, as the JAX package's expert FFN
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    return torch.bmm(h, w_out)


def _combine(y_tok, gates, n_tok: int, k: int):
    """Each token's k expert results (n_tok * k, d), token-major, weighted
    by its gates (n_tok, k) and added in order, each sum rounded to the
    model's dtype, as the JAX package's scatter-add does them."""
    d = y_tok.shape[-1]
    contrib = (y_tok * gates.reshape(-1)[:, None].to(y_tok.dtype)).reshape(
        n_tok, k, d)
    y = torch.zeros((n_tok, d), dtype=y_tok.dtype, device=y_tok.device)
    for j in range(k):
        y = y + contrib[:, j]
    return y


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


def moe_dispatch(cfg, p, x: torch.Tensor, *, lamp_site: LampSite,
                 num_groups: int = 1, dropless: bool = False):
    """The expert-parallel path (`moe_apply_ep`, which ignores `num_groups`
    and `dropless`, as the JAX package's does) when the ambient mesh has a
    `model` axis > 1 that divides the experts, else `moe_apply`. Under a
    mesh, x is the rank's batch shard (``sharding.batch_rows``: a batch
    the batch axes do not divide is refused before it gets here)."""
    mesh = SH.current_mesh()
    n_model = SH.axis_size(mesh, "model") if mesh is not None else 1
    if n_model > 1 and cfg.n_experts % n_model == 0:
        return moe_apply_ep(cfg, p, x, lamp_site=lamp_site, mesh=mesh)
    return moe_apply(cfg, p, x, lamp_site=lamp_site, num_groups=num_groups,
                     dropless=dropless)


def _local_experts(w, mesh, E_l: int):
    """This rank's experts (E_l, ...) of an expert leaf: a DTensor placed by
    ``sharding.param_specs`` (E over `model`, FSDP over `data`) is gathered
    over everything but `model`; a whole (E, ...) tensor (the train step's
    gathered params) is sliced, with its gradient summed over `model` in
    the backward so each rank holds the whole gradient. Gradients take the
    whole-tensor route; the DTensor route serves forward passes."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(w, DTensor):
        pl = [Shard(0) if n == "model" else Replicate()
              for n in mesh.mesh_dim_names]
        return w.redistribute(mesh, pl).to_local()
    i = SH.axis_index(mesh, "model")
    return C.copy_to_axis(w, mesh, "model")[i * E_l:(i + 1) * E_l]


def _replicated(w, mesh):
    """A leaf that every rank of the `model` axis uses whole (the router):
    gathered if a DTensor; its gradient summed over `model`."""
    from torch.distributed.tensor import DTensor
    if isinstance(w, DTensor):
        w = w.full_tensor()
    return C.copy_to_axis(w, mesh, "model")


def moe_apply_ep(cfg, p, x: torch.Tensor, *, lamp_site: LampSite, mesh,
                 capacity_mult: float = 2.0, local_experts: bool = False
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Expert-parallel MoE (port of the JAX package's ``shard_map`` body):
    no token movement at all.

    Layout: x (B_l, T, d) is this rank's batch shard over (pod, data),
    the same on every rank of its `model` line; the router is replicated;
    the experts are E over `model`. Every rank routes its tokens, runs those
    routed to its E / n_model experts with a local capacity of
    ceil(B_l * T * k / E * capacity_mult) a local expert (foreign experts go
    to a sentinel slot), and the per-token results are summed over `model`
    with one all-reduce. Returns (y (B_l, T, d) in x's dtype, {
    router_lamp_rate and kept_frac of this rank's tokens, moe_aux_loss
    0}). Differentiable: x's and the router's gradients are summed over
    `model`. With `local_experts` p's expert leaves are already the rank's
    E / n_model experts, whole (the tensor-parallel steps' layer leaves).
    """
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    n_model = SH.axis_size(mesh, "model")
    E_l = E // n_model
    m_idx = SH.axis_index(mesh, "model")
    Tl = B * T
    cap = max(1, math.ceil(Tl * k / E * capacity_mult))
    dev = x.device

    x2d = C.copy_to_axis(x.reshape(Tl, d), mesh, "model")
    _, top_p, top_e, rate = route(cfg, _replicated(p["router"], mesh), x2d,
                                  lamp_site)
    flat_e = top_e.reshape(-1)
    local_id = flat_e - m_idx * E_l
    mine = (local_id >= 0) & (local_id < E_l)
    pos = slots(torch.where(mine, local_id, E_l), E_l + 1)
    keep = mine & (pos < cap)
    lid_c = torch.clamp(local_id, 0, E_l - 1)
    tok_idx = torch.arange(Tl, device=dev).repeat_interleave(k)
    # the kept entries own distinct (expert, slot) pairs; the others go to
    # a spare slot `cap` that is cut off
    buf = torch.zeros((E_l, cap + 1, d), dtype=x.dtype, device=dev)
    buf[lid_c, torch.where(keep, pos, cap)] = x2d[tok_idx]
    if local_experts:
        w_in, w_out = p["we_in"], p["we_out"]
    else:
        w_in = _local_experts(p["we_in"], mesh, E_l)
        w_out = _local_experts(p["we_out"], mesh, E_l)
    out_buf = _experts(cfg, buf[:, :cap], w_in, w_out)
    y_tok = out_buf[lid_c, torch.clamp(pos, 0, cap - 1)] * \
        keep[:, None].to(out_buf.dtype)
    y = C.reduce_over_axis(_combine(y_tok, top_p, Tl, k), mesh, "model")
    kept = C.reduce_over_axis(torch.sum(keep.float()).reshape(1), mesh,
                              "model").reshape(()) / (Tl * k)
    metrics = {"router_lamp_rate": rate, "kept_frac": kept,
               "moe_aux_loss": torch.zeros((), device=dev)}
    return y.reshape(B, T, d).to(x.dtype), metrics
