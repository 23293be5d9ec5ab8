"""Explicit collectives: sequence-parallel decode attention and quantized
all-reduce (port of ``repro/distributed/collectives.py``).

The JAX package writes these as ``shard_map`` bodies; here they are SPMD
code: each rank calls the function on its own shards, and ``psum`` /
``pmax`` become ``all_reduce`` SUM / MAX over the process group of the
rank's line along the mesh axis.

`sp_decode_attention` is the scalable decode path: the KV cache's sequence
axis lives on the `model` axis; each rank runs a local online softmax
against its cache slice and the ranks combine with one tiny all-reduce of
(m, l, acc) -- a distributed flash-decode. The relaxed-LAMP threshold needs
the global max of s = y + log|y|, which is one more all-reduce (MAX).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import tree as T
from repro_torch.core.numerics import round_to_mantissa

from . import sharding as SH

_NEG = -1e30


def _all_reduce(t: torch.Tensor, mesh, axis: str, op) -> torch.Tensor:
    if SH.axis_size(mesh, axis) > 1:
        dist.all_reduce(t, op=op, group=SH.axis_group(mesh, axis))
    return t


def sp_decode_attention(mesh, q, k_cache, v_cache, length, *,
                        mu: int = 23, tau: float = 0.0, lamp: bool = False,
                        axis: str = "model", scale: Optional[float] = None,
                        window: Optional[int] = None):
    """Sequence-parallel GQA decode attention, this rank's share.

    The rank holds its batch rows (any shard of the batch over the batch
    axes, the same rows on every rank of its `axis` line): q (B_l, H, 1, D),
    length (B_l,), and its contiguous slice of the caches' sequence,
    k_cache / v_cache (B_l, Hkv, S_l, D), at positions rank_in_axis * S_l
    + arange(S_l). H = G * Hkv (grouped-query: KV heads are never
    repeated). q is rounded to the cache's dtype for the QK product and p
    to v's for P.V, both products in FP32, as the JAX package's
    ``preferred_element_type=float32`` does.

    With lamp=True and mu < 23 the relaxed rule (9) runs distributed on
    the cast-only PS(mu) logits: one extra all-reduce (MAX) carries the
    row max of s = y_low + log|y_low|.

    Returns this rank's rows of the output, (B_l, H, 1, D) float32.
    """
    B, H, _, D = q.shape
    Hkv = k_cache.shape[1]
    G = H // Hkv
    S_l = k_cache.shape[2]
    scale = scale if scale is not None else D ** -0.5
    sid = SH.axis_index(mesh, axis)
    dev = q.device

    qg = (q.float() * scale).reshape(B, Hkv, G, D)
    pos = sid * S_l + torch.arange(S_l, device=dev)
    ok = pos[None, None, None, :] < length[:, None, None, None]   # (B,1,1,S_l)
    if window is not None:
        ok = ok & (pos[None, None, None, :] >
                   (length[:, None, None, None] - 1 - window))
    y = torch.einsum("bhgd,bhkd->bhgk", qg.to(k_cache.dtype).float(),
                     k_cache.float())                          # (B,Hkv,G,S_l)
    if lamp and mu < 23:
        y_low = round_to_mantissa(y, mu)
        s = torch.where(ok, y_low + torch.log(torch.abs(y_low)),
                        torch.tensor(_NEG, device=dev))
        smax = _all_reduce(torch.amax(s, dim=-1), mesh, axis,
                           dist.ReduceOp.MAX)
        log_tau = torch.log(torch.tensor(max(tau, 1e-30), dtype=torch.float32,
                                         device=dev))
        sel = ok & (s > log_tau + smax[..., None])
        y = torch.where(sel, y, y_low)
    y = torch.where(ok, y, torch.tensor(_NEG, device=dev))
    m_l = torch.amax(y, dim=-1)                                  # (B,Hkv,G)
    p = torch.where(ok, torch.exp(y - m_l[..., None]),
                    torch.zeros((), device=dev))
    l_l = torch.sum(p, dim=-1)
    acc_l = torch.einsum("bhgk,bhkd->bhgd", p.to(v_cache.dtype).float(),
                         v_cache.float())
    # combine across the axis: all-reduce of (m, l, acc), O(B*H*D) traffic
    m_g = _all_reduce(m_l.clone(), mesh, axis, dist.ReduceOp.MAX)
    w = torch.exp(m_l - m_g)
    l_g = _all_reduce(l_l * w, mesh, axis, dist.ReduceOp.SUM)
    acc_g = _all_reduce(acc_l * w[..., None], mesh, axis, dist.ReduceOp.SUM)
    out = acc_g / torch.clamp(l_g, min=1e-30)[..., None]
    return out.reshape(B, H, 1, D)


def quantized_psum(mesh, tree, *, axis: str = "data"):
    """int8-quantized all-reduce of this rank's tree over `axis`: quantize
    each leaf locally with the scale shared by an all-reduce (MAX) of
    max|g| / 127, all-reduce (SUM) the int32 payload, dequantize and divide
    by the axis size (a mean). FP32 leaves come back, in `tree`'s
    structure; leaves are visited in JAX's order."""
    n = SH.axis_size(mesh, axis)
    outs = []
    for g in T.leaves(tree):
        gf = g.float()
        scale = torch.clamp(torch.amax(torch.abs(gf)), min=1e-12) / 127.0
        scale = _all_reduce(scale.reshape(1), mesh, axis,
                            dist.ReduceOp.MAX).reshape(())
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int32)
        qs = _all_reduce(q, mesh, axis, dist.ReduceOp.SUM)
        outs.append(qs.float() * scale / float(n))
    return T.unflatten(tree, outs)


class _CopyToAxis(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the axis (a
    value replicated over the axis that each rank uses for a part of the
    work)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        return _all_reduce(g, ctx.mesh, ctx.axis, dist.ReduceOp.SUM), None, None


class _ReduceOverAxis(torch.autograd.Function):
    """All-reduce (SUM) forward; identity backward (the sum is replicated
    over the axis, so each rank's gradient is already the whole one)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x.contiguous().clone(), mesh, axis,
                           dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_axis(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _CopyToAxis.apply(x, mesh, axis)


def reduce_over_axis(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _ReduceOverAxis.apply(x, mesh, axis)


def axis_mean(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean of t over the mesh axes `axes` (a new tensor), summed one
    axis after another."""
    out = t.detach().clone()
    for a in axes:
        _all_reduce(out, mesh, a, dist.ReduceOp.SUM)
    n = math.prod(SH.axis_size(mesh, a) for a in axes)
    return out / n if n > 1 else out
