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

The tensor-parallel steps (``launch.steps.make_sharded_*_step`` on the
transformer families) compute on the params' shards with these
autograd-aware pieces: the Megatron pair `copy_to_axis` /
`reduce_over_axis`; `gather_over_axis`, the FSDP gather of a layer's leaf
over one axis, whose backward is a reduce-scatter (SUM); `gather_parts`,
an all-gather of activations over `model` whose parts may differ in size
(the heads of an uneven split); and the vocabulary-parallel embedding
lookup and cross entropy. Every one uses only collectives that gloo takes
on CUDA tensors: all-reduce, both all-gathers and reduce-scatter.
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


def axis_sum(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of t over the mesh axes `axes` (a new tensor, no gradient),
    one axis after another."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    for a in axes:
        _all_reduce(out, mesh, a, dist.ReduceOp.SUM)
    return out


def axis_mean(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean of t over the mesh axes `axes` (`axis_sum` over their
    size)."""
    out = axis_sum(t, mesh, axes)
    n = math.prod(SH.axis_size(mesh, a) for a in axes)
    return out / n if n > 1 else out


# ------------------------------------------------- tensor-parallel pieces

def _reduce_scatter(t: torch.Tensor, mesh, axis: str, dim: int):
    """The SUM of t over `axis`, this rank's contiguous part along dim."""
    n = SH.axis_size(mesh, axis)
    if n == 1:
        return t
    group = SH.axis_group(mesh, axis)
    tt = t.movedim(dim, 0).contiguous()
    r, rest = tt.shape[0] // n, tuple(tt.shape[1:])
    out = tt.new_empty((r,) + rest)
    _REDUCE_SCATTER(out, tt, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


# reduce_scatter_tensor / all_gather_into_tensor are deprecated in favour
# of the *_single names where those exist
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' t along `axis` concatenated along dim, in rank order
    (no gradient)."""
    n = SH.axis_size(mesh, axis)
    if n == 1:
        return t
    group = SH.axis_group(mesh, axis)
    tt = t.movedim(dim, 0).contiguous()
    r, rest = tt.shape[0], tuple(tt.shape[1:])
    out = tt.new_empty((n * r,) + rest)
    _ALL_GATHER(out, tt, group=group)
    return out.movedim(0, dim)


class _GatherOverAxis(torch.autograd.Function):
    """All-gather along dim forward; the backward is a reduce-scatter (SUM)
    when the ranks use the gathered tensor for different parts of the work
    (their gradients are partial), this rank's part of the gradient when
    every rank does the same work with it (`redundant`)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, redundant):
        ctx.mesh, ctx.axis, ctx.dim, ctx.redundant = mesh, axis, dim, redundant
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.redundant:
            size = g.shape[ctx.dim] // SH.axis_size(ctx.mesh, ctx.axis)
            i = SH.axis_index(ctx.mesh, ctx.axis)
            return g.narrow(ctx.dim, i * size, size), None, None, None, None
        return _reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), \
            None, None, None, None


def gather_over_axis(x: torch.Tensor, mesh, axis: str, dim: int, *,
                     redundant: bool = False) -> torch.Tensor:
    """x gathered over `axis` along dim (the FSDP gather of a leaf's
    shards); differentiable (`_GatherOverAxis`). Identity on an axis of
    size 1."""
    if SH.axis_size(mesh, axis) == 1:
        return x
    return _GatherOverAxis.apply(x, mesh, axis, dim, redundant)


def gather_parts(x: torch.Tensor, mesh, dim: int, parts) -> torch.Tensor:
    """The whole of an activation split over `model` along dim: rank r
    holds the index range parts[r] = (start, stop) (ranges may overlap and
    differ in length; together they cover 0 .. total). Each index comes
    from the first rank that holds it. No gradient (the serving steps')."""
    n = SH.axis_size(mesh, "model")
    if n == 1:
        return x
    width = max(b - a for a, b in parts)
    if x.shape[dim] < width:
        pad = list(x.shape)
        pad[dim] = width - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    both = all_gather(x, mesh, "model", dim)          # n * width along dim
    total = max(b for _, b in parts)
    owner = [next(r for r, (a, b) in enumerate(parts) if a <= i < b)
             for i in range(total)]
    idx = [owner[i] * width + i - parts[owner[i]][0] for i in range(total)]
    if idx == list(range(total)):
        return both.narrow(dim, 0, total)
    return both.index_select(dim, torch.tensor(idx, device=x.device))


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, start: int,
                mesh) -> torch.Tensor:
    """Rows `tokens` of an embedding table split over `model` by vocabulary:
    this rank holds rows start .. start + len(table); a token outside them
    looks up zeros, and the ranks' lookups are summed over `model`."""
    local = tokens - start
    mine = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(mine, local, torch.zeros_like(local))]
    rows = rows * mine[..., None].to(rows.dtype)
    return reduce_over_axis(rows, mesh, "model")


class _MaxOverAxis(torch.autograd.Function):
    """All-reduce (MAX) forward, no gradient (a softmax's shift)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x.contiguous().clone(), mesh, axis,
                           dist.ReduceOp.MAX)

    @staticmethod
    def backward(ctx, g):
        return None, None, None


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                       start: int, mesh) -> torch.Tensor:
    """The mean negative log-likelihood of `targets` under logits split
    over `model` by vocabulary (this rank's columns start .. start +
    logits.shape[-1]): the row max by an all-reduce (MAX), the sum of
    exponentials and the target's logit by all-reduces (SUM), each over
    `model`. Differentiable in `logits`."""
    lf = logits.float()
    m = _MaxOverAxis.apply(torch.amax(lf.detach(), dim=-1), mesh, "model")
    sumexp = reduce_over_axis(torch.sum(torch.exp(lf - m[..., None]), dim=-1),
                              mesh, "model")
    local = targets.long() - start
    mine = (local >= 0) & (local < lf.shape[-1])
    picked = torch.gather(lf, -1, torch.where(mine, local, 0)[..., None])
    tgt = reduce_over_axis(picked[..., 0] * mine.to(lf.dtype), mesh, "model")
    return torch.mean(torch.log(sumexp) + m - tgt)


def take(t: torch.Tensor, spec, mesh, *, dim: Optional[int] = None,
         ranges=None, redundant: bool = False) -> torch.Tensor:
    """This rank's piece of a leaf from its shard t, placed by `spec` (one
    entry a dimension of t, ``sharding.spec_of``): the leaf whole over
    `data` (gathered, the batch's partial gradients reduce-scattered back)
    and, along `dim`, the index ranges `ranges` concatenated; with dim None
    the whole leaf. The ranges come from the rank's own shard when they are
    exactly it; otherwise the leaf is gathered over `model` first (a unit,
    a head or a gate / up pair, cut by the contiguous shards), as is any
    other dimension placed over `model`. `redundant`: every rank of
    `model` does the same work with the gathered leaf (its gradient is
    then taken, not summed, over `model`)."""
    for d, ax in enumerate(spec):
        if ax == "data":
            t = gather_over_axis(t, mesh, "data", d)
    for d, ax in enumerate(spec):
        if ax != "model":
            continue
        size, i = t.shape[d], SH.axis_index(mesh, "model")
        if d == dim and list(ranges) == [(i * size, (i + 1) * size)]:
            return t
        t = gather_over_axis(t, mesh, "model", d, redundant=redundant)
    if dim is None:
        return t
    merged = []
    for a, b in ranges:
        if merged and merged[-1][1] == a:
            merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    if merged == [(0, t.shape[dim])]:
        return t
    pieces = [t.narrow(dim, a, b - a) for a, b in merged]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)
