"""GPipe-style pipeline parallelism over a `stage` mesh axis (port of
``repro/distributed/pipeline.py``).

The layer stack is split into S contiguous stages; microbatches flow
through the stages with activations handed to the next stage by
point-to-point sends on the stage axis' process group. The schedule is the
classic GPipe fill-drain loop (M + S - 1 ticks for M microbatches).

An optional parallelism mode (the production meshes are data x model); it
covers depth-dominated models (mistral-large-123b at 88 layers is the
natural customer). The handoffs are point-to-point sends, which gloo does
not take for CUDA tensors (the pair's connection dies): on cards the stage
group needs NCCL, one rank a card.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core import tree as T

from . import sharding as SH


def _stage_slice(t, sid: int):
    """This stage's slice of a stacked (S, ...) leaf: a DTensor sharded over
    the stage axis gives its local (1, ...) shard, a whole tensor its row
    `sid`."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return t.to_local()[0]
    return t[sid]


def pipeline_apply(mesh, stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_mb: torch.Tensor, *,
                   stage_axis: str = "stage") -> torch.Tensor:
    """Run x_mb (M, mb, ...) microbatches through S pipeline stages; every
    rank of the stage axis calls it with the same x_mb.

    stage_params: a tree whose leaves have leading dim S (`split_stages`),
    whole on every rank or DTensors sharded over `stage_axis`; each rank
    runs its own stage's slice. stage_fn(params_slice, x) -> y must
    preserve x's shape (a transformer block stack does). Returns the (M,
    mb, ...) outputs on every rank.
    """
    S = SH.axis_size(mesh, stage_axis)
    M = x_mb.shape[0]
    if M < S:
        raise ValueError(f"need microbatches >= stages, got {M} < {S}")
    sid = SH.axis_index(mesh, stage_axis)
    p = T.map(lambda t: _stage_slice(t, sid), stage_params)
    group = SH.axis_group(mesh, stage_axis) if S > 1 else None
    nxt_rank = prv_rank = None
    if S > 1:
        nxt_rank = dist.get_global_rank(group, (sid + 1) % S)
        prv_rank = dist.get_global_rank(group, (sid - 1) % S)

    buf = torch.zeros(x_mb.shape[1:], dtype=x_mb.dtype, device=x_mb.device)
    out = torch.zeros_like(x_mb)
    for t in range(M + S - 1):
        # stage 0 injects microbatch t (if any); the others take the handoff
        cur = x_mb[min(t, M - 1)] if sid == 0 else buf
        y = stage_fn(p, cur).to(x_mb.dtype)
        # hand off to the next stage (a ring; stage 0 ignores what the last
        # stage sends, as it always injects)
        if S > 1:
            buf = torch.empty_like(y)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y.contiguous(), nxt_rank, group),
                dist.P2POp(dist.irecv, buf, prv_rank, group)])
            for r in reqs:
                r.wait()
        else:
            buf = y
        # the last stage records microbatch t - (S - 1) when valid
        mb_idx = t - (S - 1)
        if sid == S - 1 and mb_idx >= 0:
            out[mb_idx] = y
    # every stage gets the result: the sum of a buffer that only the last
    # stage fills
    if sid != S - 1:
        out.zero_()
    if S > 1:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def split_stages(params_stacked: Any, n_stages: int) -> Any:
    """Reshape stacked layer params (L, ...) -> (S, L // S, ...) stage
    slices."""
    def one(t):
        L = t.shape[0]
        if L % n_stages:
            raise ValueError(f"L={L} not divisible by stages={n_stages}")
        return t.reshape(n_stages, L // n_stages, *t.shape[1:])
    return T.map(one, params_stacked)
