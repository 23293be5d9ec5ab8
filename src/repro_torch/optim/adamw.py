"""AdamW (decoupled weight decay) on nested dicts of tensors (port of
``repro/optim/adamw.py``).

Optimizer state (m, v) is kept in FP32 whatever the param dtype (the
standard bf16-training recipe). The update math runs in FP32 and is cast
back to the param dtype. Leaves are visited in JAX's pytree order
(``core.tree``), so the global norm sums them as the JAX package does.
`apply_updates` returns new tensors and leaves its inputs as they were, as
the JAX function does; it records no gradient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import tree as T


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_state(params) -> AdamWState:
    """step 0 (int32) and FP32 zeros for m and v, on the params' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = T.leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=T.map(zeros, params), v=T.map(zeros, params))


def global_norm(tree, shard_axes=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum over the leaves of each leaf's sum of squares.

    With `shard_axes` (a tuple of mesh axis names for each leaf of `tree`,
    in its order) the leaves are this rank's shards on `mesh`: each leaf's
    sum is added over the ranks of the axes it is split over, one
    all-reduce (SUM) an axis for all leaves; over an axis it is replicated
    on, it is counted once."""
    sq = [torch.sum(torch.square(x.float())) for x in T.leaves(tree)]
    if shard_axes is not None:
        import torch.distributed as dist
        names = [a for a in mesh.mesh_dim_names
                 if any(a in axes for axes in shard_axes)]
        vec = torch.stack(sq)
        for a in names:
            if mesh.get_group(a).size() == 1:
                continue
            on = torch.tensor([a in axes for axes in shard_axes],
                              device=vec.device)
            part = torch.where(on, vec, torch.zeros_like(vec))
            dist.all_reduce(part, group=mesh.get_group(a))
            vec = torch.where(on, part, vec)
        sq = list(vec.unbind())
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads, max_norm: float, shard_axes=None,
                        mesh=None) -> Tuple[Any, torch.Tensor]:
    """`grads` scaled by min(1, max_norm / their global norm), and the
    norm (`global_norm`'s `shard_axes` / `mesh` for a rank's shards)."""
    norm = global_norm(grads, shard_axes, mesh)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return T.map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState,
                  lr: Optional[torch.Tensor] = None
                  ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step after clipping `grads` by their global norm: (new
    params in their dtypes, new state, {"grad_norm"}). `lr` (a float or a
    0-d tensor, e.g. a schedule's value) overrides `cfg.lr`."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    params, state = update(cfg, params, grads, state, lr=lr)
    return params, state, {"grad_norm": gnorm}


@torch.no_grad()
def update(cfg: AdamWConfig, params, grads, state: AdamWState,
           lr: Optional[torch.Tensor] = None) -> Tuple[Any, AdamWState]:
    """`apply_updates` after the clip: the AdamW step of each leaf on its
    own (so a rank can update its shards of params, grads and state
    alone). Returns (new params, new state)."""
    step = state.step + 1
    lr = cfg.lr if lr is None else lr
    sf = step.float()
    # the bias corrections 1 - b**step in FP32, as the JAX package computes
    # them (its Python float b is a weakly typed FP32 scalar)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=sf.device), sf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=sf.device), sf)

    def upd(p, g, m, v):
        gf = g.float()
        m = cfg.b1 * m + (1 - cfg.b1) * gf
        v = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        mhat = m / b1c
        vhat = v / b2c
        pf = p.float()
        pf = pf - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                        + cfg.weight_decay * pf)
        return pf.to(p.dtype), m, v

    out = [_chunked(upd, p, g, m, v) for p, g, m, v in zip(
        T.leaves(params), T.leaves(grads), T.leaves(state.m),
        T.leaves(state.v))]
    new_p = T.unflatten(params, [o[0] for o in out])
    new_m = T.unflatten(params, [o[1] for o in out])
    new_v = T.unflatten(params, [o[2] for o in out])
    return new_p, AdamWState(step, new_m, new_v)


# elements a chunk of `update`'s elementwise math: its FP32 temporaries
# stay a few of these, not a few of the largest leaf
CHUNK = 1 << 24


def _chunked(upd, p, g, m, v):
    """upd(p, g, m, v) -> (p, m, v) over flat chunks of CHUNK elements,
    written into whole outputs (elementwise: the same bits as one call)."""
    if p.numel() <= CHUNK:
        return upd(p, g, m, v)
    outs = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in (p, m, v))
    flat = [t.reshape(-1) for t in (p, g, m, v) + outs]
    for s in range(0, p.numel(), CHUNK):
        for o, r in zip(flat[4:], upd(*(t[s:s + CHUNK] for t in flat[:4]))):
            o[s:s + CHUNK] = r
    return outs


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    """lr_at(step): linear warmup to `base_lr`, then a cosine decay to
    `min_frac` of it at `total`; FP32 0-d tensors on the step's device."""
    def lr_at(step):
        s = torch.as_tensor(step).float()
        warm = base_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos)
    return lr_at
