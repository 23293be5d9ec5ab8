"""The train step (port of ``repro/launch/steps.py::make_train_step``).

Training differentiates the family's loss by autograd with every layer
checkpointed (remat), with optional microbatch gradient accumulation, and
applies AdamW. The training path is plain PyTorch, as the JAX package's is
plain XLA: it launches none of the hand-written kernels, which have no
backward.

`make_sharded_train_step` is the port's counterpart of the JAX loop's step
jitted with in / out shardings on a mesh: params and AdamW state at rest
as DTensors placed by ``distributed.sharding``, the compute data-parallel
(each rank gathers every leaf, runs `make_grad_step` on its rows of the
batch under the ambient mesh, so the MoE family dispatches expert-parallel,
and the gradients are averaged over the batch axes); each rank updates its
own shards. There is no tensor-parallel compute over `model`.

Only what the port's callers use is ported. The JAX step's `use_lamp`,
`lr_schedule`, `attn_impl` and `model_kwargs` wait for a caller that sets
them: the step runs LAMP off and the attention's default arm, at
`opt_cfg.lr` (``api.loss_fn`` takes `use_lamp`, and
``optim.adamw.apply_updates`` an `lr`). JAX's `make_prefill_step` /
`make_serve_step` wait for the dry run, their one caller; ``api.prefill``
and ``api.decode_step`` do their work.
"""

from __future__ import annotations

import torch

from repro_torch.core import tree as T
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as SH
from repro_torch.models import api
from repro_torch.optim import adamw


def value_and_grad(lossf, params, batch):
    """((loss, metrics), grads): `lossf(params, batch)` and its gradient
    with respect to every leaf of `params` (zeros for a leaf the loss does
    not use, as ``jax.value_and_grad`` gives), each in its leaf's dtype."""
    leaves = [t.detach().requires_grad_(True) for t in T.leaves(params)]
    loss, metrics = lossf(T.unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return (loss.detach(), metrics), T.unflatten(params, list(grads))


def make_grad_step(cfg, *, num_microbatches: int = 1, moe_groups: int = 1):
    """Returns grad_step(params, batch) -> (loss, grads). With M > 1
    microbatches the batch's leading axis splits into M chunks, the
    gradients are summed in FP32 and divided by M and the loss averaged."""

    def lossf(p, b):
        return api.loss_fn(cfg, p, b, remat=True, moe_groups=moe_groups)

    def grad_step(params, batch):
        if num_microbatches == 1:
            (loss, _), grads = value_and_grad(lossf, params, batch)
            return loss, grads
        M = num_microbatches

        def split(x):
            return x.reshape(M, x.shape[0] // M, *x.shape[1:])
        mb = {k: split(v) for k, v in batch.items()}
        g_acc = T.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)
        loss = 0.0
        for i in range(M):
            (l, _), g = value_and_grad(lossf, params,
                                       {k: v[i] for k, v in mb.items()})
            g_acc = T.map(lambda a, x: a + x.float(), g_acc, g)
            loss = loss + l
        return loss / M, T.map(lambda g: g / M, g_acc)

    return grad_step


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, *,
                    num_microbatches: int = 1, moe_groups: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics {"loss", "grad_norm"}): `make_grad_step`, then AdamW."""
    grad_step = make_grad_step(cfg, num_microbatches=num_microbatches,
                               moe_groups=moe_groups)

    def train_step(params, opt_state, batch):
        loss, grads = grad_step(params, batch)
        params, opt_state, om = adamw.apply_updates(opt_cfg, params, grads,
                                                    opt_state)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_sharded_train_step(cfg, opt_cfg: adamw.AdamWConfig, mesh, *,
                            num_microbatches: int = 1, moe_groups: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics) on `mesh`: params and opt_state DTensor trees (placed by
    ``sharding.param_specs`` / ``opt_specs``), `batch` the whole global
    batch on every rank (its leading axis divisible by the batch shards).
    The loss and gradients are the whole batch's means; the gradients are
    clipped by their global norm, and each rank applies AdamW to its
    shards. On a one-rank mesh the step equals `make_train_step`'s bit for
    bit."""
    grad_step = make_grad_step(cfg, num_microbatches=num_microbatches,
                               moe_groups=moe_groups)
    baxes = SH.batch_axes(mesh)

    def train_step(params, opt_state, batch):
        full = SH.gather(params)
        rows = SH.batch_rows(mesh, next(iter(batch.values())).shape[0])
        with SH.set_mesh(mesh):
            loss, grads = grad_step(full, {k: v[rows] for k, v in
                                           batch.items()})
        del full
        loss = C.axis_mean(loss, mesh, baxes)
        grads = T.map(lambda g: C.axis_mean(g, mesh, baxes), grads)
        grads, gnorm = adamw.clip_by_global_norm(grads, opt_cfg.grad_clip)
        local = T.map(lambda g, p: _shard_like(g, p), grads, params)
        del grads
        new_p, new_o = adamw.update(
            opt_cfg, T.map(SH.to_local, params), local,
            adamw.AdamWState(*(T.map(SH.to_local, t) for t in opt_state)))
        return (T.map(_like, new_p, params),
                adamw.AdamWState(*(T.map(_like, n, o)
                                   for n, o in zip(new_o, opt_state))),
                {"loss": loss, "grad_norm": gnorm})

    return train_step


def _shard_like(g, p):
    """This rank's shard of the whole tensor g, as p (a DTensor) is
    placed."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(g, p.device_mesh, p.placements,
                             src_data_rank=None).to_local()


def _like(local, p):
    """The local tensor `local` as a DTensor placed as p is."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, p.device_mesh, p.placements,
                              run_check=False, shape=p.shape,
                              stride=p.stride())
