"""Step functions: the train step, the prefill step and the serve step
(port of ``repro/launch/steps.py``).

Training differentiates the family's loss by autograd with every layer
checkpointed (remat), with optional microbatch gradient accumulation, and
applies AdamW. The training path is plain PyTorch, as the JAX package's is
plain XLA: it launches none of the hand-written kernels, which have no
backward. `make_prefill_step` / `make_serve_step` are plain closures over
``api.prefill`` / ``api.decode_step`` with LAMP on, as the JAX package's
are; the dry run (``launch.dryrun``) is their caller.

`make_sharded_train_step` is the port's counterpart of the JAX loop's step
jitted with in / out shardings on a mesh: params and AdamW state at rest
as DTensors placed by ``distributed.sharding``, the compute data-parallel
(each rank gathers every leaf, runs `make_grad_step` on its rows of the
batch under the ambient mesh, so the MoE family dispatches expert-parallel,
and the gradients are averaged over the batch axes); each rank updates its
own shards. `make_sharded_prefill_step` / `make_sharded_serve_step` take
params and the cache as DTensors (``sharding.param_specs`` /
``cache_specs``). The dense families' decode runs its SPMD body
(``transformer.decode_step`` under the ambient mesh, on the cache shards);
every other step is data-parallel as the train step is: the rank gathers
the params, takes its rows of the batch and of the cache (the cache whole
over `model`), runs the plain step with no ambient mesh and keeps its
shard of the new cache. A batch the batch axes do not divide is
replicated in these two steps, as the JAX dry run's ``batch_specs``
replicates it. There is no tensor-parallel compute over `model`.

Only what the port's callers use is ported. The JAX train step's
`use_lamp`, `lr_schedule` and `attn_impl` wait for a caller that sets
them: the step runs LAMP off at `opt_cfg.lr` (``api.loss_fn`` takes
`use_lamp` and `attn_impl` through `model_kwargs`, and
``optim.adamw.apply_updates`` an `lr`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import tree as T
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as SH
from repro_torch.models import api, transformer
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


def make_grad_step(cfg, *, num_microbatches: int = 1, moe_groups: int = 1,
                   model_kwargs: Optional[Dict] = None):
    """Returns grad_step(params, batch) -> (loss, grads). With M > 1
    microbatches the batch's leading axis splits into M chunks, the
    gradients are summed in FP32 and divided by M and the loss averaged.
    `model_kwargs` go to ``api.loss_fn`` (rwkv6's `wkv_chunk`, say)."""
    model_kwargs = model_kwargs or {}

    def lossf(p, b):
        return api.loss_fn(cfg, p, b, remat=True, moe_groups=moe_groups,
                           **model_kwargs)

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
                    num_microbatches: int = 1, moe_groups: int = 1,
                    model_kwargs: Optional[Dict] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics {"loss", "grad_norm"}): `make_grad_step`, then AdamW."""
    grad_step = make_grad_step(cfg, num_microbatches=num_microbatches,
                               moe_groups=moe_groups,
                               model_kwargs=model_kwargs)

    def train_step(params, opt_state, batch):
        loss, grads = grad_step(params, batch)
        params, opt_state, om = adamw.apply_updates(opt_cfg, params, grads,
                                                    opt_state)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_sharded_train_step(cfg, opt_cfg: adamw.AdamWConfig, mesh, *,
                            num_microbatches: int = 1, moe_groups: int = 1,
                            model_kwargs: Optional[Dict] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics) on `mesh`: params and opt_state DTensor trees (placed by
    ``sharding.param_specs`` / ``opt_specs``), `batch` the whole global
    batch on every rank (its leading axis divisible by the batch shards).
    The loss and gradients are the whole batch's means; the gradients are
    clipped by their global norm, and each rank applies AdamW to its
    shards. On a one-rank mesh the step equals `make_train_step`'s bit for
    bit."""
    grad_step = make_grad_step(cfg, num_microbatches=num_microbatches,
                               moe_groups=moe_groups,
                               model_kwargs=model_kwargs)
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


def make_prefill_step(cfg, *, use_lamp: bool = True, attn_impl: str = "auto",
                      moe_groups: int = 1, model_kwargs: Optional[Dict] = None):
    """Returns prefill_step(params, cache, batch) -> (last logits, cache)."""
    model_kwargs = model_kwargs or {}

    def prefill_step(params, cache, batch):
        return api.prefill(cfg, params, batch, cache, use_lamp=use_lamp,
                           attn_impl=attn_impl,
                           **({"moe_groups": moe_groups}
                              if cfg.family == "moe" else {}),
                           **model_kwargs)
    return prefill_step


def make_serve_step(cfg, *, use_lamp: bool = True,
                    model_kwargs: Optional[Dict] = None):
    """One batched decode step: (params, cache, tokens) -> (logits, cache)."""
    model_kwargs = model_kwargs or {}

    def serve_step(params, cache, tokens):
        return api.decode_step(cfg, params, cache, tokens, use_lamp=use_lamp,
                               **model_kwargs)
    return serve_step


def make_sharded_prefill_step(cfg, mesh, *, use_lamp: bool = True,
                              attn_impl: str = "auto", moe_groups: int = 1,
                              model_kwargs: Optional[Dict] = None):
    """`make_prefill_step` on `mesh`, data-parallel: params and cache
    DTensor trees, `batch` the whole global batch on every rank. Returns
    (last logits as a DTensor over the batch axes, or replicated, the new
    cache placed as `cache` is). On a one-rank mesh it equals the plain
    step bit for bit."""
    step = make_prefill_step(cfg, use_lamp=use_lamp, attn_impl=attn_impl,
                             moe_groups=moe_groups, model_kwargs=model_kwargs)

    def prefill_step(params, cache, batch):
        n = next(iter(batch.values())).shape[0]
        rows = _rows(mesh, n)
        return _data_parallel(step, mesh, n, params, cache,
                              {k: v[rows] for k, v in batch.items()})
    return prefill_step


def make_sharded_serve_step(cfg, mesh, *, use_lamp: bool = True,
                            model_kwargs: Optional[Dict] = None):
    """`make_serve_step` on `mesh`: params and cache DTensor trees, `tokens`
    the whole (B, 1) batch on every rank. The dense families run
    ``transformer.decode_step``'s SPMD body under the ambient mesh on the
    cache shards (the batch axes must divide B); the others run
    data-parallel, as `make_sharded_prefill_step`. Returns (logits as a
    DTensor over the batch axes, or replicated, the new cache as placed).
    On a one-rank mesh it equals the plain step bit for bit."""
    step = make_serve_step(cfg, use_lamp=use_lamp, model_kwargs=model_kwargs)
    spmd = cfg.family in transformer.DENSE_FAMILIES

    def serve_step(params, cache, tokens):
        if spmd:
            full = SH.gather(params)
            with SH.set_mesh(mesh):
                return step(full, cache, tokens)
        n = tokens.shape[0]
        return _data_parallel(step, mesh, n, params, cache,
                              tokens[_rows(mesh, n)])
    return serve_step


def _rows(mesh, n_rows: int) -> slice:
    """The batch rows this rank runs: its ``sharding.batch_rows``, or every
    row where the batch axes do not divide `n_rows` (the batch
    replicated)."""
    if n_rows % SH.batch_size(mesh):
        return slice(None)
    return SH.batch_rows(mesh, n_rows)


def _data_parallel(step, mesh, n_rows: int, params, cache, inputs):
    """step(whole params, the rank's rows of the cache whole over `model`,
    inputs) with no ambient mesh: the logits as a DTensor of all n_rows,
    and the new cache as DTensors placed as `cache` is (the rank keeps its
    shard)."""
    full = SH.gather(params)
    rows = _rows(mesh, n_rows)
    local = T.map(lambda c: _cache_rows(c, mesh, rows), cache)
    logits, new = step(full, local, inputs)
    del full, local
    return (_from_rows(logits, mesh, n_rows, rows),
            T.map(lambda n, c: _cache_shard(n, c, mesh, n_rows, rows),
                  new, cache))


def _bdim(t) -> int:
    """The batch dimension of a cache leaf (``sharding.cache_specs``)."""
    return 1 if t.ndim >= 2 else 0


def _from_rows(t, mesh, n_rows: int, rows: slice):
    """The rank's rows `rows` of a result as a DTensor of all n_rows:
    sharded over the batch axes, or replicated when every rank ran every
    row."""
    from torch.distributed.tensor import DTensor, Replicate
    if rows == slice(None):
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return SH.from_rows(t, mesh, n_rows)


def _cache_rows(c, mesh, rows: slice):
    """The rows `rows` of the cache leaf c (a DTensor), whole over
    `model`."""
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if n == "model" else p
          for n, p in zip(mesh.mesh_dim_names, c.placements)]
    local = c.redistribute(mesh, pl).to_local()
    if rows != slice(None) and not any(p.is_shard(_bdim(c)) for p in pl):
        local = local[(slice(None),) * _bdim(c) + (rows,)]
    return local


def _cache_shard(new, c, mesh, n_rows: int, rows: slice):
    """The new cache leaf `new` (the rank's rows, whole over `model`) as a
    DTensor placed as the leaf c was: the rank's shard over `model`, and a
    leaf that c held whole over the batch (`length`) gathered back from
    the ranks' rows."""
    from torch.distributed.tensor import DTensor
    if rows != slice(None) and not any(p.is_shard(_bdim(c))
                                       for p in c.placements):
        new = SH.from_rows(new, mesh, n_rows).full_tensor()
    for n, p in zip(mesh.mesh_dim_names, c.placements):
        if n == "model" and p.is_shard():
            size = new.shape[p.dim] // SH.axis_size(mesh, "model")
            new = new.narrow(p.dim, SH.axis_index(mesh, "model") * size,
                             size).clone()
    return DTensor.from_local(new, mesh, c.placements, run_check=False,
                              shape=c.shape, stride=c.stride())


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
