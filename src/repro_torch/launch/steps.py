"""Step functions: the train step, the prefill step and the serve step
(port of ``repro/launch/steps.py``).

Training differentiates the family's loss by autograd with every layer
checkpointed (remat), with optional microbatch gradient accumulation, and
applies AdamW. The training path is plain PyTorch, as the JAX package's is
plain XLA: it launches none of the hand-written kernels, which have no
backward. `make_prefill_step` / `make_serve_step` are plain closures over
``api.prefill`` / ``api.decode_step`` with LAMP on, as the JAX package's
are; the dry run (``launch.dryrun``) is their caller.

`make_sharded_train_step`, `make_sharded_prefill_step` and
`make_sharded_serve_step` are the port's counterparts of the JAX steps
jitted with in / out shardings on a mesh: params, AdamW state and caches
at rest as DTensors placed by ``distributed.sharding`` (``param_specs`` /
``opt_specs`` / ``cache_specs``), the batch over (`pod`, `data`). For the
transformer families (gpt2, dense, moe, llava) they compute as XLA's SPMD
partitioner runs JAX's: FSDP over `data` x tensor parallelism over
`model` (``transformer.loss_fn_tp`` / ``prefill_tp`` / ``decode_step_tp``
on the rank's shards: each layer's leaves gathered over `data` inside the
layer, heads, hidden units and the vocabulary split over `model`, the MoE
expert-parallel), never gathering the whole tree. rwkv6, hymba and
whisper stay data-parallel: the rank gathers every leaf, runs the plain
step on its rows of the batch (and of the cache, whole over `model`),
averages the gradients over the batch axes or keeps its shard of the new
cache. A batch the batch axes do not divide is replicated in the prefill
and serve steps, as the JAX dry run's ``batch_specs`` replicates it; the
train step and the transformer families' serve step refuse it.

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
from repro_torch.models import layers as LY
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
    return _grad_fn(lossf, num_microbatches)


def _grad_fn(lossf, num_microbatches: int, loss_of=lambda l, m: l):
    """grad_step(params, batch) -> (loss, grads) of `lossf` over
    `num_microbatches` (`make_grad_step`); `loss_of(loss, metrics)` is the
    loss it reports."""
    def grad_step(params, batch):
        if num_microbatches == 1:
            (loss, metrics), grads = value_and_grad(lossf, params, batch)
            return loss_of(loss, metrics), grads
        M = num_microbatches

        def split(x):
            return x.reshape(M, x.shape[0] // M, *x.shape[1:])
        mb = {k: split(v) for k, v in batch.items()}
        g_acc = T.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)
        loss = 0.0
        for i in range(M):
            (l, metrics), g = value_and_grad(lossf, params,
                                             {k: v[i] for k, v in mb.items()})
            g_acc = T.map(lambda a, x: a + x.float(), g_acc, g)
            loss = loss + loss_of(l, metrics)
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
    clipped by their global norm (each shard counted once), and each rank
    applies AdamW to its shards. The transformer families compute
    tensor-parallel (`_tp_train_step`); rwkv6, hymba and whisper
    data-parallel (`_dp_train_step`). On a one-rank mesh the step equals
    `make_train_step`'s bit for bit."""
    if cfg.family in transformer.DENSE_FAMILIES:
        return _tp_train_step(cfg, opt_cfg, mesh, num_microbatches,
                              moe_groups, model_kwargs or {})
    return _dp_train_step(cfg, opt_cfg, mesh, num_microbatches, moe_groups,
                          model_kwargs)


def _tp_train_step(cfg, opt_cfg, mesh, num_microbatches, moe_groups,
                   model_kwargs):
    """FSDP over `data` x tensor parallelism over `model`: the rank's
    rows run ``transformer.loss_fn_tp`` on its shards (each layer's leaves
    gathered over `data` inside the checkpointed layer, the batch's
    partial gradients reduce-scattered back in the backward); each
    gradient is then summed over the batch axes it is not split over and
    divided by their size."""
    tp = LY.tensor_parallel(cfg, mesh)
    baxes = SH.batch_axes(mesh)
    n_batch = SH.batch_size(mesh)

    def train_step(params, opt_state, batch):
        specs = T.map(SH.spec_of, params)
        rows = SH.batch_rows(mesh, next(iter(batch.values())).shape[0])

        def lossf(p, b):
            return transformer.loss_fn_tp(cfg, tp, p, specs, b, remat=True,
                                          moe_groups=moe_groups,
                                          **model_kwargs)
        grad_step = _grad_fn(lossf, num_microbatches,
                             loss_of=lambda l, m: m["loss"])
        loss, grads = grad_step(T.map(SH.to_local, params),
                                {k: v[rows] for k, v in batch.items()})
        axes = T.map(lambda sp: tuple(a for e in sp
                                      for a in SH.axes_of(e)), specs)
        grads = T.map(lambda g, ax: _batch_mean(g, ax, mesh, baxes, n_batch),
                      grads, axes)
        grads, gnorm = adamw.clip_by_global_norm(
            grads, opt_cfg.grad_clip, shard_axes=T.leaves(axes), mesh=mesh)
        leaves = T.leaves(grads)
        del grads
        return _apply(opt_cfg, params, opt_state, leaves,
                      {"loss": loss, "grad_norm": gnorm})

    return train_step


def _batch_mean(g, axes, mesh, baxes, n_batch: int):
    """The mean over the batch shards of a rank's gradient shard: summed
    over the batch axes it is not split over (the backward's
    reduce-scatter summed it over those in `axes`), over their size."""
    rest = [a for a in baxes if a not in axes and SH.axis_size(mesh, a) > 1]
    if rest:
        g = C.axis_sum(g, mesh, rest)
    return g / n_batch if n_batch > 1 else g


def _apply(opt_cfg, params, opt_state, grads, metrics):
    """AdamW on each rank's shards, a leaf at a time (``adamw.update``'s
    arithmetic), each gradient released once applied: `grads` is the
    step's own list of its local gradients, in the params' leaf order.
    The new params and state as DTensors placed as the old."""
    step = SH.to_local(opt_state.step)
    out = []
    for i, (p, m, v) in enumerate(zip(*(T.leaves(t) for t in (
            params, opt_state.m, opt_state.v)))):
        g, grads[i] = grads[i], None
        new_p, new_o = adamw.update(opt_cfg, SH.to_local(p), g,
                                    adamw.AdamWState(step, SH.to_local(m),
                                                     SH.to_local(v)))
        out.append((_like(new_p, p), _like(new_o.m, m), _like(new_o.v, v)))
        del g
    return (T.unflatten(params, [o[0] for o in out]),
            adamw.AdamWState(_like(new_o.step, opt_state.step),
                             T.unflatten(params, [o[1] for o in out]),
                             T.unflatten(params, [o[2] for o in out])),
            metrics)


def _dp_train_step(cfg, opt_cfg, mesh, num_microbatches, moe_groups,
                   model_kwargs):
    """Data-parallel (rwkv6, hymba, whisper): each rank gathers every
    leaf, runs `make_grad_step` on its rows of the batch, and the
    gradients are averaged over the batch axes."""
    grad_step = make_grad_step(cfg, num_microbatches=num_microbatches,
                               moe_groups=moe_groups,
                               model_kwargs=model_kwargs)
    baxes = SH.batch_axes(mesh)

    def train_step(params, opt_state, batch):
        full = SH.gather(params)
        rows = SH.batch_rows(mesh, next(iter(batch.values())).shape[0])
        loss, grads = grad_step(full, {k: v[rows] for k, v in batch.items()})
        del full
        loss = C.axis_mean(loss, mesh, baxes)
        grads = T.map(lambda g: C.axis_mean(g, mesh, baxes), grads)
        grads, gnorm = adamw.clip_by_global_norm(grads, opt_cfg.grad_clip)
        local = T.leaves(T.map(lambda g, p: _shard_like(g, p), grads,
                               params))
        del grads
        return _apply(opt_cfg, params, opt_state, local,
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
    """`make_prefill_step` on `mesh`: params and cache DTensor trees,
    `batch` the whole global batch on every rank. Returns (last logits as
    a DTensor over the batch axes, or replicated, the new cache placed as
    `cache` is). The transformer families run tensor-parallel
    (``transformer.prefill_tp`` on the rank's shards and cache shards);
    rwkv6, hymba and whisper data-parallel (`_data_parallel`). A batch the
    batch axes do not divide is replicated. On a one-rank mesh it equals
    the plain step bit for bit."""
    model_kwargs = model_kwargs or {}
    if cfg.family in transformer.DENSE_FAMILIES:
        tp = LY.tensor_parallel(cfg, mesh)

        def tp_prefill(params, cache, batch):
            n = next(iter(batch.values())).shape[0]
            rows = _rows(mesh, n)
            k, v, first = _cache_shards(cache, mesh)
            logits = transformer.prefill_tp(
                cfg, tp, T.map(SH.to_local, params),
                T.map(SH.spec_of, params), batch["tokens"][rows], k, v,
                first=first, rows_split=rows != slice(None),
                image_embeds=(batch["image_embeds"][rows]
                              if "image_embeds" in batch else None),
                use_lamp=use_lamp, attn_impl=attn_impl,
                moe_groups=moe_groups, **model_kwargs)
            T_ = batch["tokens"].shape[1] + (
                batch["image_embeds"].shape[1] if "image_embeds" in batch
                else 0)
            length = cache["length"]
            new_len = torch.full(tuple(length.shape), T_, dtype=length.dtype,
                                 device=k.device)
            return (_from_rows(logits, mesh, n, rows),
                    {"k": cache["k"], "v": cache["v"],
                     "length": _like(_shard_like(new_len, length), length)})
        return tp_prefill
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
    the whole (B, 1) batch on every rank. The transformer families run
    tensor-parallel (``transformer.decode_step_tp`` on the rank's shards
    and cache shards, the batch axes must divide B: sequence-parallel
    attention where `model` > 1 divides the cache's positions); rwkv6,
    hymba and whisper data-parallel, as `make_sharded_prefill_step`.
    Returns (logits as a DTensor over the batch axes, or replicated, the
    new cache as placed). On a one-rank mesh it equals the plain step bit
    for bit."""
    model_kwargs = model_kwargs or {}
    if cfg.family in transformer.DENSE_FAMILIES:
        tp = LY.tensor_parallel(cfg, mesh)
        n_model = SH.axis_size(mesh, "model")

        def tp_serve(params, cache, tokens):
            n = tokens.shape[0]
            rows = SH.batch_rows(mesh, n)
            k, v, _ = _cache_shards(cache, mesh)
            length = SH.to_local(cache["length"])[rows]
            logits = transformer.decode_step_tp(
                cfg, tp, T.map(SH.to_local, params),
                T.map(SH.spec_of, params), k, v, length, tokens[rows],
                seq_split=n_model > 1 and cache["k"].shape[2] % n_model == 0,
                use_lamp=use_lamp, **model_kwargs)
            return (SH.from_rows(logits, mesh, n),
                    {"k": cache["k"], "v": cache["v"],
                     "length": cache["length"] + 1})
        return tp_serve
    step = make_serve_step(cfg, use_lamp=use_lamp, model_kwargs=model_kwargs)

    def serve_step(params, cache, tokens):
        n = tokens.shape[0]
        return _data_parallel(step, mesh, n, params, cache,
                              tokens[_rows(mesh, n)])
    return serve_step


def _cache_shards(cache, mesh):
    """(k, v, first position): the rank's local shards of the dense cache's
    k and v DTensors (written in place), and the first position its slice
    of the sequence holds (``sharding.cache_specs`` splits it over `model`
    where `model` divides it)."""
    k, v = SH.to_local(cache["k"]), SH.to_local(cache["v"])
    first = 0
    if SH.spec_of(cache["k"])[2] == "model":
        first = SH.axis_index(mesh, "model") * k.shape[2]
    return k, v, first


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
