"""The train step (port of ``repro/launch/steps.py::make_train_step``).

Training differentiates the family's loss by autograd with every layer
checkpointed (remat), with optional microbatch gradient accumulation, and
applies AdamW. The training path is plain PyTorch, as the JAX package's is
plain XLA: it launches none of the hand-written kernels, which have no
backward.

Only what the port's callers use is ported. The JAX step's `use_lamp`,
`lr_schedule`, `attn_impl` and `model_kwargs` wait for a caller that sets
them: the step runs LAMP off and the attention's default arm, at
`opt_cfg.lr` (``api.loss_fn`` takes `use_lamp`, and
``optim.adamw.apply_updates`` an `lr`). JAX's `make_prefill_step` /
`make_serve_step` wait for the dry run, their one caller; ``api.prefill``
and ``api.decode_step`` do their work. The JAX package's `moe_groups`
(the MoE dispatch-group count) waits for the port's expert-parallel MoE
(``moe_apply_ep``): the port dispatches in one group, the JAX default.
"""

from __future__ import annotations

import torch

from repro_torch.core import tree as T
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


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, *,
                    num_microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics {"loss", "grad_norm"}). With M > 1 microbatches the batch's
    leading axis splits into M chunks, the gradients are summed in FP32 and
    divided by M and the loss averaged."""

    def lossf(p, b):
        return api.loss_fn(cfg, p, b, remat=True)

    def train_step(params, opt_state, batch):
        if num_microbatches == 1:
            (loss, _), grads = value_and_grad(lossf, params, batch)
        else:
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
            grads = T.map(lambda g: g / M, g_acc)
            loss = loss / M
        params, opt_state, om = adamw.apply_updates(opt_cfg, params, grads,
                                                    opt_state)
        return params, opt_state, {"loss": loss, **om}

    return train_step

