"""Fault-tolerant training loop (port of ``repro/runtime/train_loop.py``).

Integrates the substrates: the sharded train step, deterministic
resumable data, async atomic checkpointing, straggler monitoring,
preemption-signal handling. Runs identically on a one-rank mesh
(``launch.mesh.make_host_mesh``) and a production mesh: params and AdamW
state live as DTensors placed by the sharding rules
(``distributed.sharding``), and the step is
``launch.steps.make_sharded_train_step``. The JAX step's donated buffers
have no counterpart: the update returns new tensors, and the old ones are
freed when the loop drops them.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.elastic import validate_batch
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.synthetic import DataConfig, SyntheticDataset
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.straggler import StragglerMonitor, StragglerPolicy
from repro_torch.launch import steps as ST
from repro_torch.models import api
from repro_torch.models.transformer import resolve_device
from repro_torch.optim import adamw


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    checkpoint_dir: str = "repro_ckpt"      # relative to the working directory
    keep_last: int = 3
    seed: int = 0
    num_microbatches: int = 1


class PreemptionGuard:
    """Converts SIGTERM into a graceful save-and-exit flag."""

    def __init__(self, install: bool = True):
        self.requested = False
        if install:
            try:
                signal.signal(signal.SIGTERM, self._handler)
            except ValueError:   # not main thread (tests)
                pass

    def _handler(self, signum, frame):
        self.requested = True


def _agree(device, *flags):
    """Each flag raised on any rank (an all-reduce MAX over the world): a
    save is a collective, so every rank must take it, whichever rank's
    monitor or preemption guard asked for it."""
    t = torch.tensor([int(f) for f in flags], device=device)
    if dist.get_world_size() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return [bool(v) for v in t.tolist()]


def train(cfg, mesh, loop: TrainLoopConfig,
          opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
          data_cfg: Optional[DataConfig] = None,
          extra_batch: Optional[Callable[[int], Dict[str, Any]]] = None,
          ) -> Dict[str, Any]:
    """Train `cfg` on `mesh` (a DeviceMesh; every rank calls it). Resumes
    from the latest checkpoint if present; else starts from
    ``api.init_params(cfg, loop.seed)`` on the mesh's device type.

    `extra_batch(step)` supplies stub modality inputs (frames /
    image_embeds) for the whisper and llava families. Returns {"params",
    "opt" (DTensor trees), "metrics" (one {"loss", "grad_norm"} of floats a
    step run), "monitor_events"}."""
    device = resolve_device(mesh.device_type)
    data_cfg = data_cfg or DataConfig(vocab=cfg.vocab, seq_len=128,
                                      global_batch=8, seed=loop.seed)
    ok, msg = validate_batch(data_cfg.global_batch, mesh)
    if not ok:
        raise ValueError(msg)
    data = SyntheticDataset(data_cfg)
    mgr = CheckpointManager(loop.checkpoint_dir, keep_last=loop.keep_last)
    guard = PreemptionGuard()
    monitor = StragglerMonitor(StragglerPolicy())

    # the params' and state's shapes and dtypes, as the JAX loop's
    # eval_shape: under the meta device every factory call, the seeded
    # draws included, makes a tensor with no storage and computes nothing
    with torch.device("meta"):
        p_shape = api.init_params(cfg, loop.seed, device="meta")
        o_shape = adamw.init_state(p_shape)
    pspecs = SH.param_specs(p_shape, mesh)
    ospecs = SH.opt_specs(o_shape, pspecs)

    start_step = mgr.latest_step()
    if start_step is not None:
        state = mgr.restore({"params": p_shape, "opt": o_shape}, mesh=mesh,
                            specs={"params": pspecs, "opt": ospecs})
        params, opt_state = state["params"], state["opt"]
        print(f"[train] resumed from step {start_step}")
        start_step += 1
    else:
        params = api.init_params(cfg, loop.seed, device=device)
        opt_state = SH.distribute(adamw.init_state(params), ospecs, mesh)
        params = SH.distribute(params, pspecs, mesh)
        start_step = 0

    step_fn = ST.make_sharded_train_step(
        cfg, opt_cfg, mesh, num_microbatches=loop.num_microbatches)

    metrics_hist = []
    for step in range(start_step, loop.total_steps):
        t0 = time.monotonic()
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch_at(step).items()}
        if extra_batch is not None:
            batch.update(extra_batch(step))
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        # the metrics come to the host once a step (the JAX loop's
        # device_get), which also waits for the step on the card
        names = list(metrics)
        values = torch.stack([torch.as_tensor(metrics[k], device=device)
                              .float() for k in names]).cpu().tolist()
        metrics = dict(zip(names, values))
        dt = time.monotonic() - t0
        action = monitor.record_step(dt)
        if step % loop.log_every == 0:
            print(f"[train] step={step} loss={metrics['loss']:.4f} "
                  f"gnorm={metrics['grad_norm']:.3f} {dt*1e3:.0f}ms")
        metrics_hist.append(metrics)
        want_ckpt = (step + 1) % loop.checkpoint_every == 0
        save, preempted = _agree(device, action == "checkpoint_and_replace"
                                 or guard.requested or want_ckpt,
                                 guard.requested)
        if save:
            mgr.save(step, {"params": params, "opt": opt_state})
            if preempted:
                print(f"[train] preemption: checkpointed at {step}, exiting")
                break
    mgr.save(loop.total_steps - 1, {"params": params, "opt": opt_state},
             blocking=True)
    mgr.wait()
    return {"params": params, "opt": opt_state, "metrics": metrics_hist,
            "monitor_events": monitor.events}
