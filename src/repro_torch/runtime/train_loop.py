"""Fault-tolerant training loop (port of ``repro/runtime/train_loop.py``).

Integrates the substrates: the train step, deterministic resumable data,
async atomic checkpointing, straggler monitoring, preemption-signal
handling. One device: the JAX loop's mesh, its parameter and optimizer
PartitionSpecs and its donated buffers wait for the port's
``torch.distributed`` slice; here every tensor lives on `device`.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.synthetic import DataConfig, SyntheticDataset
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


def train(cfg, loop: TrainLoopConfig,
          opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
          data_cfg: Optional[DataConfig] = None,
          extra_batch: Optional[Callable[[int], Dict[str, Any]]] = None,
          *, device="cuda") -> Dict[str, Any]:
    """Train `cfg` on `device`. Resumes from the latest checkpoint if
    present; else starts from ``api.init_params(cfg, loop.seed)``.

    `extra_batch(step)` supplies stub modality inputs (frames /
    image_embeds) for the whisper and llava families. Returns {"params",
    "opt", "metrics" (one {"loss", "grad_norm"} of floats a step run),
    "monitor_events"}."""
    device = resolve_device(device)
    data_cfg = data_cfg or DataConfig(vocab=cfg.vocab, seq_len=128,
                                      global_batch=8, seed=loop.seed)
    data = SyntheticDataset(data_cfg)
    mgr = CheckpointManager(loop.checkpoint_dir, keep_last=loop.keep_last)
    guard = PreemptionGuard()
    monitor = StragglerMonitor(StragglerPolicy())

    start_step = mgr.latest_step()
    if start_step is not None:
        # the restore's target: the params' and state's shapes and dtypes,
        # as the JAX loop's eval_shape. Under the meta device every factory
        # call, the seeded draws included, makes a tensor with no storage
        # and computes nothing
        with torch.device("meta"):
            p_shape = api.init_params(cfg, loop.seed, device="meta")
            o_shape = adamw.init_state(p_shape)
        state = mgr.restore({"params": p_shape, "opt": o_shape},
                            device=device)
        params, opt_state = state["params"], state["opt"]
        print(f"[train] resumed from step {start_step}")
        start_step += 1
    else:
        params = api.init_params(cfg, loop.seed, device=device)
        opt_state = adamw.init_state(params)
        start_step = 0

    step_fn = ST.make_train_step(cfg, opt_cfg,
                                 num_microbatches=loop.num_microbatches)

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
        if action == "checkpoint_and_replace" or guard.requested or want_ckpt:
            mgr.save(step, {"params": params, "opt": opt_state})
            if guard.requested:
                print(f"[train] preemption: checkpointed at {step}, exiting")
                break
    mgr.save(loop.total_steps - 1, {"params": params, "opt": opt_state},
             blocking=True)
    mgr.wait()
    return {"params": params, "opt": opt_state, "metrics": metrics_hist,
            "monitor_events": monitor.events}
