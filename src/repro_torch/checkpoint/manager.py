"""Fault-tolerant checkpointing: atomic and asynchronous (port of
``repro/checkpoint/manager.py``), on the JAX package's on-disk layout, so
each package restores the other's checkpoints.

Layout (one directory per step):
    <dir>/step_00000100/
        meta.json            -- step, time, flat key list, shapes, dtypes
        arrays.npz           -- the flattened leaves, named by their paths
    <dir>/LATEST             -- atomic pointer file (rename-into-place)

A leaf's key is its path joined by "/" (``core.tree``: a dict key, a
NamedTuple field's name, a sequence index), as the JAX package names it
from ``tree_flatten_with_path``: "params/blocks/attn/wq", "opt/step",
"opt/m/embed/tok". numpy has no bfloat16, so a bfloat16 leaf is stored as
its uint16 bits with "bfloat16" in meta.json's dtypes.

Guarantees:
  * atomicity  -- writes go to step_xxx.tmp/, then os.replace'd; a crash
    mid-save never corrupts the previous checkpoint
  * async      -- save() copies every leaf to host memory before it returns
    and writes to disk in the background; wait() joins and raises the
    write's error, if any (the train loop waits before the next save and at
    exit). The copy matters: on the CPU ``t.numpy()`` shares memory with
    t, so a leaf updated in place after save() would otherwise be written
    with its later values
  * placement  -- restore() only needs shapes to match; it casts to the
    target's dtype and puts each leaf on `device`, or, given a mesh and a
    spec per leaf (``distributed.sharding``), places it as a DTensor there
  * sharded    -- save() gathers each DTensor leaf to the whole array (a
    collective: every rank saves), so the layout is the JAX package's
    whatever the mesh; under a process group only rank 0 writes, and
    wait() ends with a barrier, so no rank reads a checkpoint before it
    is on disk
  * GC         -- the keep_last newest checkpoints are retained
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import tree as T
from repro_torch.distributed.sharding import distribute, gather


def _flatten(tree) -> List[Tuple[str, Any]]:
    return [("/".join(path), leaf) for path, leaf in T.flatten_with_path(tree)]


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _writer() -> bool:
    """Whether this process writes: rank 0 of a process group, or a
    process with none."""
    return not _distributed() or dist.get_rank() == 0


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(a numpy copy of `t`, its true dtype's name); a bfloat16 tensor
    comes back as its uint16 bits, a DTensor whole."""
    t = gather(t).detach()
    bf16 = t.dtype == torch.bfloat16
    a = (t.view(torch.int16) if bf16 else t).cpu().numpy()
    if t.device.type == "cpu":          # .cpu() copied nothing
        a = a.copy()
    return (a.view(np.uint16), "bfloat16") if bf16 else (a, str(a.dtype))


class CheckpointManager:
    def __init__(self, directory: str, *, keep_last: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, *, blocking: bool = False) -> None:
        """Copy to host memory now; write to disk in the background."""
        self.wait()
        if not _writer():
            for _, leaf in _flatten(tree):     # the gathers are collectives
                gather(leaf)
            return
        host, true_dtypes = [], {}
        for k, leaf in _flatten(tree):
            a, dt = _to_host(leaf)
            host.append((k, a))
            true_dtypes[k] = dt

        def _write():
            try:
                tmp = self.dir / f"step_{step:08d}.tmp"
                final = self.dir / f"step_{step:08d}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                np.savez(tmp / "arrays.npz", **{k: v for k, v in host})
                meta = {
                    "step": step,
                    "time": time.time(),
                    "keys": [k for k, _ in host],
                    "shapes": {k: list(v.shape) for k, v in host},
                    "dtypes": true_dtypes,
                }
                (tmp / "meta.json").write_text(json.dumps(meta))
                if final.exists():
                    shutil.rmtree(final)
                os.replace(tmp, final)
                latest_tmp = self.dir / "LATEST.tmp"
                latest_tmp.write_text(final.name)
                os.replace(latest_tmp, self.dir / "LATEST")
                self._gc()
            except BaseException as e:  # surfaced at next wait()
                self._error = e

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if _distributed():
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint save failed: {err!r}")

    def _gc(self) -> None:
        steps = sorted(self.dir.glob("step_????????"))
        for old in steps[: -self.keep_last]:
            shutil.rmtree(old, ignore_errors=True)

    # ---------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        ptr = self.dir / "LATEST"
        if not ptr.exists():
            return None
        name = ptr.read_text().strip()
        if not (self.dir / name).exists():
            # LATEST points at a GC'd/corrupt dir: fall back to newest valid
            steps = sorted(self.dir.glob("step_????????"))
            if not steps:
                return None
            name = steps[-1].name
        return int(name.split("_")[1])

    def restore(self, tree_like, step: Optional[int] = None, *, device=None,
                mesh=None, specs=None):
        """Restore into the structure of `tree_like`, whose leaves give each
        array's shape and dtype (tensors, on any device, ``meta`` included).
        Each leaf goes to `device`, or to its like's device when `device` is
        None; with `mesh` (a DeviceMesh) and `specs` (a spec per leaf), it
        is placed there as a DTensor (every rank reads the whole array and
        keeps its shard)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        data = np.load(d / "arrays.npz")
        meta = json.loads((d / "meta.json").read_text())
        leaves = []
        for key, like in _flatten(tree_like):
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"model shape {tuple(like.shape)}")
            if meta["dtypes"].get(key) == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if mesh is not None:
                dev = torch.device(mesh.device_type)
            else:
                dev = like.device if device is None else torch.device(device)
            leaves.append(t.to(device=dev, dtype=like.dtype))
        out = T.unflatten(tree_like, leaves)
        if mesh is not None:
            out = distribute(out, specs, mesh)
        return out
