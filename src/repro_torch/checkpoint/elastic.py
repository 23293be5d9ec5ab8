"""Elastic rescaling: resume a checkpoint on a mesh of another size (port
of ``repro/checkpoint/elastic.py``).

The checkpoint stores full (unsharded) arrays; rescaling is therefore a
re-placement problem, not a data-transformation problem:

  1. build the new mesh from the surviving ranks,
  2. recompute the specs against the new mesh (axes that no longer divide
     fall back to replication: ``distributed.sharding._fit_spec``),
  3. restore() with the new placements.

The only state that is not mesh-independent is the data-pipeline cursor;
the synthetic pipeline is stateless in (seed, step), so resume is exact.
Batch divisibility is re-validated here.
"""

from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed import sharding as SH


def make_shrunk_mesh(n_devices: int, *, model_axis: int, device="cuda"):
    """The (data, model) mesh of n_devices ranks with the given TP: the
    default process group must hold exactly n_devices ranks."""
    from repro_torch.launch.mesh import make_mesh
    if n_devices % model_axis:
        raise ValueError(f"{n_devices} devices not divisible by TP={model_axis}")
    return make_mesh((n_devices // model_axis, model_axis), ("data", "model"),
                     device=device)


def elastic_restore(mgr: CheckpointManager, params_like, opt_like, mesh, *,
                    step: Optional[int] = None):
    """Restore the {params, opt} checkpoint tree onto `mesh` (any size):
    (params, opt, param specs, opt specs), the leaves DTensors."""
    pspecs = SH.param_specs(params_like, mesh)
    ospecs = SH.opt_specs(opt_like, pspecs)
    restored = mgr.restore({"params": params_like, "opt": opt_like}, step,
                           mesh=mesh, specs={"params": pspecs, "opt": ospecs})
    return restored["params"], restored["opt"], pspecs, ospecs


def validate_batch(global_batch: int, mesh) -> Tuple[bool, str]:
    shards = SH.axis_size(mesh, "data") * SH.axis_size(mesh, "pod")
    if global_batch % shards:
        return False, (f"global_batch={global_batch} not divisible by "
                       f"{shards} data shards; nearest valid: "
                       f"{global_batch - global_batch % shards}")
    return True, ""
