"""The dry run: every (arch x shape x mesh) cell's per-rank cost on the
production mesh, without a GPU (port of ``repro/launch/dryrun.py``).

This is a host tool, not a path that computes. It is the counterpart of
XLA's host-side compile: one process plays rank 0 of a fake process group
of 256 or 512 ranks (``torch.distributed``'s "fake" backend, whose
collectives do nothing), builds the production mesh over it
(``launch.mesh.make_production_mesh``), places the cell's params, optimizer
state and cache as DTensors by the sharding rules, and runs the port's own
train / prefill / serve step (``launch.steps``) once on fake tensors
(``launch.specs``) under ``launch.op_cost``, which counts the rank's flops,
bytes, collective bytes and live memory op by op. Nothing is allocated on
any device and no kernel is launched.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]

Each cell writes results/dryrun_torch/<arch>__<shape>__<mesh>.json with the
JAX record's keys where a counterpart exists: memory (argument, output,
temp, alias bytes, peak), cost (flops and bytes per rank, the flops split
into bf16/fp16 and FP32), collectives, roofline terms
(``launch.roofline``: H100 data-sheet constants), model flops and
`useful_flops_ratio`. JAX's `lower_s` / `compile_s` become one `trace_s`
(the cell's wall time: specs, placement and the counted step), and its
`xla_*_raw_loopbody_once` keys have no counterpart (a Python loop counts
every pass), and `collective_max` adds each category's largest single
result. The steps are the port's: tensor-parallel over `model` with FSDP
over `data` for the transformer families, data-parallel (the whole model
gathered a rank) for rwkv6, hymba and whisper.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
import traceback
from pathlib import Path

import torch.distributed as dist

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.distributed import sharding as SH
from repro_torch.launch import op_cost as OC
from repro_torch.launch import roofline as RL
from repro_torch.launch import specs as SP
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_production_mesh, production_shape
from repro_torch.optim import adamw

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def _mesh_name(multi_pod: bool) -> str:
    return "multi" if multi_pod else "single"


def start_fake_group(world: int) -> None:
    """A fake process group of `world` ranks, this process rank 0, unless a
    group of that size is running; a fake group of another size is
    replaced (any other group is left for the mesh to refuse)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world or dist.get_backend() != "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def model_defaults(cfg, shp, data_shards: int, overrides: dict) -> dict:
    """JAX's optimized-system defaults for the cell's `model_kwargs`;
    explicit overrides win."""
    mk = dict(overrides.get("model_kwargs") or {})
    if cfg.family == "rwkv6" and shp.kind in ("train", "prefill"):
        mk.setdefault("wkv_chunk", 64)
    if cfg.family == "moe" and shp.kind == "decode":
        mk.setdefault("moe_dropless", False)
        mk.setdefault("moe_groups",
                      data_shards if shp.global_batch % data_shards == 0 else 1)
    return mk


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: dict | None = None) -> dict:
    """Count one cell's step on the fake production mesh; return the
    record."""
    t0 = time.time()
    cfg = get_config(arch)
    shp = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shp)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
                "status": "skipped", "reason": reason}

    n_dev = math.prod(production_shape(multi_pod=multi_pod).values())
    start_fake_group(n_dev)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    rec = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
           **count_step(cfg, shp, mesh, overrides)}
    rec["trace_s"] = round(time.time() - t0, 2)
    return rec


def count_step(cfg, shp, mesh, overrides: dict | None = None) -> dict:
    """The counted record of cfg's step at shape shp on `mesh` (a mesh
    over a fake group): status, devices, cost, memory, collectives,
    roofline terms and model flops."""
    overrides = overrides or {}
    n_dev = mesh.size()
    cell = SP.cell_specs(cfg, shp)
    mode = cell["mode"]
    p_shape = cell["params"]
    pspecs = SH.param_specs(p_shape, mesh)
    data_shards = SH.batch_size(mesh)
    overrides = {**overrides,
                 "model_kwargs": model_defaults(cfg, shp, data_shards,
                                                overrides)}
    moe_groups = overrides.get("moe_groups",
                               data_shards if cfg.family == "moe" else 1)

    with mode:
        params = SH.distribute(p_shape, pspecs, mesh)
        if shp.kind == "train":
            mk = dict(overrides["model_kwargs"])
            if "attn_impl" in overrides:
                mk["attn_impl"] = overrides["attn_impl"]
            step = ST.make_sharded_train_step(
                cfg, adamw.AdamWConfig(), mesh,
                num_microbatches=overrides.get("num_microbatches", 1),
                moe_groups=moe_groups, model_kwargs=mk)
            opt = SH.distribute(cell["opt"],
                                SH.opt_specs(cell["opt"], pspecs), mesh)
            args = (params, opt, cell["batch"])
        else:
            cache = SH.distribute(cell["cache"],
                                  SH.cache_specs(cell["cache"], mesh), mesh)
            if shp.kind == "prefill":
                step = ST.make_sharded_prefill_step(
                    cfg, mesh, use_lamp=overrides.get("use_lamp", True),
                    attn_impl=overrides.get("attn_impl", "auto"),
                    moe_groups=moe_groups,
                    model_kwargs=overrides["model_kwargs"])
                args = (params, cache, cell["batch"])
            else:
                step = ST.make_sharded_serve_step(
                    cfg, mesh, use_lamp=overrides.get("use_lamp", True),
                    model_kwargs=overrides["model_kwargs"])
                args = (params, cache, cell["tokens"])
    del cell, params
    _, cost = OC.analyze(step, args, mode)
    del args
    gc.collect()

    flops = cost["flops"]
    rec = {"status": "ok", "n_devices": int(n_dev), "overrides": overrides,
           "memory": cost["memory"],
           "cost": {"flops_per_device": flops,
                    "bytes_per_device": cost["bytes"],
                    "flops_bf16_per_device": cost["flops_bf16"],
                    "flops_fp32_per_device": cost["flops_fp32"],
                    "matmul_argument_bytes_per_device":
                        cost["matmul_argument_bytes"]},
           "collectives": cost["collectives"],
           "collective_max": cost["collective_max"],
           "roofline": RL.roofline_terms(flops, cost["bytes"],
                                         cost["collective_bytes"],
                                         cost["flops_fp32"])}
    mf = RL.model_flops(cfg, p_shape, shp.kind, shp.global_batch, shp.seq_len)
    rec["model_flops_total"] = mf
    rec["model_flops_per_device"] = mf / n_dev
    rec["useful_flops_ratio"] = (mf / n_dev) / flops if flops else 0.0
    rec.update(RL.active_params(p_shape, cfg))
    return rec


def roofline_line(rec: dict) -> str:
    r = rec["roofline"]
    return (f"dominant={r['dominant']} c={r['compute_s']:.3g}s "
            f"m={r['memory_s']:.3g}s x={r['collective_s']:.3g}s "
            f"trace={rec['trace_s']}s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--overrides", default=None,
                    help="JSON dict, e.g. '{\"num_microbatches\": 4}'")
    ap.add_argument("--tag", default="", help="suffix for override experiments")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    overrides = json.loads(args.overrides) if args.overrides else None

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"__{args.tag}" if args.tag else ""
                fname = outdir / f"{arch}__{shape}__{_mesh_name(mp)}{tag}.json"
                if fname.exists() and not args.force:
                    print(f"[cached] {fname.name}")
                    continue
                print(f"[run] {arch} x {shape} x {_mesh_name(mp)} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, mp, overrides)
                except Exception as e:   # recorded, and the exit code says so
                    rec = {"arch": arch, "shape": shape,
                           "mesh": _mesh_name(mp), "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                rec["overrides_tag"] = args.tag
                fname.write_text(json.dumps(rec, indent=1))
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skipped"
                n_fail += st == "error"
                extra = ""
                if st == "ok":
                    extra = " " + roofline_line(rec)
                elif st == "error":
                    extra = " " + rec["error"][:160]
                print(f"[{st}] {fname.name}{extra}", flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} failed={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
