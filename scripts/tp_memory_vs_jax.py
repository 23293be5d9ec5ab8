"""The per-rank memory of one cut train cell, as JAX's compiler plans it
and as the port's dry run counts it.

    PYTHONPATH=src python scripts/tp_memory_vs_jax.py [--arch glm4-9b]
        [--layers 2] [--batch 8] [--seq 512]

JAX: the JAX package's train step jitted with in / out shardings from its
`param_specs` / `opt_specs` / `batch_specs` on a (data 2, model 4) mesh of
8 host-platform CPU devices, lowered on shapes only and compiled;
`compiled.memory_analysis()` per device. The port: `launch.dryrun.
count_step` of its tensor-parallel train step on a fake (2, 4) process
group (op_cost's live-storage peak). The arch at its published widths cut
to `--layers` layers, in its config's dtype. Nothing is run and nothing
is allocated at the cell's size; prints one JSON line.
"""

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

MESH = (2, 4)


def jax_memory(arch, layers, batch, seq):
    import jax
    from repro import configs as JC
    from repro.distributed import sharding as JSH
    from repro.launch import specs as JSP
    from repro.launch import steps as JST
    from repro.optim import adamw as JAD
    cfg = JC.get_config(arch).replace(n_layers=layers)
    mesh = jax.make_mesh(MESH, ("data", "model"), devices=jax.devices()[:8],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    params = JSP.params_shape(cfg)
    opt = jax.eval_shape(JAD.init_state, params)
    batch_ = JSP.batch_specs_for(cfg, batch, seq)
    with jax.set_mesh(mesh):
        ps = JSH.param_specs(params, mesh)
        os_ = JSH.opt_specs(opt, ps)
        bs = JSH.batch_specs(batch_, mesh)
        step = jax.jit(JST.make_train_step(cfg, JAD.AdamWConfig()),
                       in_shardings=(ps, os_, bs),
                       out_shardings=(ps, os_, None), donate_argnums=(0, 1))
        ma = step.lower(params, opt, batch_).compile().memory_analysis()
    rec = {"argument_bytes": int(ma.argument_size_in_bytes),
           "output_bytes": int(ma.output_size_in_bytes),
           "temp_bytes": int(ma.temp_size_in_bytes),
           "alias_bytes": int(ma.alias_size_in_bytes)}
    rec["peak_bytes_est"] = (rec["argument_bytes"] + rec["output_bytes"]
                             + rec["temp_bytes"] - rec["alias_bytes"])
    return rec


def port_memory(arch, layers, batch, seq):
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_mesh
    DR.start_fake_group(MESH[0] * MESH[1])
    rec = DR.count_step(get_config(arch).replace(n_layers=layers),
                        InputShape("cut_train", "train", seq, batch),
                        make_mesh(MESH, ("data", "model"), device="cpu"))
    return rec["memory"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    a = ap.parse_args(argv)
    cell = dict(arch=a.arch, layers=a.layers, batch=a.batch, seq=a.seq,
                mesh=MESH)
    print(json.dumps({**cell,
                      "jax": jax_memory(a.arch, a.layers, a.batch, a.seq),
                      "port": port_memory(a.arch, a.layers, a.batch, a.seq)}),
          flush=True)


if __name__ == "__main__":
    main()
