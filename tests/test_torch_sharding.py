"""Port vs JAX: the sharding rules, DTensor placement, training on a mesh,
elastic restore and the mesh launch checks.

The rules are pure functions of the mesh's axis names and sizes, so they
are compared here, in the pytest process, against JAX's on an
``AbstractMesh``: param / cache / batch / opt specs for every assigned
family plus gpt2-small at full size (the port's params and caches on the
meta device, JAX's from eval_shape), at the JAX production shapes (16, 16)
and (2, 16, 16), the port's H100 shapes (32, 8) and (2, 32, 8), and
(3, 5, 7), where most dimensions do not divide. Spec for spec: entries are
compared as tuples of axis names, padded to the leaf's rank.

Training runs outside the pytest process, at the same time on both sides:
JAX's `train` on a (2, 2) mesh of 4 host-platform devices, under
jax.set_mesh (JAX's loop enters its mesh with `with mesh:`, which in this
JAX sets no abstract mesh, so without it the MoE would not dispatch
expert-parallel); the port's on a (2, 2) gloo mesh of 4 spawned ranks (a
FileStore under tmp_path, one thread a rank). Both resume the same step-2
checkpoint (the port's seeded init, written here) and run steps 3-5 of a
1-layer glm4 (d 32, vocab 64) and of a 1-layer qwen3-moe (d 32, vocab 64,
8 experts: 4 a model rank), batch 8 x 16. The port's 4 ranks then save;
2 of them restore that checkpoint with `elastic_restore` on a (2, 1)
mesh, and rank 0 alone runs the same steps on a one-rank mesh.

Tolerances: losses rtol 1e-6 and grad norms rtol 1e-5 against JAX and
against the one-rank run (data-parallel gradient means and JAX's
whole-batch reductions sum in other orders); checkpoints and placements
bit for bit.
"""

import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
WORLD = 4
ARCHS = {"dense": "glm4-9b", "moe": "qwen3-moe-30b-a3b"}
SHAPES = {"jax_pod": {"data": 16, "model": 16},
          "jax_multipod": {"pod": 2, "data": 16, "model": 16},
          "h100_pod": {"data": 32, "model": 8},
          "h100_multipod": {"pod": 2, "data": 32, "model": 8},
          "indivisible": {"pod": 3, "data": 5, "model": 7}}
RESUME_STEP, TOTAL = 2, 6
BATCH, SEQ = 8, 16


def train_cfg(pkg, kind):
    return pkg.reduced(pkg.get_config(ARCHS[kind]), layers=1, d_model=32,
                       vocab=64)


# ------------------------------------------------------------------ specs

def _norm(spec, rank):
    """Spec entries as tuples of axis names, padded to the leaf's rank."""
    out = []
    for e in tuple(spec):
        out.append(() if e is None else (e,) if isinstance(e, str) else tuple(e))
    return tuple(out) + ((),) * (rank - len(out))


@pytest.fixture(scope="module")
def shape_trees():
    """{arch: (jax params, port params, jax cache, port cache)} at full
    size: JAX's from eval_shape, the port's on the meta device."""
    import jax
    import jax.numpy as jnp
    from repro import configs as JC
    from repro.models import api as JAPI
    from repro_torch import configs as TC
    from repro_torch.models import api as TAPI
    out = {}
    for arch in TC.ASSIGNED_ARCHS + ["gpt2-small"]:
        jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
        jp = jax.eval_shape(lambda: JAPI.init_params(jcfg, jax.random.PRNGKey(0)))
        jc = jax.eval_shape(lambda: JAPI.init_cache(jcfg, 64, 2048, jnp.bfloat16))
        with torch.device("meta"):
            tp = TAPI.init_params(tcfg, 0, device="meta")
            tcache = TAPI.init_cache(tcfg, 64, 2048, torch.bfloat16,
                                     device="meta")
        out[arch] = (jp, tp, jc, tcache)
    return out


def _flat_jax(tree):
    import jax
    return [("/".join(str(getattr(k, "key", getattr(k, "name", k)))
                      for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_specs_equal_jax_for_every_family(shape_trees, shape):
    from jax.sharding import AbstractMesh
    from repro.distributed import sharding as JSH
    from repro.optim import adamw as JADAM
    from repro_torch.core import tree as T
    from repro_torch.distributed import sharding as SH
    from repro_torch.optim import adamw as TADAM
    sizes = SHAPES[shape]
    am = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    n_sharded = 0
    for arch, (jp, tp, jc, tc) in shape_trees.items():
        import jax
        jps = JSH.param_specs(jp, am)
        tps = SH.param_specs(tp, sizes)
        jos = JSH.opt_specs(jax.eval_shape(JADAM.init_state, jp), jps)
        tos = SH.opt_specs(TADAM.init_state(tp), tps)
        batch_j = {"tokens": jax.ShapeDtypeStruct((64, 128), np.int32),
                   "odd": jax.ShapeDtypeStruct((6, 128, 8), np.float32)}
        batch_t = {"tokens": torch.empty(64, 128, device="meta"),
                   "odd": torch.empty(6, 128, 8, device="meta")}
        pairs = [
            (jp, jps, tp, tps),
            (jc, JSH.cache_specs(jc, am), tc, SH.cache_specs(tc, sizes)),
            ({"params": jp}, {"params": jos.m}, {"params": tp},
             {"params": tos.m}),
            (batch_j, JSH.batch_specs(batch_j, am), batch_t,
             SH.batch_specs(batch_t, sizes)),
        ]
        assert _norm(jos.step.spec, 0) == _norm(tos.step, 0) == ()
        for jtree, jspecs, ttree, tspecs in pairs:
            jl, tl = _flat_jax(jtree), T.flatten_with_path(ttree)
            assert [k for k, _ in jl] == ["/".join(p) for p, _ in tl], arch
            for (k, jleaf), (_, tleaf), jsp, tsp in zip(
                    jl, tl, [s for _, s in _flat_jax(jspecs)],
                    T.leaves(tspecs)):
                assert tuple(jleaf.shape) == tuple(tleaf.shape), (arch, k)
                rank = len(jleaf.shape)
                assert _norm(jsp.spec, rank) == _norm(tsp, rank), (arch, k)
                n_sharded += any(_norm(tsp, rank))
    assert n_sharded > 0


def test_moe_groups_reach_the_dispatch():
    """loss_fn's moe_groups (JAX's, back with the expert-parallel path)
    splits the MoE dispatch as JAX's does: the same loss at 1 and 2
    groups, and 2 groups' capacity binds differently from 1's."""
    import jax
    import jax.numpy as jnp
    from repro import configs as JC
    from repro.models import api as JAPI
    from repro_torch import configs as TC
    from repro_torch.core import tree as T
    from repro_torch.models import api as TAPI
    cfg, jcfg = (c.reduced(c.get_config(ARCHS["moe"]), layers=1)
                 for c in (TC, JC))
    params = TAPI.init_params(cfg, 1, device="cpu")
    jparams = jax.tree.map(jnp.asarray, T.map(lambda t: t.numpy(), params))
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (4, 32))
    losses = []
    for groups in (1, 2):
        got, _ = TAPI.loss_fn(cfg, params, {"tokens": torch.from_numpy(tokens)},
                              moe_groups=groups)
        want, _ = JAPI.loss_fn(jcfg, jparams, {"tokens": jnp.asarray(tokens)},
                               moe_groups=groups)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        losses.append(float(got))
    assert losses[0] != losses[1]


# ------------------------------------------------------- multi-rank runs

def _phase_a(rank, d, out):
    """4 ranks: placements, train on (2, 2), the production mesh refused."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch import configs as TC
    from repro_torch.core import tree as T
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.runtime import train_loop as TLOOP
    m22 = make_host_mesh(2, device="cpu")
    g = torch.Generator().manual_seed(7)
    x = torch.randn(4, 6, 2, generator=g)
    ok = []
    for dt in (torch.float32, torch.bfloat16):
        xt = x.to(dt)
        for spec in [("data", "model"), ("model", "data"), (None, "model"),
                     (("data", "model"),), ()]:
            d_t = SH.distribute({"x": xt}, {"x": spec}, m22)["x"]
            ok.append(isinstance(d_t, DTensor) and
                      torch.equal(d_t.full_tensor().view(torch.int16)
                                  if dt == torch.bfloat16 else
                                  d_t.full_tensor(),
                                  xt.view(torch.int16)
                                  if dt == torch.bfloat16 else xt))
    # one dimension over (pod, data), major to minor: the rank's rows are
    # its batch_rows
    m3 = init_device_mesh("cpu", (2, 2, 1),
                          mesh_dim_names=("pod", "data", "model"))
    d_t = SH.distribute({"x": x}, {"x": (("pod", "data"),)}, m3)["x"]
    ok.append(torch.equal(d_t.to_local(), x[SH.batch_rows(m3, 4)]))
    out["placements_ok"] = np.array(ok)

    for kind in ARCHS:
        cfg = train_cfg(TC, kind)
        loop = TLOOP.TrainLoopConfig(total_steps=TOTAL, checkpoint_every=100,
                                     log_every=100,
                                     checkpoint_dir=str(d / f"port4_{kind}"))
        res = TLOOP.train(cfg, m22, loop, data_cfg=DataConfig(
            vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH))
        out[f"train4/{kind}/loss"] = np.array([m["loss"] for m in res["metrics"]])
        out[f"train4/{kind}/gnorm"] = np.array(
            [m["grad_norm"] for m in res["metrics"]])
        out[f"train4/{kind}/placed"] = np.array(
            [isinstance(v, DTensor) for v in T.leaves(res["params"])])
    for multi in (False, True):
        try:
            make_production_mesh(multi_pod=multi, device="cpu")
            out[f"prod_error/{multi}"] = np.array("")
        except ValueError as e:
            out[f"prod_error/{multi}"] = np.array(str(e))
    dist.barrier()


def _phase_b(rank, d, out):
    """2 ranks: the 4-rank dense checkpoint restored on a (2, 1) mesh."""
    from repro_torch import configs as TC
    from repro_torch.checkpoint.elastic import elastic_restore, make_shrunk_mesh
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import tree as T
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import api
    from repro_torch.optim import adamw
    cfg = train_cfg(TC, "dense")
    mesh = make_shrunk_mesh(2, model_axis=1, device="cpu")
    with torch.device("meta"):
        p_like = api.init_params(cfg, 0, device="meta")
        o_like = adamw.init_state(p_like)
    params, opt, pspecs, ospecs = elastic_restore(
        CheckpointManager(str(d / "port4_dense")), p_like, o_like, mesh,
        step=TOTAL - 1)
    placed = all(tuple(t.placements) == tuple(SH.placements(s, mesh))
                 for t, s in zip(T.leaves(params), T.leaves(pspecs)))
    full = SH.gather({"params": params, "opt": opt})
    if rank == 0:
        for path, t in T.flatten_with_path(full):
            out["elastic/" + "/".join(path)] = t.numpy()
        out["elastic_placed"] = np.array(placed)


def _phase_c(d, out):
    """Rank 0 alone: the same steps on a one-rank mesh."""
    from repro_torch import configs as TC
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import train_loop as TLOOP
    mesh = make_host_mesh(device="cpu")
    for kind in ARCHS:
        cfg = train_cfg(TC, kind)
        loop = TLOOP.TrainLoopConfig(total_steps=TOTAL, checkpoint_every=100,
                                     log_every=100,
                                     checkpoint_dir=str(d / f"port1_{kind}"))
        res = TLOOP.train(cfg, mesh, loop, data_cfg=DataConfig(
            vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH))
        out[f"train1/{kind}/loss"] = np.array([m["loss"] for m in res["metrics"]])
        out[f"train1/{kind}/gnorm"] = np.array(
            [m["grad_norm"] for m in res["metrics"]])


def _rank_main(rank, d):
    import pathlib
    import torch.distributed as dist
    d = pathlib.Path(d)
    torch.set_num_threads(1)
    out = {}
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store4"),
                                                         WORLD),
                            rank=rank, world_size=WORLD)
    _phase_a(rank, d, out)
    dist.destroy_process_group()
    if rank < 2:
        dist.init_process_group("gloo", store=dist.FileStore(
            str(d / "store2"), 2), rank=rank, world_size=2)
        _phase_b(rank, d, out)
        dist.barrier()
        dist.destroy_process_group()
    if rank == 0:
        _phase_c(d, out)
        np.savez(d / "port.npz", **out)


def run_port(d):
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(d,), nprocs=WORLD)


def run_jax(d):
    import pathlib
    import jax
    from repro import configs as JC
    from repro.data.synthetic import DataConfig
    from repro.runtime import train_loop as JLOOP
    d = pathlib.Path(d)
    mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for kind in ARCHS:
        cfg = train_cfg(JC, kind)
        loop = JLOOP.TrainLoopConfig(total_steps=TOTAL, checkpoint_every=100,
                                     log_every=100,
                                     checkpoint_dir=str(d / f"jax_{kind}"))
        with jax.set_mesh(mesh):
            res = JLOOP.train(cfg, mesh, loop, data_cfg=DataConfig(
                vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH))
        out[f"train/{kind}/loss"] = np.array([m["loss"] for m in res["metrics"]])
        out[f"train/{kind}/gnorm"] = np.array(
            [m["grad_norm"] for m in res["metrics"]])
    np.savez(d / "jax.npz", **out)


def _spawn(args, log):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    if args[0] == "--jax":
        env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                            "--xla_cpu_multi_thread_eigen=false")
        env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen([sys.executable, os.path.abspath(__file__)] + args,
                            env=env, stdout=log, stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The step-2 checkpoints (the port's seeded init, AdamW at step 0),
    copied for every run; then both sides at once."""
    from repro_torch import configs as TC
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models import api
    from repro_torch.optim import adamw
    d = tmp_path_factory.mktemp("shard")
    for kind in ARCHS:
        params = api.init_params(train_cfg(TC, kind), 0, device="cpu")
        CheckpointManager(str(d / f"init_{kind}")).save(
            RESUME_STEP, {"params": params, "opt": adamw.init_state(params)},
            blocking=True)
        for run in ("jax", "port4", "port1"):
            shutil.copytree(d / f"init_{kind}", d / f"{run}_{kind}")
    t0 = time.monotonic()
    procs = {}
    for side in ("jax", "torch"):
        log = open(d / f"{side}.log", "w")
        procs[side] = (_spawn([f"--{side}", str(d)], log), log)
    for side, (proc, log) in procs.items():
        rc = proc.wait(timeout=600)
        log.close()
        assert rc == 0, (d / f"{side}.log").read_text()[-4000:]
    print(f"both sides in {time.monotonic() - t0:.1f} s")
    return {"dir": d, "jax": np.load(d / "jax.npz"),
            "port": np.load(d / "port.npz")}


def test_placements_round_trip_bit_for_bit(runs):
    ok = runs["port"]["placements_ok"]
    assert ok.shape == (11,) and ok.all(), ok


@pytest.mark.parametrize("kind", list(ARCHS))
def test_train_on_a_2x2_mesh_matches_jax(runs, kind):
    p, j = runs["port"], runs["jax"]
    loss, gnorm = p[f"train4/{kind}/loss"], p[f"train4/{kind}/gnorm"]
    assert loss.shape == (TOTAL - RESUME_STEP - 1,)
    np.testing.assert_allclose(loss, j[f"train/{kind}/loss"], rtol=1e-6)
    np.testing.assert_allclose(gnorm, j[f"train/{kind}/gnorm"], rtol=1e-5)
    assert p[f"train4/{kind}/placed"].all()


@pytest.mark.parametrize("kind", list(ARCHS))
def test_train_on_a_2x2_mesh_matches_one_rank(runs, kind):
    """The dense model's steps are the one-rank run's; the MoE's are not
    (expert parallelism gives each data shard its own capacity and no
    load-balancing loss), so its one-rank losses must differ."""
    p = runs["port"]
    four, one = p[f"train4/{kind}/loss"], p[f"train1/{kind}/loss"]
    if kind == "dense":
        np.testing.assert_allclose(four, one, rtol=1e-6)
        np.testing.assert_allclose(p[f"train4/{kind}/gnorm"],
                                   p[f"train1/{kind}/gnorm"], rtol=1e-5)
    else:
        assert np.all(np.abs(four - one) > 1e-4), (four, one)


def test_checkpoint_from_4_ranks_restores_on_2_and_in_jax(runs):
    """The 4-rank run's last checkpoint (written by rank 0, gathered):
    elastic_restore on a (2, 1) mesh places every leaf by the new mesh's
    specs and holds its bits; JAX's CheckpointManager reads the same
    arrays."""
    from repro.checkpoint.manager import CheckpointManager as JCM
    p = runs["port"]
    assert bool(p["elastic_placed"])
    ck = runs["dir"] / "port4_dense"
    data = np.load(ck / f"step_{TOTAL - 1:08d}" / "arrays.npz")
    keys = [k for k in p.files if k.startswith("elastic/")]
    assert len(keys) == len(data.files) > 0
    for k in keys:
        np.testing.assert_array_equal(p[k], data[k[len("elastic/"):]])
    restored = JCM(str(ck)).restore(_jax_like(data), TOTAL - 1)
    for path, leaf in _flat_jax(restored):
        np.testing.assert_array_equal(np.asarray(leaf), data[path])


def _jax_like(data):
    """A nested {params, opt} tree of ShapeDtypeStructs for the arrays'
    keys (opt as JAX's AdamWState)."""
    import jax
    from repro.optim.adamw import AdamWState
    tree = {}
    for k in data.files:
        node = tree
        parts = k.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jax.ShapeDtypeStruct(data[k].shape, data[k].dtype)
    o = tree["opt"]
    tree["opt"] = AdamWState(step=o["step"], m=o["m"], v=o["v"])
    return tree


def test_shrunk_mesh_and_batch_validation_match_jax():
    from jax.sharding import AbstractMesh
    from repro.checkpoint import elastic as JE
    from repro_torch.checkpoint import elastic as TE
    for n, tp in ((6, 4), (10, 3)):
        with pytest.raises(ValueError) as je:
            JE.make_shrunk_mesh(n, model_axis=tp)
        with pytest.raises(ValueError) as te:
            TE.make_shrunk_mesh(n, model_axis=tp, device="cpu")
        assert str(je.value) == str(te.value)
    for sizes in ({"data": 4, "model": 2}, {"pod": 2, "data": 3, "model": 8},
                  {"model": 4}):
        am = AbstractMesh(tuple(sizes.values()), tuple(sizes))
        for b in (1, 6, 12, 24, 25):
            assert TE.validate_batch(b, sizes) == JE.validate_batch(b, am)


def test_production_mesh_needs_a_world_of_its_size(runs, monkeypatch):
    """In a 4-rank world each production mesh names the ranks it needs;
    the CLI's mesh flags in this process raise too (no torchrun world, or
    a one-rank one)."""
    import torch.distributed as dist
    from repro_torch.launch import train as TCLI
    p = runs["port"]
    assert str(p["prod_error/False"]) == ("a (32, 8) mesh over ('data', "
                                          "'model') needs 256 ranks; this "
                                          "world has 4")
    assert "needs 512 ranks; this world has 4" in str(p["prod_error/True"])
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    argv = ["--arch", "gpt2", "--reduced", "--steps", "1", "--device", "cpu",
            "--checkpoint-dir", str(runs["dir"] / "cli"), "--production-mesh"]
    for extra, n in (([], 256), (["--multi-pod"], 512)):
        if dist.is_initialized():
            with pytest.raises(ValueError, match=f"needs {n} ranks"):
                TCLI.main(argv + extra)
        else:
            with pytest.raises(RuntimeError, match="torchrun"):
                TCLI.main(argv + extra)
    assert not (runs["dir"] / "cli").exists()


if __name__ == "__main__":
    if sys.argv[1] == "--jax":
        run_jax(sys.argv[2])
    elif sys.argv[1] == "--torch":
        run_port(sys.argv[2])
