"""Port vs JAX on real multi-rank meshes: sequence-parallel decode
attention, the quantized all-reduce, the GPipe pipeline, expert-parallel
MoE and the decode step under a mesh.

Both sides run outside the pytest process, at the same time: JAX in one
subprocess with 8 host-platform devices (its meshes need them before JAX
starts), the port in one subprocess that spawns 8 ranks over gloo
(``torch.multiprocessing``, a FileStore under tmp_path, one thread a rank).
The inputs are drawn here with numpy (the weights: the port's seeded init)
and written to an .npz that both read; each writes its results to one.
This file is also the script both subprocesses run (``--jax`` /
``--torch``); it imports JAX only inside the JAX side's functions.

Meshes: sp_decode_attention at (data 2, model 4); quantized_psum over 8
ranks on `data`; the pipeline at 2 and 4 stages (beside a `rep` axis on
the port's side, whose replicas compute the same); moe_apply_ep and
decode_step at (data 2, model 2).

Tolerances:
  * sp_decode_attention, FP32 and bfloat16 caches (q and p rounded to the
    cache dtype, FP32 products on both sides): rtol 1e-5, atol 1e-6, LAMP
    off and on (relaxed, mu 5 and 7). The rule compares s = y_low +
    log|y_low| of PS(mu)-rounded FP32 logits with a threshold: a logit
    that two summation orders put on either side of a PS(mu) rounding edge
    would flip a selection and move its row by far more than the
    tolerance; none of these inputs does (the test holds every row);
  * quantized_psum: bit for bit (integer payloads, exact halves round to
    even on both sides);
  * pipeline_apply: rtol 1e-5, atol 1e-6 (matmul order and tanh);
  * moe_apply_ep: outputs rtol 1e-5, atol 1e-6; kept_frac and the router
    rate of data shard 0 (JAX's replicated out_spec reads the first
    device's) equal;
  * decode_step under a mesh: logits rtol 1e-5, atol 1e-5 against JAX
    under jax.set_mesh, the caches after the step rtol 1e-5, atol 1e-6
    (a later layer's new K/V carry the earlier layers' summation order);
    the step changed exactly position length[b] of row b in every layer
    (only the rank owning that position writes it; a row at length S
    writes nothing); against the port's one-device step with LAMP off,
    the caches rtol 1e-5, atol 1e-6 and the logits rtol 1e-5, atol 1e-5
    (with LAMP on, layer 0's write: the later layers see the two paths'
    attention rules).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
WORLD = 8

SP_CASES = {                  # name: (cache dtype, lamp, mu, window)
    "f32": ("float32", False, 23, None),
    "f32_lamp5": ("float32", True, 5, None),
    "f32_lamp7_window": ("float32", True, 7, 20),
    "bf16": ("bfloat16", False, 23, None),
    "bf16_lamp7": ("bfloat16", True, 7, None),
    "bf16_lamp5_window": ("bfloat16", True, 5, 20),
}
SP_TAU = 0.05
PIPE_CASES = {"s2_m3": (2, 3), "s2_m2": (2, 2), "s4_m4": (4, 4),
              "s4_m6": (4, 6)}
MOE_CASES = {"router_off": (False, 2.0), "router_lamp": (True, 2.0),
             "capacity_binds": (True, 0.5)}
DECODE_CASES = {"f32": ("float32", False), "f32_lamp": ("float32", True),
                "bf16_lamp": ("bfloat16", True)}
DECODE_LENGTHS = [5, 31, 16, 32]      # S = 32: shard edges and a full row
DECODE_S = 32


def moe_cfg(pkg):
    return pkg.reduced(pkg.get_config("qwen3-moe-30b-a3b"))


def glm_cfg(pkg):
    return pkg.reduced(pkg.get_config("glm4-9b"))


# ------------------------------------------------------------------ inputs

def _put_tree(out, prefix, tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            _put_tree(out, f"{prefix}{k}/", v)
        else:
            out[prefix + k] = np.asarray(v)


def _get_tree(data, prefix):
    tree = {}
    for key in data.files:
        if key.startswith(prefix):
            node = tree
            parts = key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree


def make_inputs(path):
    """Every case's inputs, drawn with numpy from fixed seeds; the models'
    weights are the port's seeded init as FP32 numpy."""
    from repro_torch import configs as TC
    from repro_torch.models import api
    rng = np.random.default_rng(0)
    out = {}
    B, H, Hkv, S, D = 4, 8, 2, 64, 16
    out["sp/q"] = rng.standard_normal((B, H, 1, D)).astype(np.float32) * 2
    out["sp/k"] = rng.standard_normal((B, Hkv, S, D)).astype(np.float32) * 2
    out["sp/v"] = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    out["sp/length"] = np.array([50, 64, 10, 33], np.int32)
    # quantized_psum: per-rank trees; "halves" puts every payload on an
    # exact half (scale 1 and 0.5: the max |g| 127 and 63.5 are on rank 3)
    ka = rng.integers(-126, 126, (WORLD, 16)).astype(np.float32) + 0.5
    kb = (rng.integers(-126, 126, (WORLD, 3, 5)).astype(np.float32) + 0.5) * 0.5
    ka[3, 0], kb[3, 1, 2] = -127.0, 63.5
    out["psum/halves/a"], out["psum/halves/b/c"] = ka, kb
    out["psum/random/a"] = rng.standard_normal((WORLD, 64)).astype(np.float32)
    out["psum/random/b/c"] = (rng.standard_normal((WORLD, 4, 8)) * 3).astype(
        np.float32)
    out["pipe/w"] = (rng.standard_normal((4, 8, 8)) * 0.2).astype(np.float32)
    out["pipe/x"] = rng.standard_normal((6, 2, 8)).astype(np.float32)
    mcfg = moe_cfg(TC)
    mp = api.init_params(mcfg, 3, device="cpu")["blocks"]["moe"]
    _put_tree(out, "moe/p/", {k: v[0].numpy() for k, v in mp.items()})
    out["moe/x"] = rng.standard_normal((4, 8, mcfg.d_model)).astype(np.float32)
    gcfg = glm_cfg(TC)
    gp = api.init_params(gcfg, 5, device="cpu")
    _put_tree(out, "dec/p/", {k: v for k, v in _numpy_tree(gp).items()})
    shape = (gcfg.n_layers, 4, DECODE_S, gcfg.n_kv_heads, gcfg.hd)
    out["dec/k"] = rng.standard_normal(shape).astype(np.float32)
    out["dec/v"] = rng.standard_normal(shape).astype(np.float32)
    out["dec/tokens"] = rng.integers(0, gcfg.vocab, (4, 1)).astype(np.int32)
    np.savez(path, **out)


def _numpy_tree(tree):
    return {k: (_numpy_tree(v) if isinstance(v, dict) else v.numpy())
            for k, v in tree.items()}


# ---------------------------------------------------------------- JAX side

def run_jax(inp_path, out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import configs as JC
    from repro.distributed import sharding as JSH
    from repro.distributed.collectives import quantized_psum, sp_decode_attention
    from repro.distributed.pipeline import pipeline_apply, split_stages
    from repro.models import api
    from repro.models.moe import moe_apply_ep
    from repro.core.policy import LampSite
    inp = np.load(inp_path)
    out = {}
    auto = jax.sharding.AxisType.Auto

    def mesh(shape, names, n):
        return jax.make_mesh(shape, names, devices=jax.devices()[:n],
                             axis_types=(auto,) * len(names))

    m24 = mesh((2, 4), ("data", "model"), 8)
    for name, (dt, lamp, mu, window) in SP_CASES.items():
        kc = jnp.asarray(inp["sp/k"]).astype(dt)
        vc = jnp.asarray(inp["sp/v"]).astype(dt)
        with jax.set_mesh(m24):
            o = jax.jit(lambda q, k, v, n: sp_decode_attention(
                m24, q, k, v, n, mu=mu, tau=SP_TAU, lamp=lamp,
                window=window))(jnp.asarray(inp["sp/q"]), kc, vc,
                                jnp.asarray(inp["sp/length"]))
        out[f"sp/{name}"] = np.asarray(o)

    m8 = mesh((8,), ("data",), 8)
    for case in ("halves", "random"):
        tree = _get_tree(inp, f"psum/{case}/")

        def per_device(a):
            return jax.make_array_from_single_device_arrays(
                a.shape[1:], NamedSharding(m8, P()),
                [jax.device_put(a[i], d) for i, d in enumerate(m8.devices.flat)])
        got = quantized_psum(m8, jax.tree.map(per_device, tree))
        out[f"psum/{case}/a"] = np.asarray(got["a"])
        out[f"psum/{case}/b/c"] = np.asarray(got["b"]["c"])

    def stage_fn(p, xin):
        y, _ = jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), xin, p["w"])
        return y
    for name, (S, M) in PIPE_CASES.items():
        staged = split_stages({"w": jnp.asarray(inp["pipe/w"])}, S)
        out[f"pipe/{name}"] = np.asarray(pipeline_apply(
            mesh((S,), ("stage",), S), stage_fn, staged,
            jnp.asarray(inp["pipe/x"][:M])))

    m22 = mesh((2, 2), ("data", "model"), 4)
    mcfg = moe_cfg(JC)
    mp = jax.tree.map(jnp.asarray, _get_tree(inp, "moe/p/"))
    for name, (lamp, mult) in MOE_CASES.items():
        site = mcfg.lamp.router if lamp else LampSite(enabled=False)
        with jax.set_mesh(m22):
            y, met = jax.jit(lambda p, x: moe_apply_ep(
                mcfg, p, x, lamp_site=site, mesh=m22, capacity_mult=mult))(
                    mp, jnp.asarray(inp["moe/x"]))
        out[f"moe/{name}/y"] = np.asarray(y)
        out[f"moe/{name}/kept"] = np.asarray(met["kept_frac"])
        out[f"moe/{name}/rate"] = np.asarray(met["router_lamp_rate"])

    gcfg = glm_cfg(JC)
    gp = jax.tree.map(jnp.asarray, _get_tree(inp, "dec/p/"))
    for name, (dt, lamp) in DECODE_CASES.items():
        cache = {"k": jnp.asarray(inp["dec/k"]).astype(dt),
                 "v": jnp.asarray(inp["dec/v"]).astype(dt),
                 "length": jnp.asarray(DECODE_LENGTHS, jnp.int32)}
        specs = JSH.cache_specs(jax.eval_shape(lambda: cache), m22)
        with jax.set_mesh(m22):
            logits, nc = jax.jit(lambda p, c, t: api.decode_step(
                gcfg, p, c, t, use_lamp=lamp))(
                    gp, jax.device_put(cache, specs),
                    jnp.asarray(inp["dec/tokens"]))
        out[f"dec/{name}/logits"] = np.asarray(logits)
        for k in ("k", "v"):
            out[f"dec/{name}/{k}"] = np.asarray(nc[k].astype(jnp.float32))
        out[f"dec/{name}/length"] = np.asarray(nc["length"])
    np.savez(out_path, **out)


# --------------------------------------------------------------- port side

def _rank_main(rank, inp_path, out_path, store_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import configs as TC
    from repro_torch.core.policy import LampSite
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.collectives import (quantized_psum,
                                                     sp_decode_attention)
    from repro_torch.distributed.pipeline import pipeline_apply, split_stages
    from repro_torch.models import api
    from repro_torch.models.moe import moe_apply_ep
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    inp = np.load(inp_path)
    out = {}

    def t(a):
        return torch.from_numpy(np.array(a))

    m24 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    rows = SH.batch_rows(m24, 4)
    S_l = inp["sp/k"].shape[2] // 4
    cols = slice(SH.axis_index(m24, "model") * S_l,
                 (SH.axis_index(m24, "model") + 1) * S_l)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for name, (dt, lamp, mu, window) in SP_CASES.items():
        kc = t(inp["sp/k"]).to(dtypes[dt])[rows, :, cols]
        vc = t(inp["sp/v"]).to(dtypes[dt])[rows, :, cols]
        o = sp_decode_attention(m24, t(inp["sp/q"])[rows], kc, vc,
                                t(inp["sp/length"])[rows], mu=mu, tau=SP_TAU,
                                lamp=lamp, window=window)
        out[f"sp/{name}"] = SH.from_rows(o, m24, 4).full_tensor().numpy()

    m8 = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
    for case in ("halves", "random"):
        tree = _get_tree(inp, f"psum/{case}/")
        mine = {"a": t(tree["a"][rank]), "b": {"c": t(tree["b"]["c"][rank])}}
        got = quantized_psum(m8, mine)
        out[f"psum/{case}/a"] = got["a"].numpy()
        out[f"psum/{case}/b/c"] = got["b"]["c"].numpy()

    def stage_fn(p, x):
        for w in p["w"]:
            x = torch.tanh(x @ w)
        return x
    for name, (S, M) in PIPE_CASES.items():
        mesh = init_device_mesh("cpu", (WORLD // S, S),
                                mesh_dim_names=("rep", "stage"))
        staged = split_stages({"w": t(inp["pipe/w"])}, S)
        if S == 4:                       # at rest over the stage axis
            staged = SH.distribute(staged, {"w": ("stage",)}, mesh)
        out[f"pipe/{name}"] = pipeline_apply(
            mesh, stage_fn, staged, t(inp["pipe/x"][:M])).numpy()

    m222 = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("rep", "data", "model"))
    m22 = m222["data", "model"]
    mcfg = moe_cfg(TC)
    mp = {k: t(v) for k, v in _get_tree(inp, "moe/p/").items()}
    mp = SH.distribute(mp, SH.param_specs({"moe": mp}, m22)["moe"], m22)
    xr = t(inp["moe/x"])[SH.batch_rows(m22, 4)]
    for name, (lamp, mult) in MOE_CASES.items():
        site = mcfg.lamp.router if lamp else LampSite(enabled=False)
        y, met = moe_apply_ep(mcfg, mp, xr, lamp_site=site, mesh=m22,
                              capacity_mult=mult)
        out[f"moe/{name}/y"] = SH.from_rows(y, m22, 4).full_tensor().numpy()
        out[f"moe/{name}/kept"] = met["kept_frac"].numpy()
        out[f"moe/{name}/rate"] = met["router_lamp_rate"].numpy()

    gcfg = glm_cfg(TC)
    gp = {k: v for k, v in _get_tree(inp, "dec/p/").items()}

    def torch_tree(tree):
        return {k: (torch_tree(v) if isinstance(v, dict) else t(v))
                for k, v in tree.items()}
    gp = torch_tree(gp)
    for name, (dt, lamp) in DECODE_CASES.items():
        cache = {"k": t(inp["dec/k"]).to(dtypes[dt]),
                 "v": t(inp["dec/v"]).to(dtypes[dt]),
                 "length": torch.tensor(DECODE_LENGTHS, dtype=torch.int32)}
        placed = SH.distribute(cache, SH.cache_specs(cache, m22), m22)
        with SH.set_mesh(m22):
            logits, nc = api.decode_step(gcfg, gp, placed,
                                         t(inp["dec/tokens"]), use_lamp=lamp)
        out[f"dec/{name}/logits"] = logits.full_tensor().numpy()
        for k in ("k", "v"):
            out[f"dec/{name}/{k}"] = nc[k].full_tensor().float().numpy()
        out[f"dec/{name}/length"] = SH.to_local(nc["length"]).numpy()
    if rank == 0:
        np.savez(out_path, **out)
    dist.barrier()
    dist.destroy_process_group()


def run_port(inp_path, out_path, store_path):
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(inp_path, out_path, store_path), nprocs=WORLD)


# ------------------------------------------------------------------ tests

def _spawn(args, log):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    if args[0] == "--jax":
        env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                            "--xla_cpu_multi_thread_eigen=false")
        env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen([sys.executable, os.path.abspath(__file__)] + args,
                            env=env, stdout=log, stderr=subprocess.STDOUT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    inp = str(d / "inputs.npz")
    make_inputs(inp)
    t0 = time.monotonic()
    procs = {}
    for side, args in (("jax", ["--jax", inp, str(d / "jax.npz")]),
                       ("port", ["--torch", inp, str(d / "port.npz"),
                                 str(d / "store")])):
        log = open(d / f"{side}.log", "w")
        procs[side] = (_spawn(args, log), log)
    for side, (proc, log) in procs.items():
        rc = proc.wait(timeout=600)
        log.close()
        assert rc == 0, (d / f"{side}.log").read_text()[-4000:]
    print(f"both sides in {time.monotonic() - t0:.1f} s")
    return {"inp": np.load(inp), "jax": np.load(d / "jax.npz"),
            "port": np.load(d / "port.npz")}


@pytest.mark.parametrize("case", list(SP_CASES))
def test_sp_decode_attention_matches_jax(runs, case):
    got, want = runs["port"][f"sp/{case}"], runs["jax"][f"sp/{case}"]
    assert got.shape == want.shape == (4, 8, 1, 16)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sp_decode_lamp_moves_the_output(runs):
    """The LAMP cases select: each differs from its exact twin, and the
    exact twin from the LAMP run by less than the low-precision error."""
    r = runs["port"]
    for lamp, exact in (("f32_lamp5", "f32"), ("bf16_lamp7", "bf16")):
        diff = np.max(np.abs(r[f"sp/{lamp}"] - r[f"sp/{exact}"]))
        assert 0 < diff < 0.1, (lamp, diff)


@pytest.mark.parametrize("case", ["halves", "random"])
def test_quantized_psum_bit_for_bit(runs, case):
    for leaf in ("a", "b/c"):
        key = f"psum/{case}/{leaf}"
        got, want = runs["port"][key], runs["jax"][key]
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    if case == "halves":
        # the payloads are exact halves: the mean of round-half-even ints
        ka = runs["inp"]["psum/halves/a"]
        ints = np.round(ka)          # numpy rounds half to even too
        assert np.any(ints != np.floor(ka + 0.5))
        np.testing.assert_array_equal(runs["port"]["psum/halves/a"],
                                      (ints.sum(0) * 1.0 / WORLD)
                                      .astype(np.float32))


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_pipeline_apply_matches_jax(runs, case):
    S, M = PIPE_CASES[case]
    got, want = runs["port"][f"pipe/{case}"], runs["jax"][f"pipe/{case}"]
    assert got.shape == want.shape == (M, 2, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # and the sequential stack
    x, w = runs["inp"]["pipe/x"][:M], runs["inp"]["pipe/w"]
    for wl in w:
        x = np.tanh(x @ wl)
    np.testing.assert_allclose(got, x, rtol=1e-5, atol=1e-6)


def test_pipeline_errors_match_jax():
    """Fewer microbatches than stages, and layers the stages do not divide,
    raise in both packages before anything runs."""
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh
    from repro.distributed import pipeline as JP
    from repro_torch.distributed import pipeline as TP
    x = np.zeros((3, 2, 8), np.float32)
    with pytest.raises(ValueError, match="need microbatches >= stages"):
        JP.pipeline_apply(AbstractMesh((4,), ("stage",)), None,
                          {"w": jnp.zeros((4, 1, 8, 8))}, jnp.asarray(x))
    with pytest.raises(ValueError, match="need microbatches >= stages"):
        TP.pipeline_apply({"stage": 4}, None, {"w": torch.zeros(4, 1, 8, 8)},
                          torch.from_numpy(x))
    with pytest.raises(ValueError, match="not divisible by stages"):
        JP.split_stages({"w": jnp.zeros((6, 2))}, 4)
    with pytest.raises(ValueError, match="not divisible by stages"):
        TP.split_stages({"w": torch.zeros(6, 2)}, 4)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_ep_matches_jax(runs, case):
    p, j = runs["port"], runs["jax"]
    np.testing.assert_allclose(p[f"moe/{case}/y"], j[f"moe/{case}/y"],
                               rtol=1e-5, atol=1e-6)
    assert float(p[f"moe/{case}/kept"]) == float(j[f"moe/{case}/kept"])
    assert float(p[f"moe/{case}/rate"]) == float(j[f"moe/{case}/rate"])
    kept = float(p[f"moe/{case}/kept"])
    assert kept < 1.0 if case == "capacity_binds" else kept == 1.0
    if case == "router_lamp":
        assert float(p[f"moe/{case}/rate"]) > 0


def test_moe_apply_ep_equals_moe_apply_where_capacity_does_not_bind(runs):
    """With nothing dropped, expert parallelism only moves where each
    expert runs: the outputs of each data shard equal moe_apply's on it."""
    from repro_torch import configs as TC
    from repro_torch.core.policy import LampSite
    from repro_torch.models.moe import moe_apply
    cfg = moe_cfg(TC)
    p = {k: torch.from_numpy(v) for k, v in
         {"router": runs["inp"]["moe/p/router"],
          "we_in": runs["inp"]["moe/p/we_in"],
          "we_out": runs["inp"]["moe/p/we_out"]}.items()}
    x = torch.from_numpy(runs["inp"]["moe/x"])
    for half in (slice(0, 2), slice(2, 4)):
        y, met = moe_apply(cfg, p, x[half], lamp_site=LampSite(enabled=False),
                           dropless=True)
        assert float(met["kept_frac"]) == 1.0
        np.testing.assert_allclose(runs["port"]["moe/router_off/y"][half],
                                   y.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_step_under_a_mesh_matches_jax(runs, case):
    p, j = runs["port"], runs["jax"]
    np.testing.assert_allclose(p[f"dec/{case}/logits"], j[f"dec/{case}/logits"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(p[f"dec/{case}/length"],
                                  np.array(DECODE_LENGTHS) + 1)
    np.testing.assert_array_equal(j[f"dec/{case}/length"],
                                  np.array(DECODE_LENGTHS) + 1)
    for k in ("k", "v"):
        np.testing.assert_allclose(p[f"dec/{case}/{k}"], j[f"dec/{case}/{k}"],
                                   rtol=1e-5, atol=1e-6)
        _assert_writes(runs, case, k)


def _assert_writes(runs, case, k):
    """The step wrote row b's new K/V at position length[b] of every layer
    (the rank owning that position; none for a row at length S) and
    nothing else."""
    dt = DECODE_CASES[case][0]
    before = torch.from_numpy(runs["inp"][f"dec/{k}"]).to(
        {"float32": torch.float32, "bfloat16": torch.bfloat16}[dt]).float()
    after = runs["port"][f"dec/{case}/{k}"]
    changed = np.any(after != before.numpy(), axis=(3, 4))       # (L, B, S)
    for b, n in enumerate(DECODE_LENGTHS):
        want = np.zeros(DECODE_S, bool)
        if n < DECODE_S:
            want[n] = True
        for l in range(changed.shape[0]):
            np.testing.assert_array_equal(changed[l, b], want)


def test_decode_step_under_a_mesh_matches_one_device(runs):
    """The port's one-device decode_step on the whole cache: with LAMP off
    the same logits and caches after the step; with LAMP on the same
    layer-0 write."""
    from repro_torch import configs as TC
    from repro_torch.models import api
    cfg = glm_cfg(TC)
    inp = runs["inp"]

    def torch_tree(tree):
        return {k: (torch_tree(v) if isinstance(v, dict)
                    else torch.from_numpy(v)) for k, v in tree.items()}
    params = torch_tree(_get_tree(inp, "dec/p/"))
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for case, (dt, lamp) in DECODE_CASES.items():
        cache = {"k": torch.from_numpy(inp["dec/k"]).to(dtypes[dt]),
                 "v": torch.from_numpy(inp["dec/v"]).to(dtypes[dt]),
                 "length": torch.tensor(DECODE_LENGTHS, dtype=torch.int32)}
        logits, nc = api.decode_step(cfg, params, cache,
                                     torch.from_numpy(inp["dec/tokens"]),
                                     use_lamp=lamp)
        # layer 0's write is the same function of the tokens on both paths;
        # with LAMP on the later layers' inputs carry the two paths'
        # attention rules (sp: relaxed on cast-only PS(mu) logits)
        layers = slice(None) if not lamp else slice(0, 1)
        for k in ("k", "v"):
            np.testing.assert_allclose(runs["port"][f"dec/{case}/{k}"][layers],
                                       nc[k][layers].float().numpy(),
                                       rtol=1e-5, atol=1e-6)
        if not lamp:
            np.testing.assert_allclose(runs["port"][f"dec/{case}/logits"],
                                       logits.numpy(), rtol=1e-5, atol=1e-5)


if __name__ == "__main__":
    if sys.argv[1] == "--jax":
        run_jax(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "--torch":
        run_port(sys.argv[2], sys.argv[3], sys.argv[4])
