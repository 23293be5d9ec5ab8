"""Port vs JAX: the dry run (`launch/specs.py`, `op_cost.py`, `roofline.py`,
`dryrun.py`) and the prefill / serve steps on a mesh (`launch/steps.py`).

In the pytest process:
  * `ASSIGNED_ARCHS` equals JAX's;
  * `specs`: every arch's params, and each shape kind's cache, batch,
    tokens and AdamW state on four archs, leaf by leaf (path, shape,
    dtype) against JAX's ``jax.eval_shape`` trees;
  * `roofline`: `active_params` and `model_flops` on those trees equal
    JAX's; `roofline_terms` equals JAX's with JAX's constants set to the
    H100's, and splits the FP32 flops off to their own peak;
  * `op_cost`: the flops of a reduced glm4's prefill and decode step (one
    device, LAMP off, fake tensors) equal JAX's ``hlo_cost.analyze`` of the
    same step compiled without a mesh, exactly; the memory record, bytes
    and flop split of a small step worked out by hand;
  * the MoE decode at capacity (`moe_dropless=False`, `moe_groups`) and
    the MoE prefill in dispatch groups against JAX's on the same weights;
    rwkv6's loss on the chunked
    recurrence (`wkv_chunk`) against JAX's and the step scan's.

Outside it, at the same time:
  * 2 spawned ranks over gloo (a FileStore under tmp_path): the sharded
    prefill and serve steps of a reduced glm4 (dense: the serve step's
    SPMD body) and rwkv6 (data-parallel) on (1, 2) and (2, 1) meshes, at
    batch 2 and at batch 1 (replicated: the batch axes do not divide it;
    the dense serve step refuses it), LAMP off; then rank 0 alone on a
    one-rank mesh with LAMP on, against the plain steps bit for bit;
  * one process: `run_cell` of olmoe-1b-7b decode_32k on the fake
    256-rank mesh and of rwkv6-7b long_500k (batch 1, replicated) on the
    512-rank one.

Tolerances (tests/test_torch_static_serve.py): logits rtol 2e-5 / atol
2e-6 of the largest logit, caches rtol 2e-5 / atol 2e-6, against the plain
steps on the CPU and against JAX's steps (each backend, and each mesh,
sums its FP32 products in its own order); rwkv6's logits and state
against JAX at atol 4e-6 of the largest (tests/test_torch_families.py:
its roundoff grows through the layers).
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as JC  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.launch import roofline as JRL  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import api as JAPI  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.launch import op_cost as OC  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.launch import steps as TST  # noqa: E402
from repro_torch.models import api as TAPI  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
TOL = dict(rtol=2e-5, atol=2e-6)
RWKV_TOL = dict(rtol=2e-5, atol=4e-6)
SPEC_ARCHS = ("hymba-1.5b", "whisper-medium", "llava-next-mistral-7b",
              "rwkv6-7b")
MESH_FAMILIES = {"dense": "glm4-9b", "rwkv6": "rwkv6-7b"}
MESHES = {"m12": (1, 2), "m21": (2, 1)}
MESH_CASES = [("m12", "dense", 2), ("m12", "rwkv6", 2), ("m21", "dense", 2),
              ("m21", "rwkv6", 2), ("m21", "dense", 1), ("m21", "rwkv6", 1)]
S, CACHE_LEN, SEED = 8, 16, 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_jax(tree):
    return [("/".join(str(getattr(k, "key", getattr(k, "name", k)))
                      for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _same_leaves(jtree, ttree, where):
    jl, tl = _flat_jax(jtree), T.flatten_with_path(ttree)
    assert [k for k, _ in jl] == ["/".join(p) for p, _ in tl], where
    for (k, j), (_, t) in zip(jl, tl):
        assert tuple(j.shape) == tuple(t.shape), (where, k)
        assert np.dtype(j.dtype).name == str(t.dtype).split(".")[-1], (where, k)
    return len(jl)


@pytest.fixture(scope="module")
def param_trees():
    """{arch: (jax cfg, jax params, port cfg, port params)}, shapes only."""
    out = {}
    for arch in TC.ASSIGNED_ARCHS:
        jcfg, cfg = JC.get_config(arch), TC.get_config(arch)
        out[arch] = (jcfg, JSP.params_shape(jcfg), cfg,
                     SP.params_shape(cfg, SP.fake_mode()))
    return out


def test_assigned_archs_equal_jax():
    assert TC.ASSIGNED_ARCHS == JC.ASSIGNED_ARCHS


def test_params_shape_equals_jax_for_every_arch(param_trees):
    from torch._subclasses.fake_tensor import FakeTensor
    for arch, (_, jp, _, tp) in param_trees.items():
        assert _same_leaves(jp, tp, arch) > 0
        assert all(isinstance(t, FakeTensor) for t in T.leaves(tp)), arch


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_equal_jax(shape):
    for arch in SPEC_ARCHS:
        j, t = JSP.input_specs(arch, shape), SP.input_specs(arch, shape)
        keys = sorted(k for k in j if k not in ("cfg", "shape"))
        assert keys == sorted(k for k in t if k not in ("cfg", "shape", "mode"))
        for k in keys:
            _same_leaves(j[k], t[k], (arch, shape, k))


def test_active_params_and_model_flops_equal_jax(param_trees):
    for arch, (jcfg, jp, cfg, tp) in param_trees.items():
        assert RL.active_params(tp, cfg) == JRL.active_params(jp, jcfg), arch
        for shp in TC.SHAPES.values():
            args = (shp.kind, shp.global_batch, shp.seq_len)
            assert RL.model_flops(cfg, tp, *args) == \
                JRL.model_flops(jcfg, jp, *args), (arch, shp.name)


def test_roofline_terms_equal_jax_at_h100_constants(monkeypatch):
    monkeypatch.setattr(JRL, "PEAK_FLOPS_BF16", TMESH.PEAK_FLOPS_BF16)
    monkeypatch.setattr(JRL, "HBM_BW", TMESH.HBM_BW)
    monkeypatch.setattr(JRL, "ICI_BW_PER_LINK", TMESH.NVLINK_BW_PER_LINK)
    for f, b, c in [(1e15, 1e12, 1e9), (1e9, 1e12, 0.0), (1e9, 1e6, 1e12),
                    (0.0, 0.0, 0.0)]:
        assert RL.roofline_terms(f, b, c) == JRL.roofline_terms(f, b, c)
    r = RL.roofline_terms(3e12, 0.0, 0.0, fp32_flops_per_dev=1e12)
    assert r["compute_s"] == pytest.approx(2e12 / TMESH.PEAK_FLOPS_BF16
                                           + 1e12 / TMESH.PEAK_FLOPS_FP32,
                                           rel=1e-12)
    assert TMESH.PEAK_FLOPS_FP32 == 67e12


@functools.lru_cache(maxsize=None)
def _reduced(pkg_name, arch, **kw):
    pkg = {"jax": JC, "torch": TC}[pkg_name]
    return pkg.reduced(pkg.get_config(arch), **kw)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_op_cost_flops_equal_hlo_cost(kind):
    """The reduced glm4 (FP32) on one device with LAMP off: every dot the
    compiled HLO holds is a matmul op_cost counts, at the same size."""
    jcfg, cfg = _reduced("jax", "glm4-9b"), _reduced("torch", "glm4-9b")
    B = 2
    jp = JSP.params_shape(jcfg)
    jc = jax.eval_shape(lambda: JAPI.init_cache(jcfg, B, CACHE_LEN,
                                                jnp.float32))
    mode = SP.fake_mode()
    tp = SP.params_shape(cfg, mode)
    with mode:
        tc = TAPI.init_cache(cfg, B, CACHE_LEN, torch.float32, device="cpu")
    if kind == "prefill":
        jx = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
        jstep = JST.make_prefill_step(jcfg, use_lamp=False)
        tstep = TST.make_prefill_step(cfg, use_lamp=False)
        tx = SP.batch_specs_for(cfg, B, S, mode)
    else:
        jx = jax.ShapeDtypeStruct((B, 1), jnp.int32)
        jstep = JST.make_serve_step(jcfg, use_lamp=False)
        tstep = TST.make_serve_step(cfg, use_lamp=False)
        with mode:
            tx = torch.empty((B, 1), dtype=torch.int32)
    want = hlo_cost.analyze(jax.jit(jstep).lower(jp, jc, jx).compile()
                            .as_text())["flops"]
    _, rec = OC.analyze(tstep, (tp, tc, tx), mode)
    assert want > 0
    assert rec["flops"] == want
    assert rec["flops_fp32"] == want and rec["flops_bf16"] == 0


def test_op_cost_record_of_a_small_step():
    """Arguments x (8, 8) and cache (8, 16) float32: a temporary, a matmul
    output, a write into the cache in place (alias), and a bfloat16
    matmul counted apart."""
    mode = SP.fake_mode()
    with mode:
        x = torch.empty((8, 8))
        cache = torch.empty((8, 16))

    def step(x, cache):
        y = x * 2
        z = y @ y.T
        cache[:, :2] = z[:, :2]
        return z, cache

    _, rec = OC.analyze(step, (x, cache), mode)
    assert rec["memory"] == {"argument_bytes": 768, "output_bytes": 768,
                             "temp_bytes": 256, "alias_bytes": 512,
                             "peak_bytes_est": 1280}
    # arguments once, then 2 x (mul 256 + mm 256 + the 64 bytes written)
    assert rec["bytes"] == 768 + 2 * (256 + 256 + 64)
    assert (rec["flops_fp32"], rec["flops_bf16"]) == (2 * 8 * 8 * 8, 0)
    assert rec["collective_bytes"] == 0

    with mode:
        a = torch.empty((4, 32), dtype=torch.bfloat16)
        b = torch.empty((32, 16), dtype=torch.bfloat16)
    _, rec = OC.analyze(lambda a, b: a @ b, (a, b), mode)
    assert (rec["flops_bf16"], rec["flops_fp32"]) == (2 * 4 * 16 * 32, 0)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_moe_dispatch_options_match_jax(monkeypatch, kind):
    """The dry run's MoE options off a mesh, against JAX's on the same
    weights: `transformer.decode_step(moe_dropless=False, moe_groups=2)` on
    a random cache, and `transformer.prefill(moe_groups=2)`. The dispatch
    sizes its capacity for groups of half the tokens (decode: at width 1,
    not dropless)."""
    from repro_torch.models import moe as TMOE
    jcfg, cfg = _reduced("jax", "olmoe-1b-7b"), _reduced("torch", "olmoe-1b-7b")
    B = 8
    tp = TAPI.init_params(cfg, SEED, device="cpu")
    jp = jax.tree.map(jnp.asarray, T.map(lambda t: t.numpy(), tp))
    rng = np.random.default_rng(SEED)
    shape = (cfg.n_layers, B, CACHE_LEN, cfg.n_kv_heads, cfg.hd)
    cache = {"k": rng.standard_normal(shape).astype(np.float32),
             "v": rng.standard_normal(shape).astype(np.float32),
             "length": np.full((B,), S, np.int32)}
    seen = []
    real = TMOE.capacity
    monkeypatch.setattr(TMOE, "capacity", lambda *a: seen.append(a[1:])
                        or real(*a))
    if kind == "decode":
        x = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        kw = {"moe_dropless": False, "moe_groups": 2}
        jstep = JST.make_serve_step(jcfg, model_kwargs=kw)
        tstep = TST.make_serve_step(cfg, model_kwargs=kw)
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
        want_capacity = (B // 2, 1, False)
    else:
        x = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        jstep = JST.make_prefill_step(jcfg, moe_groups=2)
        tstep = TST.make_prefill_step(cfg, moe_groups=2)
        jx, tx = {"tokens": jnp.asarray(x)}, {"tokens": torch.from_numpy(x)}
        want_capacity = (B * S // 2, S, False)
    want, wc = jax.jit(jstep)(jp, {k: jnp.asarray(v) for k, v in cache.items()},
                              jx)
    got, gc = tstep(tp, {k: torch.from_numpy(v) for k, v in cache.items()}, tx)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL["rtol"],
                               atol=TOL["atol"] * np.abs(want).max())
    for k in ("k", "v"):
        np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]), **TOL)
    assert seen == [want_capacity] * cfg.n_layers


def test_rwkv_loss_on_the_chunked_recurrence_matches_jax():
    """`rwkv.loss_fn(wkv_chunk=...)`, the dry run's rwkv6 train default,
    against JAX's at the same chunk (the families' tolerance: rtol 2e-6)."""
    jcfg, cfg = _reduced("jax", "rwkv6-7b"), _reduced("torch", "rwkv6-7b")
    tp = TAPI.init_params(cfg, SEED, device="cpu")
    jp = jax.tree.map(jnp.asarray, T.map(lambda t: t.numpy(), tp))
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab, (2, 16))
    got, _ = TAPI.loss_fn(cfg, tp, {"tokens": torch.from_numpy(tokens)},
                          wkv_chunk=4)
    want, _ = jax.jit(lambda p, b: JAPI.loss_fn(jcfg, p, b, wkv_chunk=4))(
        jp, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(float(got), float(want), rtol=2e-6)
    step, _ = TAPI.loss_fn(cfg, tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(got), float(step), rtol=2e-6)


# ------------------------------------------------------- outside pytest

def _mesh_cfg(pkg, fam):
    return pkg.reduced(pkg.get_config(MESH_FAMILIES[fam]))


def _mesh_inputs(cfg, B):
    rng = np.random.default_rng(SEED + B)
    return (rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32))


def _plain_steps(cfg, params, B, use_lamp, steps=None):
    """(prefill logits, its cache, decode logits, its cache) of the plain
    steps, or of `steps` (a sharded pair)."""
    prompt, nxt = _mesh_inputs(cfg, B)
    cache = TAPI.init_cache(cfg, B, CACHE_LEN, torch.float32, device="cpu")
    pre, serve = (steps or (TST.make_prefill_step(cfg, use_lamp=use_lamp),
                            TST.make_serve_step(cfg, use_lamp=use_lamp)))[:2]
    if steps is not None:
        from repro_torch.distributed import sharding as SH
        mesh = steps[2]
        params = SH.distribute(params, SH.param_specs(params, mesh), mesh)
        cache = SH.distribute(cache, SH.cache_specs(cache, mesh), mesh)
    l1, c1 = pre(params, cache, {"tokens": torch.from_numpy(prompt)})
    c1_copy = T.map(lambda t: t.clone(), c1)
    l2, c2 = serve(params, c1, torch.from_numpy(nxt))
    return l1, c1_copy, l2, c2


def _np(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).float().numpy()


def _save(out, prefix, l1, c1, l2, c2):
    out[prefix + "prefill/logits"] = _np(l1)
    out[prefix + "decode/logits"] = _np(l2)
    for name, c in (("prefill", c1), ("decode", c2)):
        for path, t in T.flatten_with_path(c):
            out[prefix + f"{name}/cache/" + "/".join(path)] = _np(t)


def _rank_main(rank, d):
    import pathlib
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import sharding as SH
    d = pathlib.Path(d)
    torch.set_num_threads(1)
    out = {}
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"), 2),
                            rank=rank, world_size=2)
    for mname, shape in MESHES.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        for m, fam, B in MESH_CASES:
            if m != mname:
                continue
            cfg = _mesh_cfg(TC, fam)
            params = TAPI.init_params(cfg, SEED, device="cpu")
            pre = TST.make_sharded_prefill_step(cfg, mesh, use_lamp=False)
            serve = TST.make_sharded_serve_step(cfg, mesh, use_lamp=False)
            if fam == "dense" and B % SH.batch_size(mesh):
                prompt, nxt = _mesh_inputs(cfg, B)
                cache = TAPI.init_cache(cfg, B, CACHE_LEN, torch.float32,
                                        device="cpu")
                placed = SH.distribute(params, SH.param_specs(params, mesh),
                                       mesh)
                cd = SH.distribute(cache, SH.cache_specs(cache, mesh), mesh)
                l1, c1 = pre(placed, cd, {"tokens": torch.from_numpy(prompt)})
                _save(out, f"{m}/{fam}/{B}/", l1, c1, l1, c1)
                try:
                    serve(placed, c1, torch.from_numpy(nxt))
                    out[f"{m}/{fam}/{B}/refusal"] = np.array("")
                except ValueError as e:
                    out[f"{m}/{fam}/{B}/refusal"] = np.array(str(e))
                continue
            _save(out, f"{m}/{fam}/{B}/",
                  *_plain_steps(cfg, params, B, False, (pre, serve, mesh)))
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(device="cpu")
        for fam in MESH_FAMILIES:
            cfg = _mesh_cfg(TC, fam)
            params = TAPI.init_params(cfg, SEED, device="cpu")
            got = _plain_steps(cfg, params, 2, True, (
                TST.make_sharded_prefill_step(cfg, mesh),
                TST.make_sharded_serve_step(cfg, mesh), mesh))
            want = _plain_steps(cfg, params, 2, True)
            from torch.utils._pytree import tree_leaves
            out[f"one/{fam}"] = np.array(all(
                torch.equal(torch.from_numpy(_np(g)), torch.from_numpy(_np(w)))
                for g, w in zip(tree_leaves(got), tree_leaves(want))))
        np.savez(d / "port.npz", **out)


def run_port(d):
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(d,), nprocs=2)


def run_cells(d):
    import json
    import pathlib
    from repro_torch.launch.dryrun import run_cell
    recs = [run_cell("olmoe-1b-7b", "decode_32k", False),
            run_cell("rwkv6-7b", "long_500k", True)]
    (pathlib.Path(d) / "cells.json").write_text(json.dumps(recs))


def _start(args, log):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             *args], stdout=log, stderr=subprocess.STDOUT,
                            env=env)


@pytest.fixture(scope="module", autouse=True)
def _started(tmp_path_factory):
    """Both subprocesses, started with the module's first test so that
    they run while the tests in this process do."""
    d = tmp_path_factory.mktemp("dryrun")
    logs = {k: open(d / f"{k}.log", "w") for k in ("torch", "cells")}
    procs = {k: _start([f"--{k}", str(d)], logs[k]) for k in logs}
    yield d, logs, procs
    for k, p in procs.items():
        if p.poll() is None:
            p.kill()
        p.wait()
        logs[k].close()


@pytest.fixture(scope="module")
def runs(_started):
    """Both subprocesses' results; a failing side's log tail in the
    assertion."""
    import json
    d, logs, procs = _started
    for k, p in procs.items():
        rc = p.wait(timeout=600)
        logs[k].flush()
        assert rc == 0, (k, (d / f"{k}.log").read_text()[-3000:])
    port = dict(np.load(d / "port.npz"))
    return port, json.loads((d / "cells.json").read_text())


@functools.lru_cache(maxsize=None)
def _jax_steps(fam, B):
    jcfg, cfg = _mesh_cfg(JC, fam), _mesh_cfg(TC, fam)
    params = TAPI.init_params(cfg, SEED, device="cpu")
    jp = jax.tree.map(jnp.asarray, T.map(lambda t: t.numpy(), params))
    prompt, nxt = _mesh_inputs(cfg, B)
    jc = JAPI.init_cache(jcfg, B, CACHE_LEN, jnp.float32)
    l1, c1 = jax.jit(JST.make_prefill_step(jcfg, use_lamp=False))(
        jp, jc, {"tokens": jnp.asarray(prompt)})
    l2, c2 = jax.jit(JST.make_serve_step(jcfg, use_lamp=False))(
        jp, c1, jnp.asarray(nxt))
    return cfg, params, [np.asarray(x) for x in (l1, l2)], c1, c2


def _close(got, want, what, tol=TOL, scaled=False):
    want = np.asarray(want, dtype=np.float32)
    atol = tol["atol"] * (max(np.abs(want).max(), 1.0) if scaled else 1.0)
    np.testing.assert_allclose(got, want, rtol=tol["rtol"], atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("mesh,fam,B", MESH_CASES)
def test_sharded_steps_match_plain_and_jax(runs, mesh, fam, B):
    port, _ = runs
    pre = f"{mesh}/{fam}/{B}/"
    cfg, params, (jl1, jl2), jc1, jc2 = _jax_steps(fam, B)
    l1, c1, l2, c2 = _plain_steps(cfg, params, B, False)
    steps = [("prefill", l1, c1, jl1, jc1)]
    if fam == "dense" and B == 1:
        assert "not divisible" in str(port[pre + "refusal"])
    else:
        steps.append(("decode", l2, c2, jl2, jc2))
    # rwkv6's whole model against JAX: tests/test_torch_families.py's
    # RWKV_TOL, of the largest magnitude
    jtol, jscaled = (RWKV_TOL, True) if fam == "rwkv6" else (TOL, False)
    for name, pl, pc, jl, jc in steps:
        got = port[pre + f"{name}/logits"]
        _close(got, _np(pl), pre + name + " vs plain", scaled=True)
        _close(got, jl, pre + name + " vs jax", jtol, scaled=True)
        flat = dict(_flat_jax(jc))
        for path, t in T.flatten_with_path(pc):
            key = "/".join(path)
            g = port[pre + f"{name}/cache/{key}"]
            _close(g, _np(t), pre + name + " cache " + key)
            _close(g, np.asarray(flat[key]), pre + name + " jax cache " + key,
                   jtol, jscaled)


def test_one_rank_mesh_steps_equal_plain_bit_for_bit(runs):
    port, _ = runs
    for fam in MESH_FAMILIES:
        assert bool(port[f"one/{fam}"]), fam


def test_run_cell_on_the_fake_production_meshes(runs):
    _, (cell, long_cell) = runs
    assert cell["status"] == "ok", cell
    assert cell["n_devices"] == 256
    r = cell["roofline"]
    assert r["compute_s"] > 0 and r["memory_s"] > 0
    assert cell["collectives"]["all-gather"] > 0
    assert cell["memory"]["peak_bytes_est"] >= cell["memory"]["argument_bytes"] > 0
    assert long_cell["status"] == "ok", long_cell
    assert long_cell["n_devices"] == 512
    assert long_cell["roofline"]["compute_s"] > 0


if __name__ == "__main__":
    flag, d = sys.argv[1], sys.argv[2]
    sys.path.insert(0, SRC)
    if flag == "--torch":
        run_port(d)
    elif flag == "--cells":
        run_cells(d)
