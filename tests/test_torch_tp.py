"""Port vs JAX: the tensor-parallel train, prefill and serve steps of the
transformer families (`launch/steps.py` `make_sharded_*_step` on gpt2,
dense, moe and llava: FSDP over `data` x tensor parallelism over `model`,
the batch over (`pod`, `data`)).

Both sides run outside the pytest process, at the same time, on the same
weights (the port's seeded init as FP32 numpy, written here and read by
both; the port's side takes it through ``models.convert``) and the same
batches:
  * JAX in one subprocess with 8 host-platform devices: each case's
    ``launch.steps`` train, prefill and serve steps jitted with in / out
    shardings from ``param_specs`` / ``opt_specs`` / ``cache_specs`` /
    ``batch_specs`` under ``jax.set_mesh`` on 4 of them;
  * the port in one spawn of 4 ranks over gloo (a FileStore under
    tmp_path, one thread a rank): the same steps on DTensors placed by the
    port's rules. Then rank 0 alone: each family's steps on a one-rank
    mesh against the plain steps bit for bit, and each family's steps
    counted by ``launch.op_cost`` on a fake (2, 4) group.

Cases (`CASES`): the four families on (data 1, model 4), (2, 2) and (pod
2, data 1, model 2), at 2 layers of width 64 (`reduced`). Where the
contiguous shards cut a unit, the rank gathers that layer's leaf over
`model` and takes what its heads or hidden units need: glm4 (dense) has 2
KV heads, so `model` 4 cuts them (Hkv % model != 0) and `model` 2 does
not; `heads6` (glm4 with 6 heads on 3 KV heads) has H·hd % 4 = 0 with H %
4 != 0; the gated MLPs (glm4 swiglu, `geglu` = gemma-7b, tied and scaled
embeddings) at `model` 2 and 4 put gate and up in different ranks'
shards. gpt2's vocabulary (512 in `reduced`) divides `model`, so its
tables split by vocabulary too.

Tolerances: loss and grad norm rtol 1e-5 (the row-parallel sums and the
vocabulary-parallel cross entropy add in another order than XLA's); the
params after 2 AdamW steps within PARAM_ATOL (2e-5 absolute, lr / 15: a
gradient element near zero whose sign the summation order flips would move
its first Adam step by 2 lr = 6e-4, and none does); prefill and decode
logits rtol 2e-5 / atol 2e-6 of the largest logit, caches rtol 2e-5 / atol
2e-6 (tests/test_torch_dryrun.py's); greedy tokens over 4 decode steps
equal. LAMP runs at each config's deployment site in prefill and decode,
and a y_low that the two summation orders put on either side of a PS(mu)
rounding edge flips a selection: that query's attention output moves by
far more than roundoff, and with it its row's logits and the next layers'
K/V at its position (tests/test_torch_static_serve.py). The slack named
for it (APART_ATOL): at most one row of a step's logits outside the
tolerance, within 1e-3 of the largest logit (these inputs have four: glm4
decode step 3 at 1.6e-4, gpt2 decode step 0 at 4.6e-6, heads6 decode
step 1 at 1.7e-5 and its prefill at 9.5e-6), and at most one (row,
position) a layer past layer 0 of a cache, within 1e-3.
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
WORLD = 4
MESHES = {"m14": ((1, 4), ("data", "model")),
          "m22": ((2, 2), ("data", "model")),
          "m212": ((2, 1, 2), ("pod", "data", "model"))}
FAMILIES = {"gpt2": ("gpt2", {}), "dense": ("glm4-9b", {}),
            "moe": ("qwen3-moe-30b-a3b", {}),
            "llava": ("llava-next-mistral-7b", {}),
            "geglu": ("gemma-7b", {}),
            "heads6": ("glm4-9b", {"n_heads": 6, "n_kv_heads": 3})}
CASES = [(m, f) for m in MESHES for f in ("gpt2", "dense", "moe", "llava")]
CASES += [("m14", "geglu"), ("m22", "geglu"), ("m14", "heads6")]
B, S, PROMPT, NEW = 4, 16, 8, 4
REPLICATED = [("m22", "moe"), ("m212", "dense")]     # batch 1 on 2 shards
PARAM_ATOL = 2e-5
TOL = dict(rtol=2e-5, atol=2e-6)
APART_ATOL = 1e-3


def cfg_of(pkg, fam):
    arch, extra = FAMILIES[fam]
    return pkg.reduced(pkg.get_config(arch)).replace(**extra)


def cache_len(cfg):
    return PROMPT + cfg.n_patches + 8


# ------------------------------------------------------------------ inputs

def make_inputs(path):
    """Every family's weights (the port's seeded init, FP32 numpy) and
    batches, drawn with numpy from fixed seeds."""
    from repro_torch import configs as TC
    from repro_torch.core import tree as T
    from repro_torch.models import api
    out = {}
    for i, fam in enumerate(FAMILIES):
        cfg = cfg_of(TC, fam)
        params = api.init_params(cfg, 7 + i, device="cpu")
        for path_, t in T.flatten_with_path(params):
            out[f"{fam}/p/" + "/".join(path_)] = t.numpy()
        rng = np.random.default_rng(100 + i)
        out[f"{fam}/train"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        out[f"{fam}/prompt"] = rng.integers(0, cfg.vocab,
                                            (B, PROMPT)).astype(np.int32)
        if cfg.family == "llava":
            out[f"{fam}/img"] = rng.standard_normal(
                (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    np.savez(path, **out)


def _tree(data, prefix):
    tree = {}
    for key in data.files:
        if key.startswith(prefix):
            node = tree
            parts = key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree


def _batch(inp, fam, key, rows=slice(None)):
    b = {"tokens": inp[f"{fam}/{key}"][rows]}
    if f"{fam}/img" in inp.files:
        b["image_embeds"] = inp[f"{fam}/img"][rows]
    return b


def _put(out, prefix, tree):
    from repro_torch.core import tree as T
    for path_, t in T.flatten_with_path(tree):
        out[prefix + "/".join(path_)] = t


# ---------------------------------------------------------------- JAX side

def run_jax(d):
    import pathlib
    import jax
    import jax.numpy as jnp
    from repro import configs as JC
    from repro.distributed import sharding as JSH
    from repro.launch import steps as JST
    from repro.models import api as JAPI
    from repro.optim import adamw as JAD
    d = pathlib.Path(d)
    inp = np.load(d / "inputs.npz")
    out = {}
    auto = jax.sharding.AxisType.Auto

    def run_case(tag, mname, fam, rows, train):
        shape, names = MESHES[mname]
        mesh = jax.make_mesh(shape, names, devices=jax.devices()[:WORLD],
                             axis_types=(auto,) * len(names))
        cfg = cfg_of(JC, fam)
        params = jax.tree.map(jnp.asarray, _tree(inp, f"{fam}/p/"))
        with jax.set_mesh(mesh):
            ps = JSH.param_specs(params, mesh)
            params = jax.device_put(params, ps)
            if train:
                opt = JAD.init_state(params)
                os_ = JSH.opt_specs(opt, ps)
                batch = jax.tree.map(jnp.asarray, _batch(inp, fam, "train"))
                bs = JSH.batch_specs(batch, mesh)
                step = jax.jit(JST.make_train_step(cfg, JAD.AdamWConfig()),
                               in_shardings=(ps, os_, bs),
                               out_shardings=(ps, os_, None))
                p, o = params, jax.device_put(opt, os_)
                batch = jax.device_put(batch, bs)
                for i in range(2):
                    p, o, m = step(p, o, batch)
                    out[f"{tag}/train/loss{i}"] = np.asarray(m["loss"])
                    out[f"{tag}/train/gnorm{i}"] = np.asarray(m["grad_norm"])
                _put(out, f"{tag}/train/p/", jax.tree.map(np.asarray, p))
            batch = jax.tree.map(jnp.asarray, _batch(inp, fam, "prompt", rows))
            n = batch["tokens"].shape[0]
            cache = JAPI.init_cache(cfg, n, cache_len(cfg), jnp.float32)
            cs = JSH.cache_specs(cache, mesh)
            bs = JSH.batch_specs(batch, mesh)
            pre = jax.jit(JST.make_prefill_step(cfg), in_shardings=(ps, cs, bs),
                          out_shardings=(None, cs))
            logits, cache = pre(params, jax.device_put(cache, cs),
                                jax.device_put(batch, bs))
            out[f"{tag}/prefill/logits"] = np.asarray(logits)
            _put(out, f"{tag}/prefill/cache/", jax.tree.map(np.asarray, cache))
            if not train:
                return
            tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
            ts = JSH.batch_specs(tok, mesh)
            serve = jax.jit(JST.make_serve_step(cfg),
                            in_shardings=(ps, cs, ts), out_shardings=(None, cs))
            toks = []
            for i in range(NEW):
                toks.append(np.asarray(tok))
                logits, cache = serve(params, cache, jax.device_put(tok, ts))
                out[f"{tag}/decode/logits{i}"] = np.asarray(logits)
                tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
            out[f"{tag}/decode/tokens"] = np.concatenate(toks, 1)
            _put(out, f"{tag}/decode/cache/", jax.tree.map(np.asarray, cache))

    for mname, fam in CASES:
        run_case(f"{mname}/{fam}", mname, fam, slice(None), True)
    for mname, fam in REPLICATED:
        run_case(f"rep/{mname}/{fam}", mname, fam, slice(0, 1), False)
    np.savez(d / "jax.npz", **out)


# --------------------------------------------------------------- port side

def _full(t):
    from repro_torch.distributed import sharding as SH
    return SH.gather(t).float().numpy() if hasattr(t, "full_tensor") \
        else t.float().numpy()


def _port_case(out, tag, mesh, fam, inp, rows, train):
    """One case's steps on `mesh`: every rank calls, rank 0's gathers are
    kept (every rank must gather: a collective)."""
    from repro_torch import configs as TC
    from repro_torch.core import tree as T
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import api, convert
    from repro_torch.optim import adamw
    cfg = cfg_of(TC, fam)
    whole = convert.params_from_jax(_tree(inp, f"{fam}/p/"), device="cpu")
    pspecs = SH.param_specs(whole, mesh)
    params = SH.distribute(whole, pspecs, mesh)

    def tensors(b):
        return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    if train:
        opt = SH.distribute(adamw.init_state(whole),
                            SH.opt_specs(adamw.init_state(whole), pspecs),
                            mesh)
        step = ST.make_sharded_train_step(cfg, adamw.AdamWConfig(), mesh)
        batch = tensors(_batch(inp, fam, "train"))
        p, o = params, opt
        for i in range(2):
            p, o, m = step(p, o, batch)
            out[f"{tag}/train/loss{i}"] = m["loss"].numpy()
            out[f"{tag}/train/gnorm{i}"] = m["grad_norm"].numpy()
        _put(out, f"{tag}/train/p/", T.map(_full, p))
        out[f"{tag}/train/placed"] = np.array(all(
            tuple(t.placements) == tuple(SH.placements(s, mesh))
            for t, s in zip(T.leaves(p), T.leaves(pspecs))))
    batch = tensors(_batch(inp, fam, "prompt", rows))
    n = batch["tokens"].shape[0]
    cache = api.init_cache(cfg, n, cache_len(cfg), torch.float32, device="cpu")
    cache = SH.distribute(cache, SH.cache_specs(cache, mesh), mesh)
    logits, cache = ST.make_sharded_prefill_step(cfg, mesh)(params, cache,
                                                            batch)
    out[f"{tag}/prefill/logits"] = _full(logits)
    _put(out, f"{tag}/prefill/cache/", T.map(_full, cache))
    serve = ST.make_sharded_serve_step(cfg, mesh)
    if not train:
        try:
            serve(params, cache, batch["tokens"][:, :1])
            out[f"{tag}/refusal"] = np.array("")
        except ValueError as e:
            out[f"{tag}/refusal"] = np.array(str(e))
        return
    tok = torch.from_numpy(_full(logits)[:, -1].argmax(-1)).to(
        torch.int32)[:, None]
    toks = []
    for i in range(NEW):
        toks.append(tok.numpy())
        logits, cache = serve(params, cache, tok)
        full = _full(logits)
        out[f"{tag}/decode/logits{i}"] = full
        tok = torch.from_numpy(full[:, -1].argmax(-1)).to(torch.int32)[:, None]
    out[f"{tag}/decode/tokens"] = np.concatenate(toks, 1)
    _put(out, f"{tag}/decode/cache/", T.map(_full, cache))


def _norm_trap(out, mesh):
    """`adamw.global_norm` of a rank's shards on (2, 2): a leaf split over
    (data, model), one split over data and replicated over model, one
    replicated; against the whole tree's norm, and the control that sums
    every rank's squares (counting the replicated leaves once a rank)."""
    import torch.distributed as dist
    from repro_torch.core import tree as T
    from repro_torch.distributed import sharding as SH
    from repro_torch.optim import adamw
    g = torch.Generator().manual_seed(5)
    whole = {"a": torch.randn(8, 6, generator=g),
             "b": torch.randn(4, 3, generator=g),
             "c": torch.randn(5, generator=g)}
    specs = {"a": ("data", "model"), "b": ("data", None), "c": (None,)}
    placed = SH.distribute(whole, specs, mesh)
    local = T.map(SH.to_local, placed)
    axes = [tuple(a for a in sp if a) for sp in T.leaves(specs)]
    out["norm/sharded"] = adamw.global_norm(local, axes, mesh).numpy()
    out["norm/whole"] = adamw.global_norm(whole).numpy()
    sq = torch.stack([torch.sum(t * t) for t in T.leaves(local)]).sum()
    dist.all_reduce(sq)
    out["norm/control"] = torch.sqrt(sq).numpy()


def _one_rank(out, inp):
    """Rank 0 alone: each family's sharded steps on a one-rank mesh
    against the plain steps, bit for bit."""
    from repro_torch import configs as TC
    from repro_torch.core import tree as T
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api, convert
    from repro_torch.optim import adamw
    mesh = make_host_mesh(device="cpu")
    for fam in ("gpt2", "dense", "moe", "llava"):
        cfg = cfg_of(TC, fam)
        params = convert.params_from_jax(_tree(inp, f"{fam}/p/"), device="cpu")
        pspecs = SH.param_specs(params, mesh)
        opt = adamw.init_state(params)
        batch = {k: torch.from_numpy(np.array(v))
                 for k, v in _batch(inp, fam, "train").items()}
        plain = ST.make_train_step(cfg, adamw.AdamWConfig())
        sharded = ST.make_sharded_train_step(cfg, adamw.AdamWConfig(), mesh)
        sp = SH.distribute(params, pspecs, mesh)
        so = SH.distribute(opt, SH.opt_specs(opt, pspecs), mesh)
        p, o = params, opt
        same = True
        for _ in range(2):
            p, o, m = plain(p, o, batch)
            sp, so, sm = sharded(sp, so, batch)
            same = same and all(torch.equal(m[k], sm[k]) for k in m)
        same = same and all(torch.equal(a, b) for a, b in zip(
            T.leaves({"p": p, "o": o}),
            T.leaves(SH.gather({"p": sp, "o": so}))))
        prompt = {k: torch.from_numpy(np.array(v))
                  for k, v in _batch(inp, fam, "prompt").items()}
        cache = api.init_cache(cfg, B, cache_len(cfg), torch.float32,
                               device="cpu")
        cd = SH.distribute(cache, SH.cache_specs(cache, mesh), mesh)
        l1, c1 = ST.make_prefill_step(cfg)(params, cache, prompt)
        sl1, sc1 = ST.make_sharded_prefill_step(cfg, mesh)(
            SH.distribute(params, pspecs, mesh), cd, prompt)
        tok = l1[:, -1].argmax(-1).to(torch.int32)[:, None]
        l2, c2 = ST.make_serve_step(cfg)(params, c1, tok)
        sl2, sc2 = ST.make_sharded_serve_step(cfg, mesh)(
            SH.distribute(params, pspecs, mesh), sc1, tok)
        same = same and all(torch.equal(a, b) for a, b in zip(
            T.leaves({"l1": l1, "l2": l2, "c": c2}),
            T.leaves(SH.gather({"l1": sl1, "l2": sl2, "c": sc2}))))
        out[f"one/{fam}"] = np.array(same)
    import torch.distributed as dist
    dist.destroy_process_group()


def _fake_counts(out):
    """Each family's steps counted by op_cost on a fake (2, 4) group of 8
    ranks (``launch.dryrun.count_step``): the largest all-gather and all
    all-gathers' bytes; then the dry run's glm4-9b decode_32k cell on the
    fake (32, 8) production mesh (``launch.dryrun.run_cell``)."""
    from repro_torch import configs as TC
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_mesh
    DR.start_fake_group(8)
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    for fam in ("gpt2", "dense", "moe", "llava", "heads6"):
        cfg = cfg_of(TC, fam)
        for kind in ("train", "prefill", "decode"):
            rec = DR.count_step(cfg, InputShape(kind, kind, S, 8), mesh)
            tag = f"fake/{fam}/{kind}"
            out[tag + "/gather_max"] = np.array(
                rec["collective_max"]["all-gather"])
            out[tag + "/gather"] = np.array(rec["collectives"]["all-gather"])
    rec = DR.run_cell("glm4-9b", "decode_32k", False)
    out["cell/status"] = np.array(rec["status"])
    out["cell/gather_max"] = np.array(rec["collective_max"]["all-gather"])
    out["cell/peak"] = np.array(rec["memory"]["peak_bytes_est"])
    out["cell/ratio"] = np.array(rec["useful_flops_ratio"])


def _rank_main(rank, d):
    import pathlib
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    d = pathlib.Path(d)
    torch.set_num_threads(1)
    inp = np.load(d / "inputs.npz")
    out = {}
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"),
                                                         WORLD),
                            rank=rank, world_size=WORLD)
    meshes = {m: init_device_mesh("cpu", shape, mesh_dim_names=names)
              for m, (shape, names) in MESHES.items()}
    for mname, fam in CASES:
        _port_case(out, f"{mname}/{fam}", meshes[mname], fam, inp,
                   slice(None), True)
    for mname, fam in REPLICATED:
        _port_case(out, f"rep/{mname}/{fam}", meshes[mname], fam, inp,
                   slice(0, 1), False)
    _norm_trap(out, meshes["m22"])
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        _one_rank(out, inp)
        _fake_counts(out)
        np.savez(d / "port.npz", **out)


def run_port(d):
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(d,), nprocs=WORLD)


# ------------------------------------------------------------------- tests

def _spawn(args, log):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
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
    """Both sides at once; a failing side's log tail in the assertion."""
    d = tmp_path_factory.mktemp("tp")
    make_inputs(d / "inputs.npz")
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
    return np.load(d / "port.npz"), np.load(d / "jax.npz")


def _apart(got, want, scale):
    """Where got is outside TOL of want (atol of `scale`)."""
    return ~np.isclose(got, want, rtol=TOL["rtol"], atol=TOL["atol"] * scale)


def _close_logits(got, want, what):
    """(B, T, V) logits at TOL of the largest; at most one row apart
    (a flipped selection), within APART_ATOL."""
    scale = max(np.abs(want).max(), 1.0)
    bad = _apart(got, want, scale).any(axis=(1, 2))
    assert bad.sum() <= 1, (what, np.flatnonzero(bad))
    np.testing.assert_allclose(got, want, rtol=0, atol=APART_ATOL * scale,
                               err_msg=what)


def _caches(port, jax_, prefix):
    """Each (L, B, S, Hkv, hd) cache at TOL, but at most one (row,
    position) a layer past layer 0 within APART_ATOL; `length` equal."""
    keys = [k for k in jax_.files if k.startswith(prefix)]
    assert keys and sorted(keys) == sorted(k for k in port.files
                                           if k.startswith(prefix))
    for k in keys:
        got, want = port[k], jax_[k]
        if got.ndim < 5:
            np.testing.assert_array_equal(got, want, err_msg=k)
            continue
        bad = _apart(got, want, 1.0).any(axis=(3, 4))
        assert not bad[0].any() and all(b.sum() <= 1 for b in bad), k
        np.testing.assert_allclose(got, want, rtol=0, atol=APART_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("mesh,fam", CASES)
def test_steps_match_jax(runs, mesh, fam):
    """Train (2 AdamW steps), prefill and 4 greedy decode steps against
    JAX's jitted, sharded steps on the same mesh."""
    port, jax_ = runs
    tag = f"{mesh}/{fam}"
    for i in range(2):
        np.testing.assert_allclose(port[f"{tag}/train/loss{i}"],
                                   jax_[f"{tag}/train/loss{i}"], rtol=1e-5)
        np.testing.assert_allclose(port[f"{tag}/train/gnorm{i}"],
                                   jax_[f"{tag}/train/gnorm{i}"], rtol=1e-5)
    keys = [k for k in jax_.files if k.startswith(f"{tag}/train/p/")]
    assert len(keys) > 0
    for k in keys:
        np.testing.assert_allclose(port[k], jax_[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
    assert bool(port[f"{tag}/train/placed"])
    _close_logits(port[f"{tag}/prefill/logits"],
                  jax_[f"{tag}/prefill/logits"], tag + " prefill")
    _caches(port, jax_, f"{tag}/prefill/cache/")
    np.testing.assert_array_equal(port[f"{tag}/decode/tokens"],
                                  jax_[f"{tag}/decode/tokens"])
    for i in range(NEW):
        _close_logits(port[f"{tag}/decode/logits{i}"],
                      jax_[f"{tag}/decode/logits{i}"], f"{tag} decode {i}")
    _caches(port, jax_, f"{tag}/decode/cache/")


@pytest.mark.parametrize("mesh,fam", REPLICATED)
def test_replicated_batch_prefill_matches_jax_and_decode_refuses(runs, mesh,
                                                                 fam):
    """Batch 1 on 2 batch shards: the prefill runs every row on every rank
    (JAX's batch_specs replicates it; the MoE then dispatches whole, not
    expert-parallel, as JAX's `moe_dispatch` does); the serve step keeps
    its refusal."""
    port, jax_ = runs
    tag = f"rep/{mesh}/{fam}"
    _close_logits(port[f"{tag}/prefill/logits"],
                  jax_[f"{tag}/prefill/logits"], tag)
    _caches(port, jax_, f"{tag}/prefill/cache/")
    assert "not divisible" in str(port[f"{tag}/refusal"])


def test_one_rank_mesh_steps_equal_plain_bit_for_bit(runs):
    port, _ = runs
    for fam in ("gpt2", "dense", "moe", "llava"):
        assert bool(port[f"one/{fam}"]), fam


def test_global_norm_counts_each_shard_once(runs):
    """The trap: a leaf replicated over `model` (and one replicated over
    both axes) is counted once, not once a rank; the control, every rank's
    squares summed, overcounts."""
    port, _ = runs
    np.testing.assert_allclose(port["norm/sharded"], port["norm/whole"],
                               rtol=1e-6)
    assert port["norm/control"] > port["norm/whole"] * 1.05


def _layer_leaf_bound(cfg, model: int):
    """The largest all-gather a step may make: one layer's leaf whole over
    `data` and `model` (the leaves a shard cuts are gathered over both),
    or a vocabulary table whole over `data` (its rank's rows); and the
    whole model's bytes, which the data-parallel step gathered a step."""
    from repro_torch.core import tree as T
    from repro_torch.models import api
    with torch.device("meta"):
        params = api.init_params(cfg, 0, device="meta")
    bound, whole = 0, 0
    for path, t in T.flatten_with_path(params):
        n = t.numel() * t.element_size()
        whole += n
        if path[0] == "blocks":
            n //= cfg.n_layers
        elif path[-1] in ("tok", "unembed") and cfg.vocab % model == 0:
            n //= model
        bound = max(bound, n)
    return bound, whole


def test_no_step_gathers_a_whole_leaf_on_a_fake_mesh(runs):
    """Counted by op_cost on a fake (data 2, model 4) group, for each of
    gpt2, dense, moe, llava and heads6: no all-gather of any step is
    larger than one layer's leaf (`_layer_leaf_bound`), and a step's
    all-gathers together stay below the whole model's bytes (the
    data-parallel step's one gather) a pass over the layers (the train
    step makes two: the forward and the checkpointed layers' recompute;
    heads6 at `model` 4 gathers nearly every layer leaf whole, as every
    one is cut). On the fake (32, 8) production mesh,
    glm4-9b's decode_32k cell: its largest all-gather within the bound at
    published widths (mlp/wi, gathered over `model` because its gate and
    up columns lie in different ranks' shards), its peak memory a rank
    below 2 GiB (1.13 GiB; the data-parallel step: 22.6 GiB) and
    useful_flops_ratio <= 1. (At width 64 the ratio means nothing: the
    embeddings, lookups without a matmul, are half the params.)"""
    from repro_torch import configs as TC
    port, _ = runs
    for fam in ("gpt2", "dense", "moe", "llava", "heads6"):
        bound, whole = _layer_leaf_bound(cfg_of(TC, fam), 4)
        for kind in ("train", "prefill", "decode"):
            tag = f"fake/{fam}/{kind}"
            assert 0 < port[tag + "/gather_max"] <= bound, (tag, bound)
            passes = 2 if kind == "train" else 1
            assert port[tag + "/gather"] < passes * whole, (tag, whole)
    assert str(port["cell/status"]) == "ok"
    bound, _ = _layer_leaf_bound(TC.get_config("glm4-9b"), 8)
    assert 0 < port["cell/gather_max"] <= bound
    assert port["cell/peak"] < 2 * 2 ** 30
    assert 0 < port["cell/ratio"] <= 1


if __name__ == "__main__":
    if sys.argv[1] == "--jax":
        run_jax(sys.argv[2])
    elif sys.argv[1] == "--torch":
        run_port(sys.argv[2])
