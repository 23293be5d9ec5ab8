"""Port vs JAX: checkpoints, the fault-tolerant train loop and its CLI.

A checkpoint written by the JAX package's CheckpointManager is restored by
the port's, and the reverse, bit for bit, bfloat16 included, with the same
keys, arrays and meta; the JAX substrate tests' atomicity, LATEST fallback,
GC and shape-mismatch cases (tests/test_substrate.py:60-99) on the port;
`save` snapshots before it returns; a failed background write is raised at
`wait`. Then the loop: JAX's `train` runs 3 steps of a 1-layer glm4 into a
checkpoint directory, JAX resumes one copy to 6 steps and the port another;
the port resumed in two legs equals the port run straight through. The
preemption flag, the straggler copy, and the CLI on the CPU.

Tolerances:
  * checkpoints, and the port against itself: bit for bit;
  * the port's resumed loop against JAX's: the losses rtol 1e-6; each
    param leaf's change over the 3 resumed steps to 1e-3 of its L2 norm
    (tests/test_torch_train.py, `make_train_step`: Adam divides each entry
    by its own gradient's scale).
"""

import dataclasses
import shutil
import signal
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.manager import CheckpointManager as JCM  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.data.synthetic import DataConfig as JDataConfig  # noqa: E402
from repro.distributed import straggler as JSTRAG  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.optim import adamw as JADAM  # noqa: E402
from repro.runtime import train_loop as JLOOP  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager as TCM  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.data.synthetic import DataConfig  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.distributed import straggler as TSTRAG  # noqa: E402
from repro_torch.launch import train as TCLI  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh as port_host_mesh  # noqa: E402
from repro_torch.models.convert import opt_from_jax, params_from_jax  # noqa: E402
from repro_torch.optim import adamw as TADAM  # noqa: E402
from repro_torch.runtime import train_loop as TLOOP  # noqa: E402

UPDATE_RTOL = 1e-3
Guard = TLOOP.PreemptionGuard


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_and_sigterm_kept():
    """torch on one thread; both packages' loops install a SIGTERM handler
    (the preemption guard), which is put back after the module."""
    n = torch.get_num_threads()
    handler = signal.getsignal(signal.SIGTERM)
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, handler)


def _jax_tree():
    """{params, opt} with FP32, bfloat16 and int32 leaves, nested dicts and
    the AdamWState NamedTuple."""
    rng = np.random.default_rng(0)
    params = {"blocks": {"attn": {"wq": rng.standard_normal((2, 4, 3))},
                         "ln1_w": rng.standard_normal((2, 4))},
              "embed": {"tok": rng.standard_normal((5, 4))}}
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    params["blocks"]["attn"]["wq"] = params["blocks"]["attn"]["wq"].astype(
        jnp.bfloat16)
    opt = JADAM.init_state(params)
    opt = opt._replace(step=jnp.asarray(7, jnp.int32),
                       m=jax.tree.map(lambda p: p.astype(jnp.float32) * 0.5,
                                      params))
    return {"params": params, "opt": opt}


def _port_tree(jtree):
    host = jax.tree.map(np.asarray, jtree)
    return {"params": params_from_jax(host["params"], device="cpu"),
            "opt": opt_from_jax(host["opt"], device="cpu")}


def _bits(x):
    """The values of a tensor or a JAX array, bfloat16 as its bits."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same_checkpoint(dir_a, dir_b, step):
    """The two step directories hold the same arrays under the same keys in
    the same order, and the same meta but its time."""
    import json
    da, db = dir_a / f"step_{step:08d}", dir_b / f"step_{step:08d}"
    ma = json.loads((da / "meta.json").read_text())
    mb = json.loads((db / "meta.json").read_text())
    ma.pop("time"), mb.pop("time")
    assert ma == mb
    na, nb = np.load(da / "arrays.npz"), np.load(db / "arrays.npz")
    assert list(na.keys()) == list(nb.keys()) == ma["keys"]
    for k in ma["keys"]:
        assert na[k].dtype == nb[k].dtype and na[k].tobytes() == nb[k].tobytes()


def test_jax_checkpoint_restored_by_the_port_bit_for_bit(tmp_path):
    jtree = _jax_tree()
    JCM(tmp_path / "jax").save(3, jtree, blocking=True)
    like = _port_tree(jtree)
    got = TCM(tmp_path / "jax").restore(like)
    assert isinstance(got["opt"], TADAM.AdamWState)
    for (_, w), g in zip(jax.tree_util.tree_flatten_with_path(jtree)[0],
                         T.leaves(got)):
        assert g.dtype == dict(bfloat16=torch.bfloat16, float32=torch.float32,
                               int32=torch.int32)[str(w.dtype)]
        np.testing.assert_array_equal(_bits(g), _bits(w))
    # the port writes the same directory
    TCM(tmp_path / "port").save(3, like, blocking=True)
    _assert_same_checkpoint(tmp_path / "jax", tmp_path / "port", 3)
    assert (tmp_path / "port" / "LATEST").read_text() == \
        (tmp_path / "jax" / "LATEST").read_text() == "step_00000003"


def test_port_checkpoint_restored_by_jax_bit_for_bit(tmp_path):
    jtree = _jax_tree()
    tree = _port_tree(jtree)
    mgr = TCM(tmp_path)
    mgr.save(5, tree)                      # in the background
    mgr.wait()
    got = JCM(tmp_path).restore(jax.eval_shape(lambda: jtree))
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            T.leaves(tree)):
        assert str(w.dtype) == str(g.dtype).replace("torch.", ""), path
        np.testing.assert_array_equal(_bits(w), _bits(g))
    # restore casts to the target's dtype and places on the asked device
    like = {"params": T.map(
        lambda t: torch.empty(t.shape, dtype=torch.float32, device="meta"),
        tree["params"]), "opt": tree["opt"]}
    back = TCM(tmp_path).restore(like, device="cpu")
    wq = back["params"]["blocks"]["attn"]["wq"]
    assert wq.dtype == torch.float32 and wq.device.type == "cpu"
    assert torch.equal(wq, tree["params"]["blocks"]["attn"]["wq"].float())


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = TCM(tmp_path, keep_last=2)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16)}}
    for step in (1, 2, 3):
        mgr.save(step, T.map(lambda t: t + step, tree), blocking=True)
    assert mgr.latest_step() == 3
    got = mgr.restore(T.map(lambda t: torch.empty_like(t, device="meta"),
                            tree), device="cpu")
    np.testing.assert_allclose(got["a"].numpy(), tree["a"].numpy() + 3)
    assert got["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(got["b"]["c"], tree["b"]["c"] + 3)
    assert len(list(tmp_path.glob("step_*"))) == 2       # GC kept only 2


def test_checkpoint_atomic_on_partial_write(tmp_path):
    """A leftover .tmp dir (simulated crash) must not break restore."""
    mgr = TCM(tmp_path, keep_last=3)
    tree = {"w": torch.ones((3,))}
    mgr.save(1, tree, blocking=True)
    (tmp_path / "step_00000002.tmp").mkdir()
    (tmp_path / "step_00000002.tmp" / "junk").write_text("partial")
    assert mgr.latest_step() == 1
    np.testing.assert_allclose(mgr.restore(tree)["w"].numpy(), 1.0)


def test_checkpoint_latest_pointer_fallback(tmp_path):
    mgr = TCM(tmp_path, keep_last=3)
    mgr.save(1, {"w": torch.ones(2)}, blocking=True)
    mgr.save(2, {"w": torch.ones(2) * 2}, blocking=True)
    (tmp_path / "LATEST").write_text("step_99999999")  # corrupt pointer
    assert mgr.latest_step() == 2
    assert TCM(tmp_path / "empty").latest_step() is None
    with pytest.raises(FileNotFoundError):
        TCM(tmp_path / "empty").restore({"w": torch.ones(2)})


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = TCM(tmp_path)
    mgr.save(1, {"w": torch.ones((2, 2))}, blocking=True)
    with pytest.raises(ValueError):
        mgr.restore({"w": torch.ones((3, 3))})
    with pytest.raises(KeyError):
        mgr.restore({"v": torch.ones((2, 2))})


def test_save_snapshots_before_an_in_place_update(tmp_path):
    """On the CPU a tensor's numpy view shares its memory: save must copy
    before it returns, so an update in place after it (while the write runs
    in the background) does not reach the checkpoint."""
    mgr = TCM(tmp_path)
    w = torch.arange(1 << 16, dtype=torch.float32)
    b = torch.ones(8, dtype=torch.bfloat16)
    mgr.save(1, {"w": w, "b": b})
    w.mul_(-1.0)
    b.add_(1.0)
    mgr.wait()
    got = mgr.restore({"w": w, "b": b})
    assert torch.equal(got["w"], torch.arange(1 << 16, dtype=torch.float32))
    assert torch.equal(got["b"], torch.ones(8, dtype=torch.bfloat16))


def test_failed_background_write_raises_at_wait(tmp_path):
    mgr = TCM(tmp_path)
    (tmp_path / "step_00000004.tmp").write_text("a file where a dir goes")
    mgr.save(4, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.wait()
    mgr.wait()                       # the error is raised once


# ----------------------------------------------------------- train loop

def port_train(cfg, loop, **kw):
    """The port's train on a one-rank host mesh of this process (gloo),
    its params and state gathered to plain tensors."""
    out = TLOOP.train(cfg, port_host_mesh(device="cpu"), loop, **kw)
    return {**out, "params": SH.gather(out["params"]),
            "opt": SH.gather(out["opt"])}


def _loop_cfgs():
    kw = dict(layers=1, d_model=32, vocab=64)
    return (jax_reduced(jax_get_config("glm4-9b"), **kw),
            reduced(get_config("glm4-9b"), **kw))


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    """JAX: 3 steps into a directory; JAX resumes one copy to 6 steps, the
    port another (straight), and the port a third in two legs (to 4, then
    to 6)."""
    root = tmp_path_factory.mktemp("loop")
    jcfg, cfg = _loop_cfgs()
    mesh = make_host_mesh()
    jdata = JDataConfig(vocab=jcfg.vocab, seq_len=16, global_batch=2)
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)

    def jloop(d, steps):
        return JLOOP.TrainLoopConfig(total_steps=steps, checkpoint_every=3,
                                     log_every=100, checkpoint_dir=str(d))

    def tloop(d, steps):
        return TLOOP.TrainLoopConfig(total_steps=steps, checkpoint_every=3,
                                     log_every=100, checkpoint_dir=str(d))

    first = JLOOP.train(jcfg, mesh, jloop(root / "j", 3), data_cfg=jdata)
    for name in ("t", "legs"):
        shutil.copytree(root / "j", root / name)
    start = jax.tree.map(np.asarray, first["params"])
    jax_out = JLOOP.train(jcfg, mesh, jloop(root / "j", 6), data_cfg=jdata)
    port_out = port_train(cfg, tloop(root / "t", 6), data_cfg=data)
    leg1 = port_train(cfg, tloop(root / "legs", 4), data_cfg=data)
    leg2 = port_train(cfg, tloop(root / "legs", 6), data_cfg=data)
    return dict(first=first, start=start, jax=jax_out, port=port_out,
                legs=(leg1, leg2), root=root)


def test_port_resumes_a_jax_checkpoint_and_matches_jax(loop_runs):
    r = loop_runs
    assert len(r["first"]["metrics"]) == 3
    jm, tm = r["jax"]["metrics"], r["port"]["metrics"]
    assert len(jm) == len(tm) == 3
    for a, b in zip(tm, jm):
        assert set(a) == set(b) == {"loss", "grad_norm"}
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)
    jp = jax.tree_util.tree_flatten_with_path(r["jax"]["params"])[0]
    for (path, w), g, p0 in zip(jp, T.leaves(r["port"]["params"]),
                                jax.tree.leaves(r["start"])):
        w, p0 = np.asarray(w, np.float64), np.asarray(p0, np.float64)
        upd = np.linalg.norm(w - p0)
        assert upd > 0, path
        assert np.linalg.norm(g.double().numpy() - w) <= UPDATE_RTOL * upd, path
    assert int(r["port"]["opt"].step) == int(r["jax"]["opt"].step) == 6
    # the port's final checkpoint is a JAX checkpoint again
    got = JCM(r["root"] / "t").restore(jax.eval_shape(
        lambda: {"params": r["jax"]["params"], "opt": r["jax"]["opt"]}))
    for w, g in zip(jax.tree.leaves(got["params"]),
                    T.leaves(r["port"]["params"])):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_port_resumed_in_two_legs_equals_straight_through(loop_runs):
    leg1, leg2 = loop_runs["legs"]
    straight = loop_runs["port"]
    assert len(leg1["metrics"]) == 1 and len(leg2["metrics"]) == 2
    assert leg1["metrics"] + leg2["metrics"] == straight["metrics"]
    for a, b in zip(T.leaves({"p": leg2["params"], "o": leg2["opt"]}),
                    T.leaves({"p": straight["params"], "o": straight["opt"]})):
        assert torch.equal(a, b)


def test_resume_builds_its_target_without_drawing(tmp_path, monkeypatch):
    """A resume's restore target holds shapes and dtypes only (the JAX
    loop's eval_shape): every seeded draw of its init makes a meta tensor,
    and the resumed params are the checkpoint's."""
    _, cfg = _loop_cfgs()
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)
    loop = TLOOP.TrainLoopConfig(total_steps=1, checkpoint_every=1,
                                 log_every=100, checkpoint_dir=str(tmp_path))
    port_train(cfg, loop, data_cfg=data)
    saved = TCM(tmp_path).restore(
        {"params": TLOOP.api.init_params(cfg, 0, device="cpu")})["params"]
    drawn = []
    randn = torch.randn

    def spy(*a, **k):
        out = randn(*a, **k)
        drawn.append(out.device.type)
        return out
    monkeypatch.setattr(torch, "randn", spy)
    out = port_train(cfg, dataclasses.replace(loop, total_steps=1),
                     data_cfg=data)
    assert drawn and set(drawn) == {"meta"}
    assert out["metrics"] == []
    for a, b in zip(T.leaves(out["params"]), T.leaves(saved)):
        assert a.device.type == "cpu" and torch.equal(a, b)


def test_preemption_flag_checkpoints_and_stops(tmp_path, monkeypatch):
    """The flag raised during step 1 (as SIGTERM raises it): the loop saves
    that step's state and stops; the guard turns the signal into the flag."""
    guards = []

    class Flagged(Guard):
        def __init__(self):
            super().__init__(install=False)
            guards.append(self)

    monkeypatch.setattr(TLOOP, "PreemptionGuard", Flagged)
    _, cfg = _loop_cfgs()

    def extra(step):
        if step == 1:
            guards[0]._handler(signal.SIGTERM, None)
        return {}

    loop = TLOOP.TrainLoopConfig(total_steps=5, checkpoint_every=100,
                                 log_every=100, checkpoint_dir=str(tmp_path))
    out = port_train(cfg, loop, data_cfg=DataConfig(
        vocab=cfg.vocab, seq_len=16, global_batch=2), extra_batch=extra)
    assert len(out["metrics"]) == 2 and guards[0].requested
    got = TCM(tmp_path).restore({"params": out["params"], "opt": out["opt"]},
                                step=1)
    for a, b in zip(T.leaves(got), T.leaves({"params": out["params"],
                                            "opt": out["opt"]})):
        assert torch.equal(a, b)
    # a real SIGTERM sets the flag where the guard can install its handler
    # (the main thread; elsewhere it installs nothing, as the JAX guard)
    if threading.current_thread() is threading.main_thread():
        old = signal.getsignal(signal.SIGTERM)
        try:
            g = Guard()
            signal.raise_signal(signal.SIGTERM)
            assert g.requested
        finally:
            signal.signal(signal.SIGTERM, old)


def test_straggler_copy_detects_and_escalates():
    for mod in (JSTRAG, TSTRAG):
        mon = mod.StragglerMonitor(mod.StragglerPolicy(
            slow_factor=2.0, window=8, max_consecutive_slow=2))
        for _ in range(8):
            assert mon.record_step(0.1) is None
        assert mon.record_step(0.5) == "warn_slow"
        assert mon.record_step(0.5) == "checkpoint_and_replace"
        assert mon.record_step(0.1) is None  # reset
    durations = np.random.default_rng(1).exponential(0.1, 200).tolist()
    runs = []
    for mod in (JSTRAG, TSTRAG):
        mon = mod.StragglerMonitor(mod.StragglerPolicy(window=16))
        runs.append(([mon.record_step(d) for d in durations], mon.events))
    assert runs[0] == runs[1] and runs[1][1]


def test_straggler_copy_heartbeat_timeout():
    t = [0.0]
    mon = TSTRAG.StragglerMonitor(TSTRAG.StragglerPolicy(heartbeat_timeout_s=10),
                                  clock=lambda: t[0])
    mon.heartbeat(0)
    mon.heartbeat(1)
    t[0] = 5.0
    mon.heartbeat(1)
    assert not mon.should_shrink()
    t[0] = 12.0
    assert mon.dead_hosts() == [0] and mon.should_shrink()


def test_train_cli_on_the_cpu_with_stub_frontend_inputs(tmp_path, capsys):
    """launch/train.py as a user runs it: a reduced whisper for 2 steps,
    then resumed to 3; its stub frames are the JAX launcher's draws."""
    argv = ["--arch", "whisper-medium", "--reduced", "--steps", "2",
            "--batch", "2", "--seq", "8", "--checkpoint-every", "1",
            "--checkpoint-dir", str(tmp_path), "--device", "cpu"]
    assert TCLI.main(argv) == 0
    assert TCM(tmp_path).latest_step() == 1
    assert TCLI.main(argv[:4] + ["3"] + argv[5:]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 1" in out and "first loss" in out
    cfg = reduced(get_config("whisper-medium"))
    got = TCLI.stub_inputs(cfg, 2, "cpu")(5)["frames"]
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(5),
                                        (2, cfg.enc_seq, cfg.d_model),
                                        jnp.float32) * 0.1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert TCLI.stub_inputs(reduced(get_config("gpt2")), 2, "cpu") is None
    llava = TCLI.stub_inputs(reduced(get_config("llava-next-mistral-7b")),
                             2, "cpu")(0)
    assert set(llava) == {"image_embeds"}
