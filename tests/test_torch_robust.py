"""What the port's recovery half must keep loud, and its maintenance paths
(the port alone, on the CPU).

A kernel wrapper's own error propagates out of `step()`: no ladder rung and
no split fallback catches it (only the injected `StepLaunchFault` degrades
a step to the split twin, whose tokens it then gives, counted once per
fired step). A recovery through the gather rung -- the plain versions run
in place of the kernels; the CPU's ladder has it, a card's "cuda" path's
does not -- is counted in ``engine_recoveries_total`` and traced as a
``recover:gather`` instant. `defrag()` mid-run and `paranoid`
checks on a tight, preempting pool leave every token unchanged. The serve
CLI's fault flags print the faults line, a missed deadline makes it exit
1, and `serve_stream` logs and skips a request the admission bound
rejects. `launch/retry_probe.py` runs at the reduced size. Everything is
exact.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import paged_attention as PA
from repro_torch.launch import retry_probe, serve
from repro_torch.models import transformer
from repro_torch.obs import ObsConfig
from repro_torch.serving import (EngineConfig, FaultConfig, LampEngine,
                                 SamplingParams)

_BASE = dict(block_size=4, max_model_len=64, max_prefill_tokens=32,
             max_prefill_batch=4, max_decode_batch=8, device="cpu")


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("gpt2")).replace(vocab=128)
    return cfg, transformer.init_params(cfg, 0, device="cpu")


def _requests(seed=4, n=6, lo=3, hi=20):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 128, size=int(rng.integers(lo, hi))).tolist(),
             SamplingParams(max_new_tokens=int(rng.integers(2, 8)), seed=i))
            for i in range(n)]


def _engine(model, reqs, **kw):
    cfg, params = model
    eng = LampEngine(cfg, params, EngineConfig(**{**_BASE, **kw}))
    for prompt, sp in reqs:
        eng.add_request(prompt, sp)
    return eng


def _run(model, reqs, **kw):
    eng = _engine(model, reqs, **kw)
    outs = {o.req_id: o for o in eng.run_to_completion()}
    eng.pool.check_invariants(eng._seqs.values())
    return eng, outs


def _tokens(outs):
    return {r: o.tokens for r, o in outs.items()}


def _recoveries(eng):
    fam = eng.obs.registry.get("engine_recoveries_total")
    return {key[0]: c.value for key, c in fam.items() if c.value}


@pytest.mark.parametrize("mixed_exec,step_rate,speculative", [
    ("fused", 0.0, False), ("split", 0.0, True), ("fused", 1.0, True)])
def test_kernel_error_propagates_out_of_step(model, monkeypatch, mixed_exec,
                                             step_rate, speculative):
    """A RuntimeError from either wrapper leaves step() as it is: the
    guard, the ladder and the split fallback catch nothing but the
    injected fault type."""
    def broken(*args, **kw):
        raise RuntimeError("paged attention kernel: launch failed")

    monkeypatch.setattr(PA, "paged_mixed_attention", broken)
    monkeypatch.setattr(PA, "paged_decode_attention", broken)
    eng = _engine(model, _requests(), mixed_exec=mixed_exec,
                  speculative=speculative, faults=FaultConfig(
                      enabled=step_rate > 0, step_rate=step_rate))
    with pytest.raises(RuntimeError, match="launch failed"):
        eng.step()
    rec = _recoveries(eng)
    assert not {"retry", "strict", "gather", "fp32"} & set(rec)
    assert rec == ({"split_fallback": 1.0} if step_rate else {})
    assert eng.stats()["failed_requests"] == 0


def test_step_launch_fault_gives_split_twin_tokens(model):
    """Every fused step fails at launch (injected): each degrades to the
    split twin, so the run is the split twin's, token for token and launch
    for launch, with split_fallback counted once per fired step."""
    reqs = _requests(11, n=8)
    twin, touts = _run(model, reqs, speculative=True, draft_len=3,
                       mixed_exec="split")
    eng, outs = _run(model, reqs, speculative=True, draft_len=3,
                     faults=FaultConfig(enabled=True, step_rate=1.0))
    assert _tokens(outs) == _tokens(touts)
    fired = eng.stats()["faults"]["by_site"]["step"]
    assert fired == eng.mixed_steps == twin.mixed_steps > 0
    assert _recoveries(eng) == {"split_fallback": float(fired)}
    assert eng.launch_counts == twin.launch_counts
    assert eng.launch_counts["mixed"] == 0


def test_gather_rung_recovery_is_counted_and_traced(model, monkeypatch):
    """The "cuda" arm returns NaN attention, the "gather" arm stays clean:
    every row fails its retry and recovers on the gather rung, which is
    counted and traced, never silent."""
    reqs = _requests(5, n=4)
    _, clean = _run(model, reqs, kernel="gather")
    mixed, decode = PA.paged_mixed_attention, PA.paged_decode_attention

    # NaN in every live row; pad rows (null block table) stay finite: they
    # write the null block, which every gather-path call reads past a row's
    # blocks (masked, but 0 x NaN is NaN), in JAX as in the port
    def nan_live(out, bt):
        live = (bt[:, 0] != 0).view(-1, *[1] * (out.dim() - 1))
        return out.masked_fill(live, float("nan"))

    def nan_mixed(q, ak, av, bt, *args, **kw):
        out, nsel = mixed(q, ak, av, bt, *args, **kw)
        return nan_live(out, bt), nsel

    def nan_decode(q, ak, av, bt, *args, **kw):
        out, nsel = decode(q, ak, av, bt, *args, **kw)
        return nan_live(out, bt), nsel

    monkeypatch.setattr(PA, "paged_mixed_attention", nan_mixed)
    monkeypatch.setattr(PA, "paged_decode_attention", nan_decode)
    eng, outs = _run(model, reqs, obs=ObsConfig(trace=True))
    assert _tokens(outs) == _tokens(clean)
    assert all(o.error is None for o in outs.values())
    rec = _recoveries(eng)
    assert set(rec) == {"gather"} and rec["gather"] > 0
    instants = [e[1] for e in eng.obs.tracer.events()
                if e[1].startswith("recover:")]
    assert instants == ["recover:gather"] * int(rec["gather"])
    assert eng.metrics_snapshot()["engine_recoveries_total"] == \
        {"action=gather": rec["gather"]}
    # rung 0 re-ran each row on the broken arm first: one-row launches
    assert eng.launch_counts["prefill"] == 2 * rec["gather"]


def test_defrag_mid_run_leaves_tokens_unchanged(model):
    """defrag() during serving must not change later outputs (after
    tests/test_serving.py::test_engine_defrag_mid_run)."""
    rng = np.random.default_rng(8)
    reqs = [(rng.integers(0, 128, int(rng.integers(4, 16))).tolist(),
             SamplingParams(max_new_tokens=6, seed=i)) for i in range(4)]

    def run(defrag_every):
        eng = _engine(model, reqs, n_blocks=40)
        outs, step, moved = {}, 0, 0
        while eng.has_unfinished():
            outs.update((o.req_id, o) for o in eng.step())
            step += 1
            if defrag_every and step % defrag_every == 0:
                before = [list(s.block_ids) for s in eng.scheduler.running]
                eng.defrag()
                moved += sum(b != s.block_ids for b, s in
                             zip(before, eng.scheduler.running))
                eng.pool.check_invariants(eng._seqs.values())
        return eng, _tokens(outs), moved

    _, base, _ = run(0)
    eng, tokens, moved = run(2)
    assert tokens == base
    assert moved > 0
    assert eng.obs.phase_hist("defrag").count > 0


@pytest.mark.parametrize("speculative", [False, True])
def test_paranoid_tight_pool_with_preemptions(model, speculative):
    """paranoid=True checks the pool after every step of a run that must
    preempt (n_blocks=20); tokens equal a roomy pool's."""
    reqs = _requests(3, n=8, lo=12, hi=30)
    kw = dict(paranoid=True, speculative=speculative, draft_len=3)
    _, big = _run(model, reqs, n_blocks=200, **kw)
    eng, small = _run(model, reqs, n_blocks=20, **kw)
    assert eng.num_preemptions > 0
    assert _tokens(small) == _tokens(big)
    assert all(o.error is None for o in small.values())


def test_retry_probe_reduced(capsys):
    """The rung-0 probe on the CPU: every retry it sees is one the engine
    counted, nothing fails, the tokens are the fault-free run's."""
    res = retry_probe.main(["--device", "cpu", "--reduced"])
    assert res["rows"] == res["retries"] > 0
    assert 0 <= res["bits_equal"] <= res["rows"]
    assert res["failed"] == 0 and res["tokens_equal_fault_free"]
    assert capsys.readouterr().out.strip().startswith("{")


def test_serve_cli_fault_flags(capsys):
    assert serve.main(["--reduced", "--num-requests", "6", "--device", "cpu",
                       "--fault-nan", "0.2", "--fault-salt", "3"]) == 0
    out = capsys.readouterr().out
    assert "[serve] faults: injected=" in out
    line = next(l for l in out.splitlines() if "[serve] faults:" in l)
    assert "failed_requests=0" in line and "nan=" in line
    assert "FAILED" not in out


def test_serve_cli_missed_deadline_exits_1(capsys):
    assert serve.main(["--reduced", "--num-requests", "2", "--device", "cpu",
                       "--deadline", "1e-9"]) == 1
    out = capsys.readouterr().out
    assert out.count("(timeout): deadline_s=1e-09") == 4   # logged, listed
    assert "failed_requests=2" in out


def test_serve_stream_skips_rejected_requests(model):
    cfg, params = model
    clock = FakeClock(100.0)
    eng = LampEngine(cfg, params, EngineConfig(**_BASE, max_queue=1),
                     clock=clock)
    stream = [(0.0, [1, 2, 3, 4], SamplingParams(max_new_tokens=2, seed=i))
              for i in range(3)]
    lines = []
    outs = serve.serve_stream(eng, stream, log=lines.append,
                              sleep=clock.advance)
    assert sum("REJECTED" in l for l in lines) == 2
    assert [o.req_id for o in outs] == [0]
    assert eng.metrics_snapshot()["engine_requests_failed_total"] == \
        {"reason=queue_full": 2.0}
