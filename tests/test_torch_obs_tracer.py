"""The port's step-phase tracer and observability bundle
(``repro_torch.obs.tracing``, ``repro_torch.obs``) against the JAX
package's: the tracer and ``Observability`` cases of tests/test_obs.py, each
run on both packages with the same inputs under a fake clock, then both
packages' Chrome traces compared for equality; and the port's
``ObsConfig.torch_profile_dir`` passthrough (the counterpart of
``jax_profile_dir``).

Tolerance: exact (the tracer is plain Python in both)."""

import importlib
import json
import os

import pytest

PACKAGES = ("repro.obs", "repro_torch.obs")


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(params=PACKAGES)
def O(request):
    return importlib.import_module(request.param)


def test_tracer_fake_clock_spans(O):
    clk = FakeClock()
    tr = O.StepTracer(capacity=16, clock=clk)
    with tr.span("prefill", rows=2):
        clk.advance(0.25)
    clk.advance(0.1)
    tr.instant("compile:decode")
    (ph1, n1, _, t1, d1, a1), (ph2, n2, _, t2, d2, _) = tr.events()
    assert (ph1, n1, t1, d1, a1) == ("X", "prefill", 0.0, 0.25, {"rows": 2})
    assert (ph2, n2, t2, d2) == ("i", "compile:decode", 0.35, 0.0)


def test_tracer_ring_overflow(O):
    clk = FakeClock()
    tr = O.StepTracer(capacity=4, clock=clk)
    for i in range(10):
        clk.advance(1.0)
        tr.instant(f"e{i}")
    assert tr.dropped == 6
    assert [e[1] for e in tr.events()] == ["e6", "e7", "e8", "e9"]
    assert [e[1] for e in tr.last(2)] == ["e8", "e9"]


def _chrome(O):
    clk = FakeClock(100.0)          # nonzero origin: ts must be rebased
    tr = O.StepTracer(capacity=16, clock=clk)
    for _ in range(3):
        with tr.span("decode", bucket=[8]):
            clk.advance(0.002)
        clk.advance(0.001)
    tr.counter("lamp_recompute_rate", layer0=0.5, layer1=0.25)
    return tr.to_chrome_trace()


def test_chrome_trace_schema(O):
    doc = json.loads(json.dumps(_chrome(O)))
    evs = doc["traceEvents"]
    assert len(evs) == 4
    last_ts = -1.0
    for ev in evs:
        assert {"name", "cat", "ph", "pid", "tid", "ts"} <= set(ev)
        assert ev["ph"] in ("X", "i", "C")
        assert ev["ts"] >= max(0.0, last_ts)
        last_ts = ev["ts"]
        if ev["ph"] == "X":
            assert ev["dur"] == pytest.approx(2000.0)   # 2 ms in us
    assert evs[0]["ts"] == 0.0
    assert evs[-1]["args"] == {"layer0": 0.5, "layer1": 0.25}
    assert doc["otherData"]["dropped_events"] == 0


def test_null_tracer_surface(O, tmp_path):
    with O.NULL_TRACER.span("x") as sp:
        pass
    assert sp.elapsed == 0.0
    O.NULL_TRACER.instant("y")
    assert O.NULL_TRACER.events() == []
    assert not O.NULL_TRACER.enabled
    with pytest.raises(RuntimeError):
        O.NULL_TRACER.write(str(tmp_path / "nope.json"))


def test_tracer_write(O, tmp_path):
    clk = FakeClock()
    tr = O.StepTracer(capacity=8, clock=clk)
    with tr.span("s"):
        clk.advance(0.5)
    p = tr.write(str(tmp_path / "t.json"))
    assert json.load(open(p))["traceEvents"][0]["name"] == "s"


def test_obs_span_always_feeds_histograms(O):
    clk = FakeClock()
    obs = O.Observability(O.ObsConfig(trace=False), clock=clk)
    with obs.span("decode"):
        clk.advance(0.01)
    h = obs.phase_hist("decode")
    assert h.count == 1 and h.sum == pytest.approx(0.01)
    assert obs.tracer is O.NULL_TRACER


def test_obs_span_traces_when_enabled(O):
    clk = FakeClock()
    obs = O.Observability(O.ObsConfig(trace=True), clock=clk)
    with obs.span("prefill", rows=3):
        clk.advance(0.02)
    assert obs.phase_hist("prefill").count == 1
    (ph, name, cat, t0, dur, args), = obs.tracer.events()
    assert (ph, name, dur, args) == ("X", "prefill", 0.02, {"rows": 3})


def test_obs_compile_events(O):
    clk = FakeClock()
    obs = O.Observability(O.ObsConfig(trace=True, compile_log_capacity=2),
                          clock=clk)
    for i in range(3):
        obs.record_compile("decode", (8,), 0.5, step=i)
    assert len(obs.compile_events) == 2          # bounded log
    assert obs.compile_events[-1]["step"] == 2
    assert obs.registry.get("engine_compiles_total") \
        .labels("decode").value == 3
    assert [e[1] for e in obs.tracer.events()] == ["compile:decode"] * 3


def test_obs_write_trace_requires_path(O):
    obs = O.Observability(O.ObsConfig(trace=True))
    with pytest.raises(ValueError):
        obs.write_trace()


def test_chrome_traces_equal_across_packages():
    a, b = (_chrome(importlib.import_module(p)) for p in PACKAGES)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_obs_bundles_equal_across_packages():
    """The same spans and compile events through both bundles under one
    fake clock: equal registry snapshots and Chrome traces."""
    out = []
    for p in PACKAGES:
        O = importlib.import_module(p)
        clk = FakeClock(5.0)
        obs = O.Observability(O.ObsConfig(trace=True), clock=clk)
        for step in range(4):
            with obs.span("schedule"):
                clk.advance(1e-5 * (step + 1))
            with obs.span("mixed", rows=step + 1, bucket=[8, 1]):
                clk.advance(3e-3)
            if step == 0:
                obs.record_compile("mixed", (8, 1), 3e-3, step)
            with obs.span("sync"):
                clk.advance(7e-3)
        out.append((obs.registry.snapshot(), obs.tracer.to_chrome_trace(),
                    list(obs.compile_events)))
    assert json.dumps(out[0], sort_keys=True) == \
        json.dumps(out[1], sort_keys=True)


def test_torch_profile_is_a_noop_without_a_dir():
    from repro_torch.obs import ObsConfig, Observability
    obs = Observability(ObsConfig())
    with obs.profile():
        pass
    assert ObsConfig().torch_profile_dir == ""


def test_torch_profile_writes_a_chrome_trace(tmp_path):
    import torch
    from repro_torch.obs import ObsConfig, Observability
    out = str(tmp_path / "prof")
    obs = Observability(ObsConfig(torch_profile_dir=out))
    with obs.profile():
        torch.ones(8) @ torch.ones(8)
    doc = json.load(open(os.path.join(out, "trace.json")))
    assert any(ev.get("ph") == "X" for ev in doc["traceEvents"])
