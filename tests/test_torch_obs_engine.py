"""Port vs JAX: the engine's observability and its attention-path knob.

The JAX `LampEngine` (`fused_step=True`, `kernel="gather"`) serves a greedy
stream and records its plan stream (tests/plan_replay.py); the port's
engine, on the same weights (`params_from_jax`) and requests, replays it
under a checker that fails at the first plan that differs. Then:
tokens are identical with tracing on and off; `stats()` has every JAX key
(the port adds `launches_by_fn`); the compile events (the first run in the
process of a step function at a bucket) carry the same (kind, shape) keys
in the same order; the metrics snapshot has the same metric names and the
same counts; under one fake clock each, the latencies and TTFTs are
equal. On the port alone: the per-layer LAMP counters sum to the totals,
the split twin feeds the sub-step spans, the hang diagnostic and
`serve_stream` under a fake clock, and `kernel="gather"` gives the tokens
and counts of `kernel="cuda"` on the CPU without calling the wrappers.

Tolerance: everything here is exact (counts, tokens, keys, fake-clock
times); the LAMP counts against JAX are not compared here
(tests/test_torch_engine.py holds them, with its slack)."""

import json

import numpy as np
import pytest

import jax

from plan_replay import check_replay, record_plans
from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.models import transformer as JT
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import LampEngine as JaxEngine
from repro.serving import SamplingParams as JaxSamplingParams
from repro.serving.engine import reset_step_caches as jax_reset_step_caches
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import layers as LY
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.obs import ObsConfig
from repro_torch.serving import EngineConfig, LampEngine, SamplingParams
from repro_torch.serving.engine import reset_step_caches

_BASE = dict(block_size=4, max_model_len=64, max_prefill_batch=4,
             max_decode_batch=16, max_prefill_tokens=24)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(jax_get_config("gpt2"))
    cfg = reduced(get_config("gpt2"))
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, tparams


def _stream(vocab, n=5, seed=3):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=9).tolist()
    return [((shared if i % 3 == 0 else [])
             + rng.integers(0, vocab, size=int(rng.integers(4, 30))).tolist(),
             int(rng.integers(5, 10)), i) for i in range(n)]


def _jax_run(jcfg, jparams, reqs, *, clock=None, step=None, **kw):
    eng = JaxEngine(jcfg, jparams, JaxEngineConfig(
        fused_step=True, kernel="gather", **_BASE, **kw), clock=clock)
    trace = record_plans(eng)
    for i, (prompt, n_new, seed) in enumerate(reqs):
        eng.add_request(prompt, JaxSamplingParams(max_new_tokens=n_new,
                                                  seed=seed),
                        arrival_time=None if clock else float(i))
    outs = _drive(eng, step)
    return eng, trace, outs


def _torch_run(cfg, tparams, reqs, trace=None, *, clock=None, step=None,
               **kw):
    eng = LampEngine(cfg, tparams, EngineConfig(device="cpu", **_BASE, **kw),
                     clock=clock)
    seen = check_replay(eng, trace) if trace is not None else None
    for i, (prompt, n_new, seed) in enumerate(reqs):
        eng.add_request(prompt, SamplingParams(max_new_tokens=n_new,
                                               seed=seed),
                        arrival_time=None if clock else float(i))
    outs = _drive(eng, step)
    if trace is not None:
        assert seen == trace
    return eng, outs


def _drive(eng, step):
    """run_to_completion, or step by step calling `step()` after each."""
    if step is None:
        return {o.req_id: o for o in eng.run_to_completion()}
    outs = {}
    while eng.has_unfinished():
        outs.update((o.req_id, o) for o in eng.step())
        step()
    return outs


def test_trace_on_tokens_and_stats_keys_match_jax(model):
    jcfg, cfg, jparams, tparams = model
    reqs = _stream(cfg.vocab)
    jeng, trace, jouts = _jax_run(jcfg, jparams, reqs,
                                  obs=_jax_obs(trace=True))
    on, touts = _torch_run(cfg, tparams, reqs, trace,
                           obs=ObsConfig(trace=True))
    off, offouts = _torch_run(cfg, tparams, reqs, trace)
    assert {r: o.tokens for r, o in touts.items()} \
        == {r: o.tokens for r, o in jouts.items()} \
        == {r: o.tokens for r, o in offouts.items()}
    jkeys, tkeys = set(jeng.stats()), set(on.stats())
    assert jkeys <= tkeys and tkeys - jkeys == {"launches_by_fn"}
    assert set(off.stats()) == tkeys
    for key in ("policy", "audit", "faults"):
        assert on.stats()[key] == {"enabled": False}
    assert on.stats()["recoveries"] == on.stats()["failed_requests"] == 0
    assert off.obs.tracer.events() == [] and len(on.obs.tracer.events()) > 0
    assert set(on.stats()["phase"]) >= {"schedule", "mixed", "sync", "emit"}


def _jax_obs(**kw):
    from repro.obs import ObsConfig as JaxObsConfig
    return JaxObsConfig(**kw)


@pytest.mark.parametrize("speculative", [False, True])
def test_compile_event_keys_match_jax(model, speculative):
    """From cold caches, the same plan stream gives the same compile events
    (kind, bucket shape) in the same order; a second engine on warm caches
    gives none; stats() counts them."""
    jcfg, cfg, jparams, tparams = model
    reqs = _stream(cfg.vocab, n=4, seed=5)
    kw = dict(speculative=speculative, draft_len=2)
    jax_reset_step_caches()
    jeng, trace, _ = _jax_run(jcfg, jparams, reqs, **kw)
    reset_step_caches()
    teng, _ = _torch_run(cfg, tparams, reqs, trace, **kw)
    keys = [(e["kind"], e["shape"]) for e in teng.compile_events]
    assert keys == [(e["kind"], e["shape"]) for e in jeng.compile_events]
    assert len(set(keys)) == len(keys) > 0
    assert {k for k, _ in keys} == ({"mixed", "draft"} if speculative
                                    else {"mixed"})
    assert all(e["wall_s"] >= 0.0 for e in teng.compile_events)
    s = teng.stats()
    assert s["compiles"] == len(keys)
    assert s["compile_time_s"] == pytest.approx(
        sum(e["wall_s"] for e in teng.compile_events))
    warm, _ = _torch_run(cfg, tparams, reqs, trace, **kw)
    assert len(warm.compile_events) == 0


def test_per_layer_counts_sum_to_totals(model):
    _, cfg, _, tparams = model
    eng, outs = _torch_run(cfg, tparams, _stream(cfg.vocab),
                           obs=ObsConfig(trace=True), speculative=True,
                           draft_len=2)
    for o in outs.values():
        assert len(o.lamp_layer_selected) == cfg.n_layers
        assert sum(o.lamp_layer_selected) == pytest.approx(o.lamp_selected)
        assert sum(o.lamp_layer_valid) == pytest.approx(o.lamp_valid)
    fam = eng.obs.registry.get("lamp_kq_products_total")
    for l in range(cfg.n_layers):
        assert fam.labels(str(l), "selected").value == eng._layer_sel[l]
        assert fam.labels(str(l), "valid").value == eng._layer_val[l]
    rates = eng.stats()["lamp_layer_rates"]
    assert len(rates) == cfg.n_layers and all(0.0 < r <= 1.0 for r in rates)
    assert eng.agg_lamp_selected == float(eng._layer_sel.sum()) > 0
    # one series entry and one trace counter event per step with LAMP counts
    counters = [e for e in eng.obs.tracer.events() if e[0] == "C"]
    assert len(eng.layer_rate_series) == len(counters) == eng.total_steps
    assert [s for s, _ in eng.layer_rate_series] == list(range(eng.total_steps))
    assert eng.spec_verify_valid > 0 and eng.spec_rounds > 0


def test_fake_clock_latencies_match_jax(model):
    """One fake clock an engine, one second a step: every request's latency
    and TTFT (and the trace's timestamps) come from it, equal to JAX's."""
    jcfg, cfg, jparams, tparams = model
    reqs = _stream(cfg.vocab, n=4, seed=9)
    jclk, tclk = FakeClock(1000.0), FakeClock(1000.0)
    _, trace, jouts = _jax_run(jcfg, jparams, reqs, clock=jclk,
                               step=lambda: jclk.advance(1.0),
                               obs=_jax_obs(trace=True))
    teng, touts = _torch_run(cfg, tparams, reqs, trace, clock=tclk,
                             step=lambda: tclk.advance(1.0),
                             obs=ObsConfig(trace=True))
    assert {r: (o.latency, o.ttft) for r, o in touts.items()} == \
        {r: (o.latency, o.ttft) for r, o in jouts.items()}
    assert max(o.latency for o in touts.values()) >= 2.0
    assert all(1000.0 <= e[3] <= tclk.t for e in teng.obs.tracer.events())


def test_metrics_snapshot_names_match_jax(model):
    jcfg, cfg, jparams, tparams = model
    reqs = _stream(cfg.vocab, n=4, seed=3)
    jeng, trace, jouts = _jax_run(jcfg, jparams, reqs)
    teng, touts = _torch_run(cfg, tparams, reqs, trace)
    js, ts = jeng.metrics_snapshot(), teng.metrics_snapshot()
    json.dumps(ts)
    assert set(ts) == set(js)
    for name in ("engine_requests_finished_total",
                 "engine_generated_tokens_total", "engine_prefill_tokens_total",
                 "engine_prefill_chunks_total", "engine_live_requests",
                 "kv_blocks_allocated_total", "kv_blocks_prefix_hits_total",
                 "engine_steps_total", "engine_mixed_steps_total",
                 "engine_cached_tokens_total"):
        assert ts[name] == js[name], name
    assert ts["engine_requests_finished_total"] == len(touts)
    assert ts["engine_request_latency_seconds"]["count"] == len(touts)
    # launches by fn, the audit child included (no audit here: 0 in both)
    assert ts["engine_launches_total"] == js["engine_launches_total"]
    assert ts["engine_launches_total"]["fn=audit"] == 0
    text = teng.obs.registry.to_prometheus()
    assert "engine_steps_total" in text and "lamp_kq_products_total" in text
    h = teng._h_latency
    for s in (teng.stats(exact=False), teng.stats(exact=True)):
        assert h.vmin - 1e-9 <= s["latency_p50_s"] <= h.vmax + 1e-9


def test_split_twin_feeds_the_sub_step_spans(model):
    _, cfg, _, tparams = model
    reset_step_caches()
    eng, outs = _torch_run(cfg, tparams, _stream(cfg.vocab, n=4),
                           speculative=True, draft_len=2, mixed_exec="split")
    lc = eng.launch_counts
    for kind in ("prefill", "decode", "draft", "verify"):
        assert eng.obs.phase_hist(kind).count == lc[kind], kind
    assert lc["prefill"] > 0 and lc["draft"] == lc["verify"] > 0
    assert lc["mixed"] == 0 and eng.obs.phase_hist("mixed").count == 0
    assert eng.obs.phase_hist("sync").count == \
        lc["prefill"] + lc["decode"] + lc["verify"]
    assert eng.obs.phase_hist("alloc").count > 0
    kinds = {e["kind"] for e in eng.compile_events}
    assert {"prefill", "draft", "verify"} <= kinds <= \
        {"prefill", "decode", "draft", "verify"}


def test_run_to_completion_hang_diagnostic(model):
    _, cfg, _, tparams = model
    eng = LampEngine(cfg, tparams, EngineConfig(
        device="cpu", obs=ObsConfig(trace=True), **_BASE))
    eng.add_request(list(range(6)), SamplingParams(max_new_tokens=20))
    with pytest.raises(RuntimeError, match=r"1 request\(s\) still live") \
            as exc:
        eng.run_to_completion(max_steps=2)
    msg = str(exc.value)
    assert "registry snapshot:" in msg and "trace events:" in msg
    assert "req 0 decode gen=2/20" in msg


def test_finished_retention_bounds_the_outputs(model):
    _, cfg, _, tparams = model
    eng, outs = _torch_run(cfg, tparams, _stream(cfg.vocab, n=4),
                           finished_retention=2)
    assert len(eng._finished) == 2 and len(outs) == 4
    lat = sorted(o.latency for o in eng._finished)
    assert eng.stats(exact=True)["latency_p50_s"] == pytest.approx(
        float(np.percentile(lat, 50)))


def test_serve_stream_fake_clock(model):
    from repro_torch.launch.serve import metrics_line, serve_stream
    _, cfg, _, tparams = model
    clk = FakeClock()
    eng = LampEngine(cfg, tparams, EngineConfig(device="cpu", **_BASE),
                     clock=clk)
    stream = [(0.0, list(range(6)), SamplingParams(max_new_tokens=2)),
              (5.0, list(range(4)), SamplingParams(max_new_tokens=2))]
    lines = []
    outs = serve_stream(eng, stream, metrics_every=1.0, sleep=clk.advance,
                        log=lines.append, per_request=False)
    assert len(outs) == 2
    # the idle gap to the second arrival was crossed by the fake sleep
    # advancing the clock the arrivals are timed against
    assert outs[1].ttft >= 0.0 and clk.t >= 5.0
    assert any(line.startswith("[serve] t=") for line in lines)
    assert "live=" in metrics_line(eng, clk.t)


class _Calls:
    """Counts calls of both paged wrappers (module attributes)."""

    def __init__(self, monkeypatch):
        self.n = 0
        for name in ("paged_mixed_attention", "paged_decode_attention"):
            fn = getattr(PA, name)
            monkeypatch.setattr(PA, name, self._wrap(fn))

    def _wrap(self, fn):
        def call(*a, **k):
            self.n += 1
            return fn(*a, **k)
        return call


@pytest.mark.parametrize("mixed_exec", ["fused", "split"])
def test_kernel_gather_equals_cuda_on_cpu(model, monkeypatch, mixed_exec):
    """The knob: "gather" calls the plain versions by name, never the
    wrappers; "cuda" calls the wrappers (their plain versions on the CPU).
    Same tokens, per-request counts and stats on the CPU."""
    _, cfg, _, tparams = model
    reqs = _stream(cfg.vocab, n=4, seed=2)
    calls = _Calls(monkeypatch)
    runs = {}
    for kernel in ("cuda", "gather"):
        before = calls.n
        runs[kernel] = _torch_run(cfg, tparams, reqs, kernel=kernel,
                                  speculative=True, draft_len=2,
                                  mixed_exec=mixed_exec)
        runs[kernel] += (calls.n - before,)
    (ce, co, cn), (ge, go, gn) = runs["cuda"], runs["gather"]
    assert cn > 0 and gn == 0
    assert {r: (o.tokens, o.lamp_selected, o.lamp_valid,
                o.lamp_layer_selected) for r, o in co.items()} == \
        {r: (o.tokens, o.lamp_selected, o.lamp_valid,
             o.lamp_layer_selected) for r, o in go.items()}
    for key in ("steps", "launches", "spec_rounds", "spec_accepted_tokens",
                "lamp_recompute_rate", "verify_recompute_rate"):
        assert ce.stats()[key] == ge.stats()[key], key


def test_kernel_knob_rejects_other_values(model):
    from repro_torch.launch import serve
    _, cfg, _, tparams = model
    for bad in ("pallas", "fused", ""):
        with pytest.raises(ValueError, match="kernel must be"):
            LampEngine(cfg, tparams, EngineConfig(device="cpu", kernel=bad))
        with pytest.raises(ValueError, match="kernel must be"):
            TT.paged_decode_step(cfg, tparams, None, None, None, None,
                                 kernel=bad)
        with pytest.raises(ValueError, match="kernel must be"):
            LY.paged_attention_fns(bad)
        with pytest.raises(ValueError, match="kernel must be"):
            LY.paged_attention_decode_sublayer(
                cfg, None, None, arena_k=None, arena_v=None,
                block_tables=None, lengths=None, lamp_site=None, kernel=bad)
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu", "--kernel", "pallas"])
