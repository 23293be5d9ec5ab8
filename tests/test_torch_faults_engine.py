"""Port vs JAX: the engine's recovery half under injected faults.

The JAX `LampEngine` (`fused_step=True`, `kernel="gather"`) and the port's
engine (CPU; its default `kernel="cuda"`, which runs the plain versions on
the CPU) serve the same requests on the same weights (`params_from_jax`)
with the same `FaultConfig`. The JAX run records its plan stream
(tests/plan_replay.py); the port replays it under a checker that fails at
the first plan that differs -- injected allocation failures, stalls and
deferrals included. Then, per request, tokens, `finish_reason` and `error`
are equal, and so are `stats()["faults"]`, `stats()["recoveries"]`,
`failed_requests` and the registry's `engine_recoveries_total` by action.
Cases after tests/test_faults.py:180-330. Ladder exhaustion runs the
port's `kernel="gather"`, so both ladders have the same rungs and the error
strings compare; the ladders' rung names are held for both attention paths
by `_retry_ladder()` (and the card's ladder by `retry_ladder(on_card=True)`).
`defrag()` mid-run and a tight, preempting pool under `paranoid` give the
JAX engine's plans, block tables and tokens.

Sampled rows (temperature 0.8) draw JAX's threefry noise; that case holds
the port's tokens to the port's own fault-free run, and everything else to
JAX (tests/test_torch_threefry.py holds sampled tokens to JAX's). Tolerances:
none, everything is exact.
"""

import numpy as np
import pytest

import jax

from plan_replay import check_replay, record_plans
from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.models import transformer as JT
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import FaultConfig as JaxFaultConfig
from repro.serving import LampEngine as JaxEngine
from repro.serving import QueueFullError as JaxQueueFullError
from repro.serving import SamplingParams as JaxSamplingParams
from repro_torch.configs import get_config, reduced
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import (EngineConfig, FaultConfig, LampEngine,
                                 QueueFullError, SamplingParams)
from repro_torch.serving.engine import retry_ladder

_BASE = dict(block_size=4, max_model_len=64, max_prefill_tokens=64,
             max_prefill_batch=4, max_decode_batch=8, paranoid=True)

CHAOS_PLAIN = dict(enabled=True, salt=7, nan_rate=0.25, alloc_rate=0.15,
                   stall_rate=0.05, stall_steps=2, stall_s=0.0)
# every site fires on this stream (salt 6, ten requests)
CHAOS_SPEC = dict(enabled=True, salt=6, nan_rate=0.3, draft_rate=0.3,
                  step_rate=0.2, alloc_rate=0.1, stall_rate=0.05,
                  stall_steps=2, stall_s=0.0)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(jax_get_config("gpt2")).replace(vocab=128)
    cfg = reduced(get_config("gpt2")).replace(vocab=128)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, tparams


def _requests(seed, n=6, temperature=0.0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 128, size=int(rng.integers(3, 20))).tolist(),
             dict(max_new_tokens=int(rng.integers(2, 8)), seed=i,
                  temperature=temperature))
            for i in range(n)]


def _jax_run(model, reqs, faults=None, clock=None, **kw):
    jcfg, _, jparams, _ = model
    eng = JaxEngine(jcfg, jparams, JaxEngineConfig(
        fused_step=True, kernel="gather",
        faults=JaxFaultConfig(**faults) if faults else JaxFaultConfig(),
        **{**_BASE, **kw}), clock=clock)
    trace = record_plans(eng)
    for prompt, sp in reqs:
        eng.add_request(prompt, JaxSamplingParams(**sp))
    outs = {o.req_id: o for o in eng.run_to_completion()}
    eng.pool.check_invariants(eng._seqs.values())
    return eng, trace, outs


def _torch_run(model, reqs, trace=None, faults=None, clock=None, **kw):
    _, cfg, _, tparams = model
    eng = LampEngine(cfg, tparams, EngineConfig(
        device="cpu", faults=FaultConfig(**faults) if faults else FaultConfig(),
        **{**_BASE, **kw}), clock=clock)
    seen = check_replay(eng, trace) if trace is not None else None
    for prompt, sp in reqs:
        eng.add_request(prompt, SamplingParams(**sp))
    outs = {o.req_id: o for o in eng.run_to_completion()}
    eng.pool.check_invariants(eng._seqs.values())
    if trace is not None:
        assert seen == trace
    return eng, outs


def _recoveries(eng):
    snap = eng.metrics_snapshot()["engine_recoveries_total"]
    return {k: v for k, v in snap.items() if v}


def _assert_same(jeng, jouts, teng, touts, tokens=True):
    assert set(touts) == set(jouts)
    for rid, j in jouts.items():
        t = touts[rid]
        if tokens:
            assert t.tokens == j.tokens, rid
        assert (t.finish_reason, t.error) == (j.finish_reason, j.error), rid
    js, ts = jeng.stats(), teng.stats()
    assert ts["faults"] == js["faults"]
    assert ts["recoveries"] == js["recoveries"]
    assert ts["failed_requests"] == js["failed_requests"]
    assert _recoveries(teng) == _recoveries(jeng)


def _differential(model, reqs, faults, **kw):
    jeng, trace, jouts = _jax_run(model, reqs, faults, **kw)
    teng, touts = _torch_run(model, reqs, trace, faults, **kw)
    _assert_same(jeng, jouts, teng, touts)
    return jeng, jouts, teng, touts


def test_chaos_plain_greedy(model):
    """NaN, alloc and stall faults: every request recovered, the tokens of
    the fault-free run, the JAX engine's plans, faults and recoveries."""
    reqs = _requests(4)
    _, base = _torch_run(model, reqs)
    _, _, teng, touts = _differential(model, reqs, CHAOS_PLAIN,
                                      stall_patience=8)
    assert {r: o.tokens for r, o in touts.items()} == \
        {r: o.tokens for r, o in base.items()}
    s = teng.stats()
    assert s["faults"]["injected"] > 0 and s["recoveries"] > 0
    assert s["failed_requests"] == 0


def test_chaos_plain_sampled(model):
    """Temperature 0.8: rung 0 replays the (seed, tokens generated)-keyed
    stream, so recovered rows keep the fault-free tokens; plans, faults and
    recoveries equal JAX's (sampled tokens against JAX's: see the
    docstring)."""
    reqs = _requests(4, temperature=0.8)
    jeng, trace, jouts = _jax_run(model, reqs, CHAOS_PLAIN, stall_patience=8)
    teng, touts = _torch_run(model, reqs, trace, CHAOS_PLAIN,
                             stall_patience=8)
    _assert_same(jeng, jouts, teng, touts, tokens=False)
    _, base = _torch_run(model, reqs)
    assert {r: o.tokens for r, o in touts.items()} == \
        {r: o.tokens for r, o in base.items()}
    assert teng.stats()["faults"]["by_site"]["nan"] > 0


def test_chaos_spec_fused_all_five_sites(model):
    """All five sites against the fused speculative step (greedy): the
    verifier rejects corrupted drafts, an injected fused-step fault
    degrades to the split twin, NaN rows recover through the ladder."""
    reqs = _requests(11, n=10)
    _, base = _torch_run(model, reqs, speculative=True, draft_len=3)
    _, _, teng, touts = _differential(model, reqs, CHAOS_SPEC,
                                      speculative=True, draft_len=3,
                                      stall_patience=8)
    assert {r: o.tokens for r, o in touts.items()} == \
        {r: o.tokens for r, o in base.items()}
    by_site = teng.stats()["faults"]["by_site"]
    assert all(v > 0 for v in by_site.values()), by_site
    rec = _recoveries(teng)
    assert rec["action=split_fallback"] == by_site["step"]
    assert rec["action=retry"] > 0


def test_chaos_replays_bit_for_bit(model):
    reqs = _requests(4)
    fc = dict(enabled=True, salt=9, nan_rate=0.3, alloc_rate=0.2)
    jeng, trace, jouts = _jax_run(model, reqs, fc)
    runs = [_torch_run(model, reqs, trace, fc) for _ in range(2)]
    for teng, touts in runs:
        _assert_same(jeng, jouts, teng, touts)
    (e1, r1), (e2, r2) = runs
    assert {k: o.tokens for k, o in r1.items()} == \
        {k: o.tokens for k, o in r2.items()}
    assert e1.stats()["faults"] == e2.stats()["faults"]


def test_guard_off_survives_nan(model):
    """Guard off: injected NaN propagates like a real kernel fault; both
    engines still complete every request, inject the same faults and emit
    the same (partly garbage) tokens."""
    reqs = _requests(4)
    fc = dict(enabled=True, salt=7, nan_rate=0.5, max_faults=2)
    jeng, trace, jouts = _jax_run(model, reqs, fc, health_guard=False)
    teng, touts = _torch_run(model, reqs, trace, fc, health_guard=False)
    _assert_same(jeng, jouts, teng, touts)
    assert len(touts) == len(reqs)
    assert all(o.error is None for o in touts.values())
    assert teng.stats()["faults"]["by_site"]["nan"] == 2
    assert teng.stats()["recoveries"] == 0


def test_ladder_exhaustion_fails_each_request_alone(model):
    """An impossible health bound exhausts the ladder: each request fails
    alone with the same diagnostic as JAX's; the engine completes."""
    reqs = _requests(4, n=3)
    kw = dict(health_max_abs=1e-9, max_retries=2)
    jeng, trace, jouts = _jax_run(model, reqs, **kw)
    teng, touts = _torch_run(model, reqs, trace, kernel="gather", **kw)
    _assert_same(jeng, jouts, teng, touts)
    for o in touts.values():
        assert o.finish_reason == "unhealthy"
        assert "2 recovery rung(s) [retry/fp32]" in o.error
    assert teng.stats()["failed_requests"] == len(reqs)
    assert not teng.has_unfinished()
    # on the CPU the default attention path has the gather rung instead
    # of fp32 (JAX "pallas"'s ladder; on a card it has neither)
    _, touts = _torch_run(model, reqs, trace, **kw)
    assert all("[retry/gather]" in o.error for o in touts.values())


@pytest.mark.parametrize("rule", ["strict", "relaxed"])
@pytest.mark.parametrize("kernel,jax_kernel", [("cuda", "pallas"),
                                               ("gather", "gather")])
def test_ladder_rung_names_match_jax(model, rule, kernel, jax_kernel):
    """On the CPU the port's "cuda" path is the JAX "pallas" path's ladder
    (with a gather rung), its "gather" path JAX "gather"'s; a non-strict
    site adds the strict rung; max_retries truncates both alike. On a card
    the "cuda" path's ladder stops before the rungs that run the plain
    versions (retry -> strict); the "gather" path's is unchanged."""
    jcfg, cfg, jparams, tparams = model
    jcfg = jcfg.replace(lamp=jcfg.lamp.replace(
        kq=jcfg.lamp.kq.replace(rule=rule)))
    cfg = cfg.replace(lamp=cfg.lamp.replace(kq=cfg.lamp.kq.replace(rule=rule)))
    for retries in (1, 2, 4):
        jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(
            kernel=jax_kernel, max_retries=retries, **_BASE))
        teng = LampEngine(cfg, tparams, EngineConfig(
            device="cpu", kernel=kernel, max_retries=retries, **_BASE))
        jl, tl = jeng._retry_ladder(), teng._retry_ladder()
        assert [r[0] for r in tl] == [r[0] for r in jl]
        assert [(r[2], r[3] == "gather") for r in tl] == \
            [(r[2], r[3] == "gather") for r in jl]
        assert [r[1].lamp.kq.rule for r in tl] == \
            [r[1].lamp.kq.rule for r in jl]
        card = retry_ladder(cfg, teng.econfig, on_card=True)
        if kernel == "gather":
            assert card == tl
        else:
            assert all(r[3] == "cuda" for r in card)
            assert [r[0] for r in card] == \
                [a for a in ("retry", "strict") if a in
                 [r[0] for r in jl]][:retries]
    names = [r[0] for r in tl]
    want = ["retry"] + (["strict"] if rule != "strict" else []) + \
        (["gather"] if kernel == "cuda" else []) + ["fp32"]
    assert names == want


def test_deadline_expires_request_on_a_fake_clock(model):
    jcfg, cfg, jparams, tparams = model
    outs = []
    for Eng, Ecfg, Sp, params, c in (
            (JaxEngine, JaxEngineConfig, JaxSamplingParams, jparams, jcfg),
            (LampEngine, EngineConfig, SamplingParams, tparams, cfg)):
        clk = FakeClock(1000.0)
        extra = {} if Eng is JaxEngine else {"device": "cpu"}
        engine = Eng(c, params, Ecfg(block_size=4, max_model_len=64,
                                     paranoid=True, **extra), clock=clk)
        engine.add_request(list(range(8)),
                           Sp(max_new_tokens=32, deadline_s=5.0))
        engine.add_request(list(range(8, 16)), Sp(max_new_tokens=4))
        engine.step()
        clk.advance(10.0)                # past the first request's TTL
        got = []
        while engine.has_unfinished():
            got.extend(engine.step())
        engine.pool.check_invariants(engine._seqs.values())
        assert engine.stats()["failed_requests"] == 1
        outs.append({o.req_id: (o.tokens, o.finish_reason, o.error,
                                o.latency) for o in got})
    assert outs[1] == outs[0]
    assert outs[1][0][1] == "timeout" and "deadline_s=5.0" in outs[1][0][2]
    assert outs[1][1][1] == "length" and outs[1][1][2] is None


def test_queue_full_rejects_admission(model):
    jcfg, cfg, jparams, tparams = model
    for Eng, Ecfg, Sp, Err, params, c, extra in (
            (JaxEngine, JaxEngineConfig, JaxSamplingParams,
             JaxQueueFullError, jparams, jcfg, {}),
            (LampEngine, EngineConfig, SamplingParams, QueueFullError,
             tparams, cfg, {"device": "cpu"})):
        engine = Eng(c, params, Ecfg(block_size=4, max_model_len=64,
                                     max_queue=2, **extra))
        engine.add_request(list(range(6)), Sp(max_new_tokens=2))
        engine.add_request(list(range(6)), Sp(max_new_tokens=2))
        with pytest.raises(Err, match="admission queue full"):
            engine.add_request(list(range(6)), Sp(max_new_tokens=2))
        outs = engine.run_to_completion()
        assert len(outs) == 2 and all(o.error is None for o in outs)
        snap = engine.metrics_snapshot()["engine_requests_failed_total"]
        assert snap == {"reason=queue_full": 1.0}
        assert engine.stats()["failed_requests"] == 0


def test_watchdog_clears_long_stall(model):
    """A 500-step stall against patience 4: run_to_completion clears it
    (stall_clear) and finishes with the fault-free tokens."""
    reqs = _requests(4, n=3)
    _, base = _torch_run(model, reqs)
    fc = dict(enabled=True, salt=1, stall_rate=1.0, max_faults=1,
              stall_steps=500, stall_s=0.0)
    _, _, teng, touts = _differential(model, reqs, fc, stall_patience=4)
    assert {r: o.tokens for r, o in touts.items()} == \
        {r: o.tokens for r, o in base.items()}
    assert _recoveries(teng) == {"action=stall_clear": 1.0}
    assert teng.stats()["faults"]["by_site"]["stall"] == 1


def test_alloc_faults_degrade_not_crash(model):
    reqs = _requests(4)
    _, base = _torch_run(model, reqs)
    fc = dict(enabled=True, salt=2, alloc_rate=1.0, max_faults=3)
    _, _, teng, touts = _differential(model, reqs, fc, stall_patience=16)
    assert {r: o.tokens for r, o in touts.items()} == \
        {r: o.tokens for r, o in base.items()}
    assert all(o.error is None for o in touts.values())
    assert teng.stats()["faults"]["by_site"]["alloc"] == 3
    assert _recoveries(teng)["action=alloc_defer"] == 3


def _tables(eng):
    return [(s.req_id, list(s.block_ids)) for s in eng.scheduler.running]


def test_defrag_mid_run_matches_jax(model):
    """defrag() every 2 steps in both engines, in lockstep: the same plans,
    the same block tables after every defrag, and the JAX engine's tokens
    (after tests/test_serving.py::test_engine_defrag_mid_run)."""
    jcfg, cfg, jparams, tparams = model
    rng = np.random.default_rng(8)
    reqs = [(rng.integers(0, 128, int(rng.integers(4, 16))).tolist(),
             dict(max_new_tokens=6, seed=i)) for i in range(4)]
    kw = {**_BASE, "n_blocks": 40}
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(
        fused_step=True, kernel="gather", **kw))
    teng = LampEngine(cfg, tparams, EngineConfig(device="cpu", **kw))
    jtrace, ttrace = record_plans(jeng), record_plans(teng)
    for prompt, sp in reqs:
        jeng.add_request(prompt, JaxSamplingParams(**sp))
        teng.add_request(prompt, SamplingParams(**sp))
    jouts, touts, step, moved = {}, {}, 0, 0
    while jeng.has_unfinished():
        jouts.update((o.req_id, o) for o in jeng.step())
        touts.update((o.req_id, o) for o in teng.step())
        step += 1
        assert ttrace == jtrace, step
        if step % 2 == 0:
            before = _tables(teng)
            jeng.defrag()
            teng.defrag()
            assert _tables(teng) == _tables(jeng), step
            moved += before != _tables(teng)
    assert not teng.has_unfinished()
    teng.pool.check_invariants(teng._seqs.values())
    _assert_same(jeng, jouts, teng, touts)
    assert moved > 0


@pytest.mark.parametrize("speculative", [False, True])
def test_paranoid_tight_pool_matches_jax(model, speculative):
    """paranoid=True on a pool of 20 blocks that must preempt: the JAX
    engine's plans (preemptions included), tokens and outcomes."""
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, 128, int(rng.integers(12, 30))).tolist(),
             dict(max_new_tokens=int(rng.integers(2, 8)), seed=i))
            for i in range(8)]
    jeng, _, teng, touts = _differential(
        model, reqs, None, n_blocks=20, speculative=speculative, draft_len=3)
    assert teng.num_preemptions == jeng.num_preemptions > 0
    assert all(o.error is None for o in touts.values())
