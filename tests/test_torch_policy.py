"""Port vs JAX: the adaptive LAMP policy loop.

`repro_torch/serving/policy.py` is a copy of `repro/serving/policy.py`
(numpy only, as `core/policy.py` was copied): its code is checked to be
the reference's line for line, and the two controllers are driven side by
side on Hypothesis-drawn signal sequences and configurations -- every
action (taus bit for bit, mode, rule, draft length, changed) and the final
`stats()` equal -- including the deadband edge where the reference's own
`tests/test_policy.py::test_deadband_holds_tau_still` fails (the copy
inherits that fault: both controllers move tau there, identically).

The engine: a frozen controller leaves tokens and taus as with the policy
off; with the policy on (relaxed rule at granularity 1, where y_low and so
the per-layer counts are exact across the packages) the port replays the
JAX engine's plan stream with the same tau trajectory step by step, the
same tokens, the same `stats()["policy"]`; under a pool tight enough to
preempt, SHED drops the rule tier (relaxed -> none) at the JAX engine's
steps and every attention call runs the tier then in force (on the CPU the
wrappers' plain versions), every request finishing with JAX's tokens.

Tolerances: none; everything compared is exact.
"""

import inspect

import numpy as np
import pytest

import jax
from hypothesis import given, strategies as st

from plan_replay import check_replay, record_plans
from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.models import transformer as JT
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import LampEngine as JaxEngine
from repro.serving import PolicyConfig as JaxPolicyConfig
from repro.serving import SamplingParams as JaxSamplingParams
from repro.serving import policy as JP
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import paged_attention as PA
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import (EngineConfig, LampEngine, PolicyConfig,
                                 SamplingParams)
from repro_torch.serving import policy as TP


def _code(mod):
    src = inspect.getsource(mod)
    return src[src.index('"""', 3) + 3:]          # past the module docstring


def test_copy_is_the_reference_line_for_line():
    assert _code(TP) == _code(JP)


def _pair(n_layers, tau0, base_rule, base_draft_len, **kw):
    return tuple(M.PolicyController(M.PolicyConfig(enabled=True, **kw),
                                    n_layers, tau0, base_rule=base_rule,
                                    base_draft_len=base_draft_len)
                 for M in (JP, TP))


def _step(ctrls, sig_kw):
    acts = [c.update(M.PolicySignals(**sig_kw))
            for c, M in zip(ctrls, (JP, TP))]
    a, b = acts
    assert a.taus.dtype == b.taus.dtype == np.float32
    assert np.array_equal(a.taus.view(np.int32), b.taus.view(np.int32))
    assert (a.mode, a.rule, a.draft_len, a.changed) == \
        (b.mode, b.rule, b.draft_len, b.changed)
    return a


_rate = st.floats(0.0, 0.5, allow_nan=False)
_signal = st.fixed_dictionaries({
    "rates": st.one_of(st.none(), st.lists(_rate, min_size=3, max_size=3)),
    "util": st.floats(0.0, 1.0, allow_nan=False),
    "preempt": st.integers(0, 2),
    "lat": st.floats(0.0, 0.2, allow_nan=False),
    "accept": st.floats(0.0, 1.0, allow_nan=False),
    "recover": st.integers(0, 1),
})
_config = st.fixed_dictionaries({
    "target_rate": st.floats(0.005, 0.3),
    "gain": st.floats(0.0, 2.0),
    "max_step": st.floats(0.01, 1.0),
    "deadband": st.floats(0.0, 0.5),
    "interval": st.integers(1, 3),
    "ema": st.floats(0.05, 1.0),
    "latency_slo_s": st.sampled_from([0.0, 0.05]),
    "frozen": st.booleans(),
    "shed_draft": st.booleans(),
    "degrade_rule": st.booleans(),
})


@given(cfg=_config, tau0=st.floats(1e-5, 0.95),
       base_rule=st.sampled_from(["strict", "relaxed", "relaxed_ln", "none"]),
       signals=st.lists(_signal, max_size=24))
def test_copy_acts_as_the_reference(cfg, tau0, base_rule, signals):
    ctrls = _pair(3, tau0, base_rule, 4, util_high=0.6, util_low=0.4,
                  shed_util=0.8, **cfg)
    preempt = recover = 0
    for s in signals:
        preempt += s["preempt"]
        recover += s["recover"]
        _step(ctrls, dict(
            layer_rates=None if s["rates"] is None else np.asarray(s["rates"]),
            utilization=s["util"], preemptions=preempt,
            step_latency_s=s["lat"], spec_acceptance=s["accept"],
            recoveries=recover))
    assert ctrls[0].stats() == ctrls[1].stats()


def test_copy_validates_and_calibrates_as_the_reference():
    for bad in (dict(tau_min=0.5, tau_max=0.1), dict(tau_max=1.0),
                dict(ema=0.0), dict(interval=0),
                dict(util_low=0.9, util_high=0.5)):
        for M in (JP, TP):
            with pytest.raises(ValueError):
                M.PolicyConfig(**bad)
    ctrls = _pair(3, 0.05, "relaxed", 4, target_rate=0.05)
    for c in ctrls:
        c.set_error_targets([0.01, 0.2, 0.05], relax_ok=[True, False, True])
    for k in range(6):
        _step(ctrls, dict(layer_rates=np.asarray([0.3, 0.01, 0.05]),
                          utilization=0.7 if k < 3 else 0.99,
                          preemptions=k // 3, step_latency_s=0.0))
    assert ctrls[0].stats() == ctrls[1].stats()


def test_deadband_edge_where_the_reference_test_fails():
    """The example the reference's `test_deadband_holds_tau_still` pins
    (jitter [0, 0, 1.0], one step): the third rate sits on the deadband's
    edge, where the float comparison tips and tau moves. The copy moves it
    by the same bits."""
    target, deadband = 0.05, 0.1
    ctrls = _pair(3, 0.01, "relaxed", 4, target_rate=target,
                  deadband=deadband, util_high=0.6, util_low=0.4,
                  shed_util=0.8)
    base = ctrls[0].taus.copy()
    rates = np.asarray([target * (1.0 + deadband * j) for j in (0, 0, 1.0)])
    act = _step(ctrls, dict(layer_rates=rates, utilization=0.1, preemptions=0,
                            step_latency_s=0.0))
    assert np.array_equal(act.taus[:2], base[:2])
    assert act.taus[2] != base[2]


_BASE = dict(block_size=4, max_model_len=64, max_prefill_batch=4,
             max_decode_batch=16, max_prefill_tokens=24, prefix_cache=True,
             chunked_prefill=True)


def _relaxed_g1(cfg):
    """The model's KQ site at the relaxed rule, granularity 1: counts exact
    across the packages, so the rates the controllers see are equal."""
    kq = cfg.lamp.kq.replace(rule="relaxed", granularity=1, tau=0.05)
    return cfg.replace(lamp=cfg.lamp.replace(kq=kq))


@pytest.fixture(scope="module")
def model():
    jcfg = _relaxed_g1(jax_reduced(jax_get_config("gpt2")))
    cfg = _relaxed_g1(reduced(get_config("gpt2")))
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, tparams


def _requests(vocab, n=6, seed=4):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(4, 24))).tolist(),
             int(rng.integers(6, 10)), i) for i in range(n)]


def _submit(eng, reqs, params_cls):
    for i, (prompt, n_new, seed) in enumerate(reqs):
        eng.add_request(prompt, params_cls(max_new_tokens=n_new, seed=seed),
                        arrival_time=float(i))


def _run(eng, taus):
    """Run to completion, recording after each step the live thresholds
    and the rule tier in force."""
    outs, traj = {}, []
    while eng.has_unfinished():
        for o in eng.step():
            outs[o.req_id] = o
        traj.append((np.array(taus(), np.float32), eng._active_rule))
    return outs, traj


def test_frozen_controller_is_token_identical(model):
    _, cfg, _, tparams = model
    reqs = _requests(cfg.vocab)
    runs = []
    for policy in (PolicyConfig(), PolicyConfig(enabled=True, frozen=True,
                                                target_rate=0.001)):
        eng = LampEngine(cfg, tparams, EngineConfig(device="cpu",
                                                    policy=policy, **_BASE))
        _submit(eng, reqs, SamplingParams)
        outs, traj = _run(eng, lambda: eng.taus.numpy())
        runs.append(({r: o.tokens for r, o in outs.items()}, traj, eng))
    assert runs[0][0] == runs[1][0]
    assert all(np.all(t == np.float32(0.05)) and r is None
               for t, r in runs[1][1])
    st_ = runs[1][2].stats()["policy"]
    assert st_["enabled"] and st_["frozen"] and st_["actuations"] == 0
    assert runs[0][2].stats()["policy"] == {"enabled": False}


@pytest.mark.parametrize("n_blocks,spec", [(0, True), (18, False)])
def test_policy_engine_replays_jax(model, n_blocks, spec):
    """Policy on: the tau trajectory, the rule tier, the tokens and the
    policy stats equal the JAX engine's (speculation on in the roomy pool).
    With 18 blocks the pool preempts:
    SHED drops relaxed -> none and every attention call runs the tier in
    force after the step before it."""
    jcfg, cfg, jparams, tparams = model
    reqs = _requests(cfg.vocab)
    base = dict(_BASE, n_blocks=n_blocks)
    if spec:
        base.update(speculative=True, draft_len=3)
    pol = dict(enabled=True, target_rate=0.02, util_high=0.7, util_low=0.5,
               shed_util=0.9)
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(
        fused_step=True, kernel="gather", policy=JaxPolicyConfig(**pol), **base))
    trace = record_plans(jeng)
    _submit(jeng, reqs, JaxSamplingParams)
    jouts, jtraj = _run(jeng, lambda: jeng._taus)

    teng = LampEngine(cfg, tparams, EngineConfig(
        device="cpu", policy=PolicyConfig(**pol), **base))
    seen = check_replay(teng, trace)
    _submit(teng, reqs, SamplingParams)
    rules = []
    inner = PA.paged_mixed_attention

    def recording(*a, **kw):
        rules.append((teng.total_steps, a[6].rule))
        return inner(*a, **kw)

    PA.paged_mixed_attention = recording
    try:
        touts, ttraj = _run(teng, lambda: teng.taus.numpy())
    finally:
        PA.paged_mixed_attention = inner
    assert seen == trace
    assert {r: o.tokens for r, o in touts.items()} == \
        {r: o.tokens for r, o in jouts.items()}
    assert len(ttraj) == len(jtraj)
    for (tt, tr), (jt, jr) in zip(ttraj, jtraj):
        assert np.array_equal(tt.view(np.int32), jt.view(np.int32))
        assert tr == jr
    assert teng.stats()["policy"] == jeng.stats()["policy"]
    assert not np.all(ttraj[-1][0] == np.float32(0.05))      # tau moved
    if n_blocks:
        assert teng.stats()["preemptions"] > 0
        # every call ran the tier in force after the step before it
        assert len(ttraj) == teng.total_steps
        want = ["relaxed"] + [tr or "relaxed" for _, tr in ttraj[:-1]]
        assert [r for _, r in rules] == [want[step] for step, _ in rules]
        assert {r for _, r in rules} == {"relaxed", "none"}
        assert all(o.finish_reason in ("length", "stop")
                   for o in touts.values())


def test_serve_cli_policy_flags(capsys):
    """--policy, --target-recompute-rate and --latency-slo reach the
    engine (the JAX CLI's meanings); the summary prints the policy line
    and the periodic metrics line the policy mode."""
    from repro_torch.launch import serve
    assert serve.main(["--reduced", "--num-requests", "3", "--device", "cpu",
                       "--max-new", "10", "--policy",
                       "--target-recompute-rate", "0.01",
                       "--latency-slo", "10", "--metrics-every", "1e-9"]) == 0
    out = capsys.readouterr().out
    assert "policy=True" in out
    assert "mode=normal" in out and "[serve] policy: mode=" in out
    assert "actuations)" in out and "finished 3/3" in out
