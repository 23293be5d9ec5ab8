"""Port vs JAX: the phase-segregated plans (`EngineConfig.fused_step=False`).

With `fused_step=False` the scheduler emits the JAX package's pre-fusion
plans -- each step one prefill batch or one decode batch, prefill never
twice in a row while rows decode -- and the engine runs each through the
sub-step of its phase (`_step_prefill`, `_step_decode`, or `_step_spec`
when the plan carries a draft budget). The port replays the JAX engine's
`fused_step=False` plan stream (`tests/plan_replay.py`, `kernel="gather"`)
on the reduced GPT-2 of `tests/test_audit.py` (relaxed rule at granularity
1, so the per-layer LAMP counts are exact across the packages), in two
streams sharing an 8-token prefix (prefix hits) with chunked prefill:
speculation off in a 20-block pool that preempts, and speculation on in a
roomy pool with the shadow audit at rate 1.0. Plans, greedy tokens, the
step counters (`prefill_steps`, `decode_steps`, `spec_rounds`), launches by
kind, per-request LAMP counts and the audited steps and rows equal the JAX
engine's; the greedy tokens also equal the port's own fused run. The
serve CLI's engine flags reach the engine.

Tolerances: none but the audit's `audit_err_sum`, within 2e-6 an audited
step (see `tests/test_torch_audit.py`); everything else is exact.
"""

import json

import numpy as np
import pytest

import jax

from plan_replay import check_replay, record_plans
from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.models import transformer as JT
from repro.serving import AuditConfig as JaxAuditConfig
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import LampEngine as JaxEngine
from repro.serving import SamplingParams as JaxSamplingParams
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import (AuditConfig, EngineConfig, LampEngine,
                                 SamplingParams)

ERR_ATOL = 2e-6

_BASE = dict(block_size=4, max_model_len=64, max_prefill_batch=4,
             max_decode_batch=16, max_prefill_tokens=24, prefix_cache=True,
             chunked_prefill=True, fused_step=False)
CASES = {
    "spec_off_tight_pool": dict(n_blocks=20),
    "spec_on_audited": dict(speculative=True, draft_len=3),
}


def _relaxed_g1(cfg):
    kq = cfg.lamp.kq.replace(rule="relaxed", granularity=1, tau=0.1)
    return cfg.replace(lamp=cfg.lamp.replace(kq=kq))


@pytest.fixture(scope="module")
def model():
    jcfg = _relaxed_g1(jax_reduced(jax_get_config("gpt2")).replace(vocab=128))
    cfg = _relaxed_g1(reduced(get_config("gpt2")).replace(vocab=128))
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, tparams


def _requests(vocab, n=6, seed=5):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=8).tolist()
    return [((shared if i % 2 == 0 else [])
             + rng.integers(0, vocab, size=int(rng.integers(4, 30))).tolist(),
             int(rng.integers(6, 12)), i) for i in range(n)]


def _submit(eng, reqs, params_cls):
    for i, (prompt, n_new, seed) in enumerate(reqs):
        eng.add_request(prompt, params_cls(max_new_tokens=n_new, seed=seed),
                        arrival_time=float(i))


def _audited(eng):
    seen = []
    if eng.auditor is not None:
        inner = eng.auditor.account

        def account(step, seqs, metrics):
            seen.append((step, tuple(s.req_id for s in seqs)))
            return inner(step, seqs, metrics)

        eng.auditor.account = account
    return seen


@pytest.fixture(scope="module", params=list(CASES))
def run(request, model):
    """(case, JAX engine, port engine, their outputs, plan trace, the
    port's plans, audited rows of each, requests, options), once per case:
    the port replays the JAX engine's plans."""
    name = request.param
    jcfg, cfg, jparams, tparams = model
    opts = dict(_BASE, **CASES[name])
    audit = dict(rate=1.0 if name == "spec_on_audited" else 0.0)
    reqs = _requests(cfg.vocab)
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(
        kernel="gather", audit=JaxAuditConfig(**audit), **opts))
    trace = record_plans(jeng)
    jseen = _audited(jeng)
    _submit(jeng, reqs, JaxSamplingParams)
    jouts = {o.req_id: o for o in jeng.run_to_completion()}
    teng = LampEngine(cfg, tparams, EngineConfig(
        device="cpu", audit=AuditConfig(**audit), **opts))
    seen = check_replay(teng, trace)
    tseen = _audited(teng)
    _submit(teng, reqs, SamplingParams)
    touts = {o.req_id: o for o in teng.run_to_completion()}
    return (name, jeng, teng, jouts, touts, trace, seen, jseen, tseen, reqs,
            opts)


def test_plan_stream_is_the_jax_schedulers(run):
    name, jeng, teng, _, _, trace, seen, _, _, _, opts = run
    assert seen == trace and len(trace) == teng.total_steps
    kinds = {p.kind for p in trace if p is not None}
    assert kinds == {"prefill", "decode"}
    for p in trace:
        if p.kind == "prefill":
            assert p.windows and p.draft_lens is None and p.roles is None
        else:
            assert p.windows is None and p.roles is None
            assert len(p.draft_lens) == len(p.req_ids)
    # never two prefill plans in a row while a row could decode is the
    # alternation rule; the streams exercise chunks and prefix hits
    s = teng.stats()
    assert s["prefill_chunks"] > 0 and s["cached_tokens"] > 0
    if name == "spec_off_tight_pool":
        assert s["preemptions"] > 0 and s["spec_rounds"] == 0
    else:
        assert s["spec_rounds"] > 0 and any(
            any(p.draft_lens) for p in trace if p.kind == "decode")


def test_tokens_counts_and_launches_equal_jax(run):
    name, jeng, teng, jouts, touts, *_ = run
    assert {r: o.tokens for r, o in touts.items()} == \
        {r: o.tokens for r, o in jouts.items()}
    for r, o in touts.items():
        j = jouts[r]
        assert (o.lamp_selected, o.lamp_valid, o.num_preemptions,
                o.num_cached_tokens, o.spec_drafted, o.spec_accepted) == \
            (j.lamp_selected, j.lamp_valid, j.num_preemptions,
             j.num_cached_tokens, j.spec_drafted, j.spec_accepted), r
        assert o.lamp_layer_rates == j.lamp_layer_rates, r
    for k in ("steps", "prefill_steps", "decode_steps", "mixed_steps",
              "spec_rounds", "launches", "prefill_chunks", "preemptions",
              "cached_tokens", "lamp_recompute_rate"):
        assert teng.stats()[k] == jeng.stats()[k], k
    ts, js = teng.metrics_snapshot(), jeng.metrics_snapshot()
    for n in ("engine_launches_total", "engine_steps_total",
              "engine_mixed_steps_total", "lamp_kq_products_total"):
        assert ts[n] == js[n], n
    assert teng.mixed_steps == 0 and teng.launch_counts["mixed"] == 0


def test_greedy_tokens_equal_the_fused_run(run, model):
    name, _, teng, _, touts, *_, reqs, opts = run
    fused = LampEngine(model[1], model[3], EngineConfig(
        device="cpu", **dict(opts, fused_step=True)))
    _submit(fused, reqs, SamplingParams)
    fouts = {o.req_id: o.tokens for o in fused.run_to_completion()}
    assert fouts == {r: o.tokens for r, o in touts.items()}
    assert fused.mixed_steps == fused.total_steps > 0
    assert teng.total_steps > fused.total_steps


def test_audit_on_phase_segregated_plans(run):
    name, jeng, teng, jouts, touts, _, _, jseen, tseen, *_ = run
    if name != "spec_on_audited":
        assert teng.auditor is None and tseen == jseen == []
        return
    assert tseen == jseen and len(tseen) == teng.total_steps
    a, ja = teng.stats()["audit"], jeng.stats()["audit"]
    for k in ("audited_steps", "audited_rows", "flip_rate", "calibrations"):
        assert a[k] == ja[k], k
    for r, o in touts.items():
        j = jouts[r]
        assert (o.audit_samples, o.audit_flips) == \
            (j.audit_samples, j.audit_flips), r
        assert abs(o.audit_err_sum - j.audit_err_sum) <= \
            ERR_ATOL * o.audit_samples, r
    assert teng.launch_counts["audit"] == len(tseen)
    assert teng.obs.phase_hist("audit").count == len(tseen)


def test_mixed_exec_is_not_consulted_without_fusion(model):
    """`mixed_exec` only chooses how mixed plans run: with fused_step off
    its "split" value changes nothing, and the default is the fused step."""
    _, cfg, _, tparams = model
    reqs = _requests(cfg.vocab, n=3, seed=6)
    outs = []
    for exec_ in ("fused", "split"):
        eng = LampEngine(cfg, tparams, EngineConfig(
            device="cpu", mixed_exec=exec_, **_BASE))
        _submit(eng, reqs, SamplingParams)
        outs.append(({o.req_id: o.tokens for o in eng.run_to_completion()},
                     eng.launch_counts))
    assert outs[0] == outs[1]
    assert EngineConfig().fused_step is True


def test_serve_cli_engine_flags(tmp_path, capsys):
    """The JAX CLI's engine flags reach the engine: --no-fused prints the
    phase-segregated step line, --audit-rate the audit summary and
    --audit-out its JSON; --n-blocks / --block-size size the pool."""
    out = tmp_path / "audit.json"
    assert serve.main([
        "--reduced", "--num-requests", "3", "--device", "cpu",
        "--max-new", "10", "--block-size", "8", "--n-blocks", "40",
        "--max-model-len", "96", "--max-prefill-tokens", "16",
        "--no-prefix-cache", "--no-chunked-prefill", "--no-fused",
        "--audit-rate", "1.0", "--audit-out", str(out),
        "--metrics-every", "1e-9"]) == 0
    text = capsys.readouterr().out
    assert "pool=39x8 blocks" in text and "fused=False" in text
    assert "prefix_cache=False chunked_prefill=False" in text
    assert " prefill / " in text and " decode steps" in text
    assert "[serve] audit: " in text and "audit per-layer KQ err" in text
    assert "audit_flips=0." in text
    summary = json.loads(out.read_text())
    assert summary["enabled"] and summary["audited_steps"] > 0
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu", "--max-model-len", "8"])
