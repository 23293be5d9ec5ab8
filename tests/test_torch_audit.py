"""Port vs JAX: the shadow audit.

`repro_torch/obs/audit.py` and `obs/error_model.py` are copies of the JAX
package's modules (numpy only): their code, docstrings aside, is checked to
be the reference's, and the sampling hash, row selection, error model and
`AuditConfig`'s validation are held to the reference's outputs bit for bit.

`transformer.paged_audit_window` (the shadow forward: the LAMP stream, the
FP32 reference stream and the shadow of LAMP on the reference's own q/k/v)
is held against JAX's on the same weights and the same random arena --
prefill chunks, decode rows, a pad row -- and must leave the arena
untouched; `paged_prefill` against JAX's on the same prompts.

The engine (the reduced GPT-2 of `tests/test_audit.py`, relaxed rule at
granularity 1 so the per-layer LAMP counts are exact across the packages;
fused step, speculation on, chunked prefill, audit rate 1.0) replays the
JAX engine's plan stream (`kernel="gather"`), greedy and sampled rows
mixed: the audit changes no served token, the audited steps and rows are
JAX's step by step, each request's `audit_samples` / `audit_flips` are
JAX's, `stats()["audit"]` has JAX's keys and counts, and with a live policy
the error model's targets reach the controller as in JAX.

Tolerances (the audited errors are relative L2 differences of two FP32
streams of about 1e-3; torch and XLA sum the FP32 matmuls in other orders,
which moves each stream by a few ulps and an error by about 1e-7 of the
compared values):
  * `paged_audit_window` at granularity 1, where y_low is bit-exact: every
    error metric within atol 2e-6; `flip` and `topk` exact (the largest
    difference seen is 9e-7, in `cum_err` under relaxed_ln);
  * at granularity 0 the FP32 dot, summed in another order, may put a
    y_low on a PS(7) rounding midpoint one step apart in the two packages,
    and on a bfloat16 arena a window's K or V element a few ulps from a
    bfloat16 midpoint may round one bfloat16 step (2^-8) apart: atol 2e-5
    (seen: 2.1e-7 at granularity 0; 6.6e-6 on the bfloat16 arena, in one
    row's `logit_rel`);
  * `paged_prefill`: the model steps' tolerance of tests/test_torch_model.py,
    logits and the written arena within atol 1e-5 / rtol 1e-5 (seen: 2.5e-7
    on logits of about 0.5, 1.7e-6 on K/V entries of a few units), counts
    exact at granularity 1;
  * engine: per-request `audit_err_sum` within 2e-6 an audited step, the
    smoothed errors within 2e-6, calibrated targets within rtol 1e-3;
    everything else exact.
"""

import ast
import inspect

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from plan_replay import check_replay, record_plans
from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.models import transformer as JT
from repro.obs import audit as JA
from repro.obs import error_model as JE
from repro.serving import AuditConfig as JaxAuditConfig
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import LampEngine as JaxEngine
from repro.serving import PolicyConfig as JaxPolicyConfig
from repro.serving import SamplingParams as JaxSamplingParams
from repro_torch.configs import get_config, reduced
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.obs import audit as TA
from repro_torch.obs import error_model as TE
from repro_torch.serving import (AuditConfig, EngineConfig, LampEngine,
                                 PolicyConfig, SamplingParams)
from repro_torch.serving.engine import reset_step_caches

ATOL_G1 = 2e-6
ATOL_G0 = 2e-5
STEP_TOL = 1e-5


def _code(mod):
    """The module's code with every docstring dropped."""
    tree = ast.parse(inspect.getsource(mod))
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) \
                and node.body and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant) \
                and isinstance(node.body[0].value.value, str):
            node.body = node.body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("mods", [(TA, JA), (TE, JE)],
                         ids=["audit", "error_model"])
def test_copies_are_the_reference_code(mods):
    assert _code(mods[0]) == _code(mods[1])


def test_hash_and_row_selection_bit_equal():
    rng = np.random.default_rng(0)
    for _ in range(400):
        step = int(rng.integers(0, 1 << 40))
        salt = int(rng.integers(-5, 1 << 20))
        ids = rng.integers(0, 10 ** 6, size=int(rng.integers(0, 12))).tolist()
        rate = float(rng.choice([0.0, 0.05, 0.5, 1.0, rng.random()]))
        rows = int(rng.integers(1, 6))
        for r in ids[:3] + [0]:
            assert TA.audit_hash(step, r, salt) == JA.audit_hash(step, r, salt)
        assert TA.select_rows(step, ids, rate, salt, rows) == \
            JA.select_rows(step, ids, rate, salt, rows)


def test_error_model_equal():
    rng = np.random.default_rng(1)
    cases = [np.zeros(4), np.full(3, 1e-3), rng.random(6) * 1e-2,
             rng.exponential(1e-3, 12), np.array([0.0, 2.0, 1e-9])]
    for e in cases:
        assert np.array_equal(TE.amplification(e), JE.amplification(e))
        for base in (0.01, 0.05, 1.0):
            for kw in ({}, dict(min_rate=0.02, max_rate=0.3, power=1.0)):
                assert np.array_equal(TE.derive_target_rates(e, base, **kw),
                                      JE.derive_target_rates(e, base, **kw))
        for flip in (0.0, 0.1, 1.0):
            assert np.array_equal(TE.attribute_flips(flip, e),
                                  JE.attribute_flips(flip, e))
            assert np.array_equal(TE.relax_mask(flip, e, 0.02),
                                  JE.relax_mask(flip, e, 0.02))
            t, ok = TE.calibrate(e, flip, 0.05, flip_budget=0.01)
            jt, jok = JE.calibrate(e, flip, 0.05, flip_budget=0.01)
            assert np.array_equal(t, jt) and np.array_equal(ok, jok)
    for M in (TE, JE):
        for base in (0.0, 1.5):
            with pytest.raises(ValueError):
                M.derive_target_rates(np.ones(2), base)


def test_audit_config_errors_as_jax():
    for bad in (dict(rate=-0.1), dict(rate=1.5), dict(ema=0.0), dict(ema=2.0),
                dict(max_rows=0), dict(top_k=0), dict(ring_capacity=0),
                dict(calibrate_every=0), dict(min_samples=0),
                dict(flip_budget=1.5), dict(min_rate=0.0),
                dict(min_rate=0.3, max_rate=0.2), dict(max_rate=1.5)):
        msgs = []
        for C in (AuditConfig, JaxAuditConfig):
            with pytest.raises(ValueError) as e:
                C(**bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert AuditConfig() == AuditConfig(**vars(JaxAuditConfig()))


# --------------------------------------------------------- shadow forward

def _site(cfg, rule, g, tau=0.1):
    kq = cfg.lamp.kq.replace(rule=rule, granularity=g, tau=tau)
    return cfg.replace(lamp=cfg.lamp.replace(kq=kq))


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_reduced(jax_get_config("gpt2")).replace(vocab=128)
    cfg = reduced(get_config("gpt2")).replace(vocab=128)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, tparams


@pytest.fixture(scope="module")
def window_batch(weights):
    """A random arena and one audit batch: prefill chunks at 0, 9 and 5,
    decode rows at 13 and 30, three pad rows."""
    cfg = weights[1]
    rng = np.random.default_rng(1)
    L, bs, n_blocks = cfg.n_layers, 4, 40
    shape = (L, n_blocks, bs, cfg.n_kv_heads, cfg.hd)
    ak = rng.standard_normal(shape).astype(np.float32)
    av = rng.standard_normal(shape).astype(np.float32)
    B, W, n_max = 8, 8, 12
    starts = np.array([0, 13, 9, 30, 5, 0, 0, 0], np.int32)
    lengths = np.array([8, 1, 6, 1, 3, 1, 1, 1], np.int32)
    row_mask = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)
    perm = rng.permutation(np.arange(1, n_blocks))
    bt = np.zeros((B, n_max), np.int32)
    at = 0
    for b in range(5):
        nb = -(-(starts[b] + lengths[b]) // bs)
        bt[b, :nb] = perm[at:at + nb]
        at += nb
    tokens = rng.integers(0, cfg.vocab, (B, W)).astype(np.int32)
    taus = (0.1 * (1 + rng.random(L))).astype(np.float32)
    return ak, av, tokens, bt, starts, lengths, row_mask, taus


@pytest.mark.parametrize("rule,g,kv", [("relaxed", 1, "float32"),
                                       ("strict", 1, "float32"),
                                       ("relaxed", 1, "bfloat16"),
                                       ("relaxed", 0, "float32")])
def test_paged_audit_window_matches_jax(weights, window_batch, rule, g, kv):
    jcfg, cfg, jparams, tparams = weights
    ak, av, tokens, bt, starts, lengths, row_mask, taus = window_batch
    jcfg, cfg = _site(jcfg, rule, g), _site(cfg, rule, g)
    tdt = getattr(torch, kv)
    jarena = {n: jnp.asarray(a).astype(getattr(jnp, kv))
              for n, a in (("k", ak), ("v", av))}
    arena = {n: torch.from_numpy(a).to(tdt) for n, a in (("k", ak), ("v", av))}
    before = {n: t.clone() for n, t in arena.items()}
    jm = JT.paged_audit_window(
        jcfg, jparams, jnp.asarray(tokens), jarena, jnp.asarray(bt),
        jnp.asarray(starts), jnp.asarray(lengths), jnp.asarray(row_mask),
        taus=jnp.asarray(taus))
    tm = TT.paged_audit_window(
        cfg, tparams, torch.from_numpy(tokens), arena, torch.from_numpy(bt),
        torch.from_numpy(starts), torch.from_numpy(lengths),
        torch.from_numpy(row_mask), taus=torch.from_numpy(taus))
    # the served arena is read, never written
    assert all(torch.equal(arena[n], before[n]) for n in arena)
    assert set(tm) == set(jm)
    live = int(row_mask.sum())
    atol = ATOL_G1 if g == 1 and kv == "float32" else ATOL_G0
    for name, jv in jm.items():
        jv, tv = np.asarray(jv), tm[name].numpy()
        assert tv.dtype == np.float32 and tv.shape == jv.shape, name
        if jv.shape[0] != cfg.n_layers:
            jv, tv = jv[:live], tv[:live]
        if name in ("flip", "topk"):
            assert np.array_equal(tv, jv), name
        else:
            np.testing.assert_allclose(tv, jv, rtol=0, atol=atol, err_msg=name)
    assert np.all(tm["router_err"].numpy() == 0.0)
    assert np.all(tm["kq_err"].numpy() > 0) and np.all(tm["topk"].numpy() > 0)


def test_paged_prefill_matches_jax(weights):
    """`paged_prefill` (every row's window at position 0) against JAX's on
    the same prompts and an empty FP32 arena, a pad row included: logits,
    the written arena and the per-row counts, relaxed rule at granularity 1
    (y_low bit-exact, so counts exact)."""
    jcfg, cfg, jparams, tparams = weights
    jcfg, cfg = _site(jcfg, "relaxed", 1), _site(cfg, "relaxed", 1)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab, (3, 8)).astype(np.int32)
    lengths = np.array([8, 5, 1], np.int32)
    bt = np.array([[1, 2], [3, 4], [0, 0]], np.int32)
    jlogits, jarena, (jsel, jval) = JT.paged_prefill(
        jcfg, jparams, jnp.asarray(tokens),
        JT.init_paged_cache(jcfg, 5, 4, dtype=jnp.float32), jnp.asarray(bt),
        jnp.asarray(lengths))
    logits, arena, (sel, val) = TT.paged_prefill(
        cfg, tparams, torch.from_numpy(tokens),
        TT.init_paged_cache(cfg, 5, 4, device="cpu"), torch.from_numpy(bt),
        torch.from_numpy(lengths))
    assert logits.shape == jlogits.shape
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=STEP_TOL, atol=STEP_TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(arena[n].numpy(), np.asarray(jarena[n]),
                                   rtol=STEP_TOL, atol=STEP_TOL)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
    assert int(sel.sum()) > 0


# ----------------------------------------------------------------- engine

_BASE = dict(block_size=4, max_model_len=64, max_prefill_batch=4,
             max_decode_batch=16, max_prefill_tokens=24,
             chunked_prefill=True, speculative=True, draft_len=3)


def _relaxed_g1(cfg, tau=0.1):
    return _site(cfg, "relaxed", 1, tau)


def _stream(vocab, n=6, seed=3):
    """Even requests greedy, odd ones sampled (temperature 0.8)."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(4, 16))).tolist(),
             int(rng.integers(6, 12)), i, 0.0 if i % 2 == 0 else 0.8)
            for i in range(n)]


def _submit(eng, reqs, params_cls):
    for i, (prompt, n_new, seed, temp) in enumerate(reqs):
        eng.add_request(prompt, params_cls(max_new_tokens=n_new, seed=seed,
                                           temperature=temp),
                        arrival_time=float(i))


def _audited(eng):
    """Record (step, audited request ids) as the auditor accounts them."""
    seen = []
    inner = eng.auditor.account

    def account(step, seqs, metrics):
        seen.append((step, tuple(s.req_id for s in seqs)))
        return inner(step, seqs, metrics)

    eng.auditor.account = account
    return seen


def _pair(weights, reqs, audit, policy=None, **kw):
    """The JAX engine and the port replaying its plans; returns both
    engines, their outputs by request and their audited (step, rows)."""
    jcfg, cfg, jparams, tparams = weights
    jcfg, cfg = _relaxed_g1(jcfg), _relaxed_g1(cfg)
    base = dict(_BASE, **kw)
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(
        kernel="gather", audit=JaxAuditConfig(**audit),
        policy=JaxPolicyConfig(**(policy or {})), **base))
    trace = record_plans(jeng)
    jseen = _audited(jeng)
    _submit(jeng, reqs, JaxSamplingParams)
    jouts = {o.req_id: o for o in jeng.run_to_completion()}
    reset_step_caches()
    teng = LampEngine(cfg, tparams, EngineConfig(
        device="cpu", audit=AuditConfig(**audit),
        policy=PolicyConfig(**(policy or {})), **base))
    seen = check_replay(teng, trace)
    tseen = _audited(teng)
    _submit(teng, reqs, SamplingParams)
    touts = {o.req_id: o for o in teng.run_to_completion()}
    assert seen == trace
    return jeng, teng, jouts, touts, jseen, tseen


@pytest.fixture(scope="module")
def audited(weights):
    reqs = _stream(weights[1].vocab)
    return reqs, _pair(weights, reqs, dict(rate=1.0))


def test_audit_leaves_every_token_unchanged(weights, audited):
    """Greedy and sampled rows, speculation on: the audit-on stream equals
    the audit-off stream and the JAX engine's, token for token."""
    reqs, (_, teng, jouts, touts, _, _) = audited
    cfg = _relaxed_g1(weights[1])
    off = LampEngine(cfg, weights[3], EngineConfig(device="cpu", **_BASE))
    _submit(off, reqs, SamplingParams)
    offouts = {o.req_id: o for o in off.run_to_completion()}
    toks = {r: o.tokens for r, o in touts.items()}
    assert toks == {r: o.tokens for r, o in offouts.items()}
    assert toks == {r: o.tokens for r, o in jouts.items()}
    assert off.auditor is None and off.launch_counts["audit"] == 0
    assert teng.spec_rounds > 0


def test_audited_steps_and_rows_equal_jax(audited):
    _, (jeng, teng, _, _, jseen, tseen) = audited
    assert tseen == jseen
    a = teng.stats()["audit"]
    assert a["audited_steps"] == len(tseen) == teng.total_steps > 0
    assert a["audited_rows"] == sum(len(r) for _, r in tseen)
    assert all(len(r) <= AuditConfig().max_rows for _, r in tseen)
    assert teng.launch_counts["audit"] == len(tseen)


def test_per_request_audit_fields_equal_jax(audited):
    _, (_, _, jouts, touts, _, _) = audited
    assert set(touts) == set(jouts)
    for r, o in touts.items():
        j = jouts[r]
        assert (o.audit_samples, o.audit_flips) == \
            (j.audit_samples, j.audit_flips), r
        assert o.audit_samples > 0
        assert abs(o.audit_err_sum - j.audit_err_sum) <= \
            ATOL_G1 * o.audit_samples, r
        # counts exact at granularity 1: the per-layer rates are JAX's
        assert o.lamp_layer_rates == j.lamp_layer_rates, r
        assert len(o.lamp_layer_rates) == 2 and min(o.lamp_layer_rates) > 0


def test_stats_audit_equal_jax(audited):
    _, (jeng, teng, _, _, _, _) = audited
    a, ja = teng.stats()["audit"], jeng.stats()["audit"]
    assert set(a) == set(ja)
    for k, v in ja.items():
        if isinstance(v, float) and k != "rate":
            assert abs(a[k] - v) <= ATOL_G1, k
        elif isinstance(v, list) and v and isinstance(v[0], float):
            np.testing.assert_allclose(a[k], v, rtol=0, atol=ATOL_G1,
                                       err_msg=k)
        else:
            assert a[k] == v, k
    ts, js = teng.metrics_snapshot(), jeng.metrics_snapshot()
    names = {n for n in js if n.startswith("lamp_audit")}
    assert names == {n for n in ts if n.startswith("lamp_audit")}
    for n in ("lamp_audit_steps_total", "lamp_audit_rows_total",
              "lamp_audit_flips_total", "lamp_audit_calibrations_total"):
        assert ts[n] == js[n], n
    for n in ("lamp_audit_logit_rel_err", "lamp_audit_topk_overlap",
              "lamp_audit_request_cum_err"):
        assert ts[n]["count"] == js[n]["count"], n
    assert ts["engine_launches_total"] == js["engine_launches_total"]
    # the first run of each audit bucket is a compile event (the step keys
    # were forgotten before the run)
    shapes = [e["shape"] for e in teng.compile_events if e["kind"] == "audit"]
    assert shapes and len(set(map(tuple, shapes))) == len(shapes)
    assert teng.obs.phase_hist("audit").count == a["audited_steps"]


def test_calibration_reaches_the_policy_as_in_jax(weights):
    """Audited per-layer error -> error-model targets -> the controller, in
    both engines on one plan stream; a frozen controller is never
    calibrated into."""
    reqs = _stream(weights[1].vocab, n=4, seed=8)
    audit = dict(rate=1.0, calibrate_every=2, min_samples=2)
    pol = dict(enabled=True, target_rate=0.05)
    jeng, teng, jouts, touts, jseen, tseen = _pair(
        weights, reqs, audit, policy=pol, speculative=False)
    a, ja = teng.stats()["audit"], jeng.stats()["audit"]
    assert tseen == jseen
    assert a["calibrations"] == ja["calibrations"] > 0
    assert teng.policy.target_updates == a["calibrations"]
    np.testing.assert_allclose(a["targets"], ja["targets"], rtol=1e-3)
    assert a["relax_ok"] == ja["relax_ok"]
    p, jp = teng.stats()["policy"], jeng.stats()["policy"]
    assert p["target_updates"] == jp["target_updates"]
    assert p["targets"] == a["targets"]
    np.testing.assert_allclose(p["targets"], jp["targets"], rtol=1e-3)
    assert {r: o.tokens for r, o in touts.items()} == \
        {r: o.tokens for r, o in jouts.items()}
    cfg = _relaxed_g1(weights[1])
    froz = LampEngine(cfg, weights[3], EngineConfig(
        device="cpu", audit=AuditConfig(**audit),
        policy=PolicyConfig(enabled=True, frozen=True), **_BASE))
    _submit(froz, reqs[:2], SamplingParams)
    froz.run_to_completion()
    assert froz.stats()["audit"]["audited_steps"] > 0
    assert froz.policy.target_updates == 0


def test_disabled_without_lamp_and_the_ring_in_the_hang_diagnostic(weights):
    cfg, tparams = _relaxed_g1(weights[1]), weights[3]
    eng = LampEngine(cfg, tparams, EngineConfig(
        device="cpu", use_lamp=False, audit=AuditConfig(rate=1.0), **_BASE))
    assert eng.auditor is None
    assert eng.stats()["audit"] == {"enabled": False}
    assert "audit off" in eng._hang_diagnostic()
    eng = LampEngine(cfg, tparams, EngineConfig(
        device="cpu", audit=AuditConfig(rate=1.0), **_BASE))
    _submit(eng, _stream(cfg.vocab, n=2, seed=4), SamplingParams)
    eng.step()
    msg = eng._hang_diagnostic()
    assert "audit ring tail:" in msg and "step=0" in msg
