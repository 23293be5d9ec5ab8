"""Port vs JAX: the MoE family on the serving path.

  * `moe.moe_apply` against the JAX function on the same numpy inputs, in
    FP32: router off, strict and relaxed; the capacity (window), T == 1
    (decode) and dropless capacities; two dispatch groups (asked for four,
    halved to two). Routing is exact: the top-k experts, each entry's slot
    in its expert's buffer (against a count of the earlier entries of the
    same expert, over JAX's experts) and the kept share. Every capacity
    case drops entries (kept share < 1). Outputs within rtol 2e-5 / atol
    2e-6, gate weights within rtol 1e-6; `router_lamp_rate` exact,
    `moe_aux_loss` within rtol 1e-6.
  * the same in bfloat16 at top 4, both packages' weights and inputs cast
    from the same FP32 numpy (round to nearest even in both): routing
    exact, every output within one bfloat16 step (2^-7 of its binade) of
    JAX's, and at most 1% of them off JAX's bits (the combine adds a
    token's contributions in order, each sum rounded to bfloat16).
  * `init_params` builds JAX's parameter layout for the MoE family, the
    router in FP32 whatever the model's dtype.
  * `paged_mixed_step`, `paged_decode_step` (dropless and not) and
    `paged_audit_window` on the reduced qwen3-moe-30b-a3b (8 experts, top
    2, its deployment router site: strict, g 0; the KQ site relaxed at
    granularity 1, where y_low is bit-exact, so the counts are exact)
    through `params_from_jax`, on a random arena, with pad rows, pad slots
    and a binding capacity: logits and arena within atol 1e-5 / rtol 1e-5
    (the tolerance of tests/test_torch_decode_step.py), LAMP counts exact,
    the written null block included (its slot 0 holds the last padded
    token's K/V, which the MoE routes); the audit's metrics within
    atol 2e-5 (`tests/test_torch_audit.py`'s granularity-0 bound), flips
    and top-k overlaps equal, `router_err` > 0 in every layer and within
    2e-6 + 1e-3 of JAX's relative.
  * the engine against the JAX engine (`kernel="gather"`) on that model
    at its deployment policy (KQ relaxed g 0 as well), plan streams
    replayed (`tests/plan_replay.py`), speculation off, and on
    with the shadow audit at rate 1: plans, greedy tokens, valid counts
    and the engine's counters equal, selected counts within 0.1% of the
    valid products, the audit's per-layer router error within 2e-6 + 1e-3
    relative. The engine's other paths on that model, the same way: the
    split twin (`mixed_exec="split"`: dropless decode rows beside
    capacity window rows), the phase-segregated plans
    (`fused_step=False`), and recovery through the FP32 rung (LAMP off,
    the router site with it) after injected NaN faults, both ladders cut
    to that rung: plans, greedy tokens, valid counts, the counters, the
    faults and the recoveries equal, selected counts as above.
  * the serve CLI on the MoE family, and CUDA asked for without a card.

Named slack: at granularity 0 a low arm rounds one FP32 matmul to PS(7),
and the two backends sum that matmul in different orders, so a value
within an FP32 ulp of a PS(7) rounding boundary may round apart: a step of
2^-8 in one attention or router logit, and a selection may move. At the KQ
site this happens on the step tests' arena (a KQ y_low of layer 1 moves
one token's logits by 8e-5), hence granularity 1 there; on the engine's
stream it moves selected counts only (the 0.1% slack above), and the
router's never rounds apart on these inputs (routing and tokens exact).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plan_replay import check_replay, record_plans
from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.core.policy import LampSite as JaxSite
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.serving import AuditConfig as JaxAuditConfig
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import FaultConfig as JaxFaultConfig
from repro.serving import LampEngine as JaxEngine
from repro.serving import SamplingParams as JaxSamplingParams
from repro_torch.configs import get_config, reduced
from repro_torch.core.policy import LampSite
from repro_torch.launch import serve
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import (AuditConfig, EngineConfig, FaultConfig,
                                 LampEngine, SamplingParams)

ARCH = "qwen3-moe-30b-a3b"
OUT_TOL = dict(rtol=2e-5, atol=2e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
AUDIT_ATOL = 2e-5
ROUTER_ERR_TOL = (2e-6, 1e-3)          # absolute, relative to JAX's


def _sites(rule):
    if rule == "off":
        return JaxSite(enabled=False), LampSite(enabled=False)
    kw = dict(enabled=True, mu=7, tau=0.05, rule=rule, granularity=0)
    return JaxSite(**kw), LampSite(**kw)


# (rule, B, T, experts, top-k, num_groups, dropless); at T == 1 entries
# drop only with experts > 4 x top-k
CASES = {
    "off_capacity": ("off", 4, 8, 8, 2, 1, False),
    "strict_capacity": ("strict", 4, 8, 8, 4, 1, False),
    "relaxed_capacity": ("relaxed", 4, 8, 8, 2, 1, False),
    "strict_decode_t1": ("strict", 16, 1, 64, 4, 1, False),
    "strict_dropless": ("strict", 4, 8, 8, 2, 1, True),
    "strict_groups": ("strict", 3, 6, 8, 2, 4, False),
}


def _moe_case(name, seed):
    rule, B, T, E, k, G, dropless = CASES[name]
    jcfg = jax_reduced(jax_get_config(ARCH)).replace(n_experts=E, top_k=k)
    cfg = reduced(get_config(ARCH)).replace(n_experts=E, top_k=k)
    d, ff = cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((d, E)) * d ** -0.5,
         "we_in": rng.standard_normal((E, d, 2 * ff)) * d ** -0.5,
         "we_out": rng.standard_normal((E, ff, d)) * ff ** -0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    # a component shared by every token skews the routing, so capacity binds
    x = (0.7 * rng.standard_normal((B, T, d))
         + rng.standard_normal((1, 1, d))).astype(np.float32)
    return jcfg, cfg, p, x, rule, G, dropless


def _earlier_same(flat_e):
    """Each entry's count of earlier entries of its expert: its slot."""
    return np.asarray([int(np.sum(flat_e[:i] == e))
                       for i, e in enumerate(flat_e)])


def _run_both(name, dtype, seed=0):
    jcfg, cfg, p, x, rule, G, dropless = _moe_case(name, seed)
    jsite, tsite = _sites(rule)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v) if k == "router" else jnp.asarray(v).astype(jdt)
          for k, v in p.items()}
    tp = {k: torch.from_numpy(v) if k == "router"
          else torch.from_numpy(v).to(tdt) for k, v in p.items()}
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    jy, jm = JM.moe_apply(jcfg, jp, jx, lamp_site=jsite, num_groups=G,
                          dropless=dropless)
    ty, tm = TM.moe_apply(cfg, tp, tx, lamp_site=tsite, num_groups=G,
                          dropless=dropless)
    # routing: JAX's router and lax.top_k against the port's `route`
    d = cfg.d_model
    probs, _ = JM.router_probs_lamp(jx.reshape(-1, d), jp["router"], jsite)
    jtop_p, jtop_e = jax.lax.top_k(probs, cfg.top_k)
    jtop_p = jtop_p / jnp.maximum(jnp.sum(jtop_p, -1, keepdims=True), 1e-9)
    _, ttop_p, ttop_e, _ = TM.route(cfg, tp["router"], tx.reshape(-1, d), tsite)
    groups = G                 # the dispatch groups moe_apply forms
    while x.shape[0] * x.shape[1] % groups:
        groups //= 2
    return (cfg, groups, np.asarray(jy.astype(jnp.float32)), jm,
            ty.float().numpy(), tm, np.asarray(jtop_e), np.asarray(jtop_p),
            ttop_e.numpy(), ttop_p.numpy())


def _check_routing(cfg, G, jtop_e, jtop_p, ttop_e, ttop_p, jm, tm):
    np.testing.assert_array_equal(ttop_e, jtop_e)
    np.testing.assert_allclose(ttop_p, jtop_p, rtol=1e-6, atol=0)
    Ng = jtop_e.shape[0] // G
    for g in range(G):
        flat = jtop_e[g * Ng:(g + 1) * Ng].reshape(-1)
        got = TM.slots(torch.from_numpy(ttop_e[g * Ng:(g + 1) * Ng]
                                        .reshape(-1)), cfg.n_experts)
        np.testing.assert_array_equal(got.numpy(), _earlier_same(flat))
    assert float(tm["kept_frac"]) == float(jm["kept_frac"])
    assert float(tm["router_lamp_rate"]) == float(jm["router_lamp_rate"])
    np.testing.assert_allclose(float(tm["moe_aux_loss"]),
                               float(jm["moe_aux_loss"]), rtol=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_apply_matches_jax_fp32(name):
    cfg, G, jy, jm, ty, tm, *routing = _run_both(name, "float32")
    _check_routing(cfg, G, *routing, jm, tm)
    np.testing.assert_allclose(ty, jy, **OUT_TOL)
    dropless = CASES[name][6]
    assert (float(tm["kept_frac"]) == 1.0) if dropless else \
        (float(tm["kept_frac"]) < 1.0)
    assert G == (2 if name == "strict_groups" else 1)   # 18 tokens: 4 -> 2


@pytest.mark.parametrize("name", ["strict_capacity", "strict_decode_t1"])
def test_moe_apply_matches_jax_bf16(name):
    cfg, G, jy, jm, ty, tm, *routing = _run_both(name, "bfloat16", seed=1)
    _check_routing(cfg, G, *routing, jm, tm)
    assert float(tm["kept_frac"]) < 1.0
    # one bfloat16 step at JAX's value: 2^-7 of its binade (bfloat16 keeps
    # 8 significant bits); and at most 1% of the outputs off JAX's bits,
    # which the k = 4 contributions summed in another order would exceed
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(jy), 2.0 ** -126))) - 7)
    assert np.all(np.abs(ty - jy) <= step), np.max(np.abs(ty - jy) / step)
    assert np.mean(ty != jy) <= 0.01, np.mean(ty != jy)


def test_init_params_has_jax_layout_and_fp32_router():
    jcfg = jax_reduced(jax_get_config(ARCH)).replace(dtype="bfloat16")
    cfg = reduced(get_config(ARCH)).replace(dtype="bfloat16")
    want = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))
    got = TT.init_params(cfg, 0, device="cpu")
    flat_w = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat_g.keys() == flat_w.keys()
    for k, w in flat_w.items():
        assert tuple(flat_g[k].shape) == tuple(w.shape), k
        assert str(flat_g[k].dtype).split(".")[-1] == str(w.dtype), k
    assert "mlp" not in got["blocks"]
    assert got["blocks"]["moe"]["router"].dtype == torch.float32
    assert got["blocks"]["moe"]["we_in"].dtype == torch.bfloat16


# -------------------------------------------------------------- model steps

@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(jax_get_config(ARCH))
    cfg = reduced(get_config(ARCH))
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, tparams


@pytest.fixture(scope="module")
def batch(model):
    """A random arena and one window bucket: prefill chunks at 0, 9 and 5,
    decode rows at 13 and 30 (pad slots past their one token), three pad
    rows (token 0 at position 0, a null block table)."""
    cfg = model[1]
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
        nb = -(-(starts[b] + lengths[b] + 1) // bs)
        bt[b, :nb] = perm[at:at + nb]
        at += nb
    tokens = rng.integers(0, cfg.vocab, (B, W)).astype(np.int32)
    tokens[5:] = 0
    taus = (0.05 * (1 + rng.random(L))).astype(np.float32)
    return ak, av, tokens, bt, starts, lengths, row_mask, taus


def _kq_g1(cfg):
    """The KQ site at granularity 1, where y_low is bit-exact across the
    packages; the router keeps its deployment site (strict, g 0)."""
    kq = cfg.lamp.kq.replace(granularity=1)
    return cfg.replace(lamp=cfg.lamp.replace(kq=kq))


@pytest.fixture
def kept(monkeypatch):
    """The kept share of every MoE dispatch the port runs."""
    seen = []
    inner = TM.moe_apply

    def recording(*a, **kw):
        y, m = inner(*a, **kw)
        seen.append(float(m["kept_frac"]))
        return y, m

    monkeypatch.setattr(TM, "moe_apply", recording)
    return seen


def _arenas(ak, av):
    return ({"k": jnp.asarray(ak), "v": jnp.asarray(av)},
            {"k": torch.from_numpy(ak.copy()), "v": torch.from_numpy(av.copy())})


def test_paged_mixed_step_matches_jax(model, batch, kept):
    jcfg, cfg, jparams, tparams = model
    jcfg, cfg = _kq_g1(jcfg), _kq_g1(cfg)
    ak, av, tokens, bt, starts, lengths, _, taus = batch
    jarena, arena = _arenas(ak, av)
    wl, warena, (wsel, wval) = JT.paged_mixed_step(
        jcfg, jparams, jnp.asarray(tokens), jarena, jnp.asarray(bt),
        jnp.asarray(starts), jnp.asarray(lengths), kernel="gather",
        per_layer=True, taus=jnp.asarray(taus), all_logits=True)
    gl, garena, (gsel, gval) = TT.paged_mixed_step(
        cfg, tparams, torch.from_numpy(tokens), arena, torch.from_numpy(bt),
        torch.from_numpy(starts), torch.from_numpy(lengths), per_layer=True,
        taus=torch.from_numpy(taus), all_logits=True)
    live = np.arange(tokens.shape[1])[None, :] < lengths[:5, None]
    np.testing.assert_allclose(gl.numpy()[:5][live], np.asarray(wl)[:5][live],
                               **STEP_TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(garena[n].numpy(), np.asarray(warena[n]),
                                   **STEP_TOL)
    np.testing.assert_array_equal(gval.numpy(), np.asarray(wval))
    np.testing.assert_array_equal(gsel.numpy(), np.asarray(wsel))
    # one dispatch a layer over the whole 8 x 8 bucket; capacity binds
    assert len(kept) == cfg.n_layers and min(kept) < 1.0


@pytest.mark.parametrize("dropless", [True, False])
def test_paged_decode_step_matches_jax(model, batch, kept, dropless):
    jcfg, cfg, jparams, tparams = model
    jcfg, cfg = _kq_g1(jcfg), _kq_g1(cfg)
    ak, av, tokens, bt, starts, _, _, taus = batch
    tok = tokens[:, :1]
    jarena, arena = _arenas(ak, av)
    wl, warena, (wsel, wval) = JT.paged_decode_step(
        jcfg, jparams, jarena, jnp.asarray(bt), jnp.asarray(starts),
        jnp.asarray(tok), kernel="gather", per_layer=True,
        moe_dropless=dropless, taus=jnp.asarray(taus))
    gl, garena, (gsel, gval) = TT.paged_decode_step(
        cfg, tparams, arena, torch.from_numpy(bt), torch.from_numpy(starts),
        torch.from_numpy(tok), per_layer=True, moe_dropless=dropless,
        taus=torch.from_numpy(taus))
    np.testing.assert_allclose(gl.numpy()[:5], np.asarray(wl)[:5], **STEP_TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(garena[n].numpy(), np.asarray(warena[n]),
                                   **STEP_TOL)
    np.testing.assert_array_equal(gval.numpy(), np.asarray(wval))
    np.testing.assert_array_equal(gsel.numpy(), np.asarray(wsel))
    assert len(kept) == cfg.n_layers
    if dropless:
        assert min(kept) == 1.0


def test_paged_audit_window_matches_jax(model, batch):
    jcfg, cfg, jparams, tparams = model
    jcfg, cfg = _kq_g1(jcfg), _kq_g1(cfg)
    ak, av, tokens, bt, starts, lengths, row_mask, taus = batch
    jarena, arena = _arenas(ak, av)
    before = {n: t.clone() for n, t in arena.items()}
    jm = JT.paged_audit_window(
        jcfg, jparams, jnp.asarray(tokens), jarena, jnp.asarray(bt),
        jnp.asarray(starts), jnp.asarray(lengths), jnp.asarray(row_mask),
        taus=jnp.asarray(taus))
    tm = TT.paged_audit_window(
        cfg, tparams, torch.from_numpy(tokens), arena, torch.from_numpy(bt),
        torch.from_numpy(starts), torch.from_numpy(lengths),
        torch.from_numpy(row_mask), taus=torch.from_numpy(taus))
    assert all(torch.equal(arena[n], before[n]) for n in arena)
    assert set(tm) == set(jm)
    live = int(row_mask.sum())
    for name, jv in jm.items():
        jv, tv = np.asarray(jv), tm[name].numpy()
        assert tv.dtype == np.float32 and tv.shape == jv.shape, name
        if jv.shape[0] != cfg.n_layers:
            jv, tv = jv[:live], tv[:live]
        if name in ("flip", "topk"):
            assert np.array_equal(tv, jv), name
        else:
            np.testing.assert_allclose(tv, jv, rtol=0, atol=AUDIT_ATOL,
                                       err_msg=name)
    r, jr = tm["router_err"].numpy(), np.asarray(jm["router_err"])
    assert np.all(r > 0) and np.all(jr > 0)
    np.testing.assert_allclose(r, jr, atol=ROUTER_ERR_TOL[0],
                               rtol=ROUTER_ERR_TOL[1])
    # without the router site the audit reports no router error
    off = cfg.replace(lamp=cfg.lamp.replace(router=LampSite(enabled=False)))
    tm_off = TT.paged_audit_window(
        off, tparams, torch.from_numpy(tokens), arena, torch.from_numpy(bt),
        torch.from_numpy(starts), torch.from_numpy(lengths),
        torch.from_numpy(row_mask), taus=torch.from_numpy(taus))
    assert np.all(tm_off["router_err"].numpy() == 0.0)


# ------------------------------------------------------------------- engine

_BASE = dict(block_size=4, max_model_len=64, max_prefill_batch=4,
             max_decode_batch=8, max_prefill_tokens=16, prefix_cache=True,
             chunked_prefill=True)
ENGINE_CASES = {
    "spec_off": dict(n_blocks=0),
    "spec_on_audited": dict(n_blocks=0, speculative=True, draft_len=3),
}


def _requests(vocab, n=6, seed=21):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=9).tolist()
    return [((shared if i % 2 else [])
             + rng.integers(0, vocab, size=int(rng.integers(3, 20))).tolist(),
             int(rng.integers(4, 10)), i) for i in range(n)]


def _submit(eng, reqs, params_cls):
    for i, (prompt, n_new, seed) in enumerate(reqs):
        eng.add_request(prompt, params_cls(max_new_tokens=n_new, seed=seed),
                        arrival_time=float(i))


@pytest.fixture(scope="module", params=list(ENGINE_CASES))
def engines(request, model):
    """The JAX engine's run and the port's replay of its plans, per case."""
    jcfg, cfg, jparams, tparams = model
    audit = 1.0 if request.param == "spec_on_audited" else 0.0
    opts = dict(_BASE, **ENGINE_CASES[request.param])
    reqs = _requests(cfg.vocab)
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(
        fused_step=True, kernel="gather", audit=JaxAuditConfig(rate=audit),
        **opts))
    trace = record_plans(jeng)
    _submit(jeng, reqs, JaxSamplingParams)
    jouts = {o.req_id: o for o in jeng.run_to_completion()}
    teng = LampEngine(cfg, tparams, EngineConfig(
        device="cpu", audit=AuditConfig(rate=audit), **opts))
    seen = check_replay(teng, trace)
    _submit(teng, reqs, SamplingParams)
    touts = {o.req_id: o for o in teng.run_to_completion()}
    return request.param, jeng, teng, jouts, touts, trace, seen


def test_engine_plans_and_tokens_equal_jax(engines):
    name, jeng, teng, jouts, touts, trace, seen = engines
    assert seen == trace and len(trace) == teng.total_steps
    assert touts.keys() == jouts.keys() == set(range(6))
    for rid, jo in jouts.items():
        to = touts[rid]
        assert to.tokens == jo.tokens, rid
        assert to.finish_reason == jo.finish_reason
        assert to.lamp_valid == jo.lamp_valid
        assert abs(to.lamp_selected - jo.lamp_selected) <= 1e-3 * jo.lamp_valid
        assert (to.spec_drafted, to.spec_accepted) == (jo.spec_drafted,
                                                       jo.spec_accepted)
    js, ts = jeng.stats(), teng.stats()
    for key in ("steps", "mixed_steps", "spec_rounds", "spec_drafted_tokens",
                "spec_accepted_tokens", "prefill_chunks", "cached_tokens",
                "launches"):
        assert ts[key] == js[key], key
    assert ts["cached_tokens"] > 0 and ts["prefill_chunks"] > 0
    assert (ts["spec_rounds"] > 0) == (name == "spec_on_audited")


def test_engine_audit_router_error_equals_jax(engines):
    name, jeng, teng, *_ = engines
    if name != "spec_on_audited":
        assert teng.auditor is None
        return
    a, ja = teng.stats()["audit"], jeng.stats()["audit"]
    assert a["audited_steps"] == ja["audited_steps"] == teng.total_steps
    assert a["audited_rows"] == ja["audited_rows"]
    r, jr = np.asarray(a["layer_router_err"]), np.asarray(ja["layer_router_err"])
    assert np.all(r > 0) and np.all(np.isfinite(r))
    np.testing.assert_allclose(r, jr, atol=ROUTER_ERR_TOL[0],
                               rtol=ROUTER_ERR_TOL[1])


PATH_CASES = {
    "split": dict(mixed_exec="split"),
    "phased": dict(fused_step=False),
    "fp32_rung": dict(faults=dict(enabled=True, salt=7, nan_rate=0.5,
                                  max_faults=2)),
}


def _fp32_rung_only(eng):
    inner = eng._retry_ladder
    eng._retry_ladder = lambda: [r for r in inner() if r[0] == "fp32"]


@pytest.mark.parametrize("name", list(PATH_CASES))
def test_engine_paths_equal_jax(model, name):
    jcfg, cfg, jparams, tparams = model
    opts = {**_BASE, "n_blocks": 0, "fused_step": True, **PATH_CASES[name]}
    faults = opts.pop("faults", None)
    reqs = _requests(cfg.vocab, n=4)
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(
        kernel="gather", faults=JaxFaultConfig(**(faults or {})), **opts))
    teng = LampEngine(cfg, tparams, EngineConfig(
        device="cpu", faults=FaultConfig(**(faults or {})), **opts))
    if faults:
        _fp32_rung_only(jeng)
        _fp32_rung_only(teng)
    trace = record_plans(jeng)
    _submit(jeng, reqs, JaxSamplingParams)
    jouts = {o.req_id: o for o in jeng.run_to_completion()}
    seen = check_replay(teng, trace)
    _submit(teng, reqs, SamplingParams)
    touts = {o.req_id: o for o in teng.run_to_completion()}
    assert seen == trace and touts.keys() == jouts.keys() == set(range(4))
    for rid, jo in jouts.items():
        to = touts[rid]
        assert (to.tokens, to.finish_reason, to.error) == \
            (jo.tokens, jo.finish_reason, jo.error), rid
        assert to.lamp_valid == jo.lamp_valid
        assert abs(to.lamp_selected - jo.lamp_selected) <= 1e-3 * jo.lamp_valid
    js, ts = jeng.stats(), teng.stats()
    for key in ("steps", "mixed_steps", "prefill_chunks", "cached_tokens",
                "launches", "faults", "recoveries", "failed_requests"):
        assert ts[key] == js[key], key
    assert (ts["mixed_steps"] > 0) == (name != "phased")
    if faults:
        rec = teng.metrics_snapshot()["engine_recoveries_total"]
        assert rec == {"action=fp32": ts["recoveries"]} and \
            ts["faults"]["by_site"]["nan"] == ts["recoveries"] > 0


# ----------------------------------------------------------- CLI and CUDA

def test_serve_cli_moe_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--reduced", "--num-requests", "3",
                       "--min-new", "4", "--max-new", "6", "--device",
                       "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH}-reduced" in out and "finished 3/3 requests" in out
    assert ARCH in serve.servable_archs()


def test_moe_paths_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config(ARCH))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_params(cfg, 0)
    params = TT.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LampEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", ARCH, "--reduced", "--num-requests", "1"])
    assert TT.FAMILIES == ("dense", "moe", "gpt2")
