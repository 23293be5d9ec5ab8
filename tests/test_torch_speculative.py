"""Port vs JAX: speculative decoding and the split twin.

  * `speculative_accept`: greedy rows emit exactly what the JAX rule emits
    on the same logits; sampled rows reproduce the target distribution
    (the accept / residual-resample property), whatever the draft
    distribution. The port draws from per-row torch generators, so sampled
    streams match JAX in distribution, not in bits.
  * `SpecConfig`, `draft_model_config`, `apply_top_k_rows`,
    `PagedKVPool.rollback` (with copy-on-write of a shared tail).
  * The engine: the JAX speculative engine (fused step, gather kernel)
    records its plan stream -- draft budgets, shedding under a tight pool,
    preemptions -- and the port's replays it under a checker, emitting the
    same greedy tokens; greedy spec-on equals spec-off; fused equals split.

Tolerances: tokens, plans, acceptance counts and cache statistics exact;
the sampled-distribution checks atol 0.035 on 4096 draws (about 4.5
standard errors of a frequency near 0.5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plan_replay import check_replay, record_plans
from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.models import transformer as JT
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import LampEngine as JaxEngine
from repro.serving import SamplingParams as JaxSamplingParams
from repro.serving import sampling as JSM
from repro.serving.speculative import speculative_accept as jax_accept
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import paged_attention as PA
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import EngineConfig, LampEngine, SamplingParams
from repro_torch.serving import sampling as SM
from repro_torch.serving.kv_pool import PagedKVPool
from repro_torch.serving.speculative import (SpecConfig, draft_model_config,
                                             speculative_accept)


def _accept(p, d, q, kd, temps, top_k=None, seeds=None, counts=None):
    R = len(kd)
    seeds = np.arange(R) if seeds is None else seeds
    counts = np.zeros(R, np.int64) if counts is None else counts
    emit, n = speculative_accept(torch.from_numpy(np.array(p, np.float32)),
                                 torch.from_numpy(np.array(d, np.int64)),
                                 torch.from_numpy(np.array(q, np.float32)),
                                 kd, seeds, counts, temps, top_k)
    return emit.numpy(), n.numpy()


def _jax_accept(p, d, q, kd, temps, top_k=None):
    R = len(kd)
    emit, n = jax_accept(
        jnp.asarray(p, jnp.float32), jnp.asarray(d, jnp.int32),
        jnp.asarray(q, jnp.float32), jnp.asarray(kd, jnp.int32),
        jnp.arange(R, dtype=jnp.int32), jnp.zeros(R, jnp.int32),
        jnp.asarray(temps, jnp.float32),
        None if top_k is None else jnp.asarray(top_k, jnp.int32))
    return np.asarray(emit), np.asarray(n)


def _chains():
    """The JAX suite's greedy chains: argmaxes 2, 5, 1, 7 at the four
    positions; drafts that all match, break at 1, break at 0, capped by kd
    and kd = 0 (a verify-only round)."""
    V, k = 8, 3
    p = np.full((5, k + 1, V), -10.0, np.float32)
    for j, t in enumerate([2, 5, 1, 7]):
        p[:, j, t] = 0.0
    d = np.asarray([[2, 5, 1], [2, 4, 1], [0, 5, 1], [2, 5, 1], [0, 0, 0]])
    return p, d, np.zeros((5, k, V), np.float32), [3, 3, 3, 1, 0]


def _random_case(seed):
    """Random logits with drafts equal to the verifier's argmax up to a
    random first mismatch, at ragged budgets."""
    rng = np.random.default_rng(seed)
    R, k, V = 8, 4, 32
    p = rng.standard_normal((R, k + 1, V)).astype(np.float32)
    d = np.argmax(p[:, :k], axis=-1)
    for r in range(R):
        cut = rng.integers(0, k + 1)
        d[r, cut:] = (d[r, cut:] + 1 + rng.integers(0, V - 1, size=k - cut)) % V
    q = rng.standard_normal((R, k, V)).astype(np.float32)
    return p, d, q, [int(x) for x in rng.integers(0, k + 1, size=R)]


@pytest.mark.parametrize("case", ["chains", 0, 1, 2])
def test_accept_greedy_matches_jax(case):
    p, d, q, kd = _chains() if case == "chains" else _random_case(case)
    temps = np.zeros(len(kd), np.float32)
    emit, n = _accept(p, d, q, kd, temps)
    jemit, jn = _jax_accept(p, d, q, kd, temps)
    np.testing.assert_array_equal(n, jn)
    for r in range(len(kd)):       # emit is defined up to n_accepted + 1
        np.testing.assert_array_equal(emit[r, :n[r] + 1], jemit[r, :jn[r] + 1])
    if case == "chains":
        assert n.tolist() == [3, 1, 0, 1, 0]
        assert emit[0].tolist() == [2, 5, 1, 7] and emit[2, 0] == 2


# q differs from p; q == p (acceptance near 1); q nearly disjoint from p
# (acceptance near 0): the first emitted token is distributed as p always
@pytest.mark.parametrize("p_logits,q_logits", [
    ([0.5, -0.6, 1.2, -2.0], [-1.0, 1.0, 0.0, 0.3]),
    ([1.0, 0.0, -1.0, 0.5], [1.0, 0.0, -1.0, 0.5]),
    ([1.0, 0.0, -1.0, 0.5], [-8.0, -8.0, 8.0, -8.0]),
])
def test_accept_matches_target_distribution(p_logits, q_logits):
    V, R = 4, 4096
    p_logits = np.asarray(p_logits, np.float32)
    q_logits = np.asarray(q_logits, np.float32)
    seeds, counts = np.arange(R), np.zeros(R, np.int64)
    temps = np.ones(R, np.float32)
    # proposals drawn from q as the drafter draws them
    d = SM.sample_rows(torch.from_numpy(np.broadcast_to(q_logits, (R, V)).copy()),
                       seeds, counts, temps, salt=SM.SALT_DRAFT).numpy()[:, None]
    emit, n = _accept(np.broadcast_to(p_logits, (R, 2, V)),
                      d, np.broadcast_to(q_logits, (R, 1, V)),
                      np.ones(R, np.int64), temps, seeds=seeds, counts=counts)
    first = np.where(n > 0, d[:, 0], emit[np.arange(R), n])
    emp = np.bincount(first, minlength=V) / R
    p = np.exp(p_logits) / np.exp(p_logits).sum()
    np.testing.assert_allclose(emp, p, atol=0.035)
    if np.array_equal(p_logits, q_logits):
        assert n.mean() > 0.95
    else:
        assert (n > 0).any() and (n == 0).any()


def test_top_k_rows_matches_jax_and_filters_both_distributions():
    rng = np.random.default_rng(5)
    lg = rng.standard_normal((3, 2, 11)).astype(np.float32)
    k = np.asarray([0, 2, 11])
    np.testing.assert_array_equal(
        SM.apply_top_k_rows(torch.from_numpy(lg), k).numpy(),
        np.asarray(JSM.apply_top_k_rows(jnp.asarray(lg), jnp.asarray(k))))
    # top_k = 1 makes p and q degenerate at their argmax: greedy behaviour
    # at any temperature
    V = 6
    p = np.random.default_rng(1).normal(size=(64, 2, V)).astype(np.float32)
    q = np.random.default_rng(2).normal(size=(64, 1, V)).astype(np.float32)
    d = np.argmax(q[:, 0], axis=-1)[:, None]
    emit, n = _accept(p, d, q, np.ones(64, np.int64),
                      np.full(64, 0.9, np.float32), top_k=np.ones(64, np.int64))
    p_arg = np.argmax(p, axis=-1)
    for r in range(64):
        assert n[r] == int(p_arg[r, 0] == d[r, 0])
        assert emit[r, n[r]] == p_arg[r, n[r]]


def test_keyed_draws_are_deterministic_and_salted():
    a = SM.row_uniforms([3, 4], [[0, 1], [0, 1]], SM.SALT_ACCEPT)
    b = SM.row_uniforms([3, 4], [[0, 1], [0, 1]], SM.SALT_ACCEPT)
    c = SM.row_uniforms([3, 4], [[0, 1], [0, 1]], SM.SALT_RESIDUAL)
    assert torch.equal(a, b) and not torch.equal(a, c)
    g = SM.row_gumbel([3, 4], [2, 2], SM.SALT_RESIDUAL, (7,))
    assert g.shape == (2, 7) and torch.isfinite(g).all()
    assert SM.row_seed(3, 5) == SM.row_seed(3, 5, SM.SALT_SAMPLE)
    assert SM.row_seed(3, 5) != SM.row_seed(3, 5, SM.SALT_DRAFT)


def test_spec_config_and_draft_config():
    with pytest.raises(ValueError, match="draft_len"):
        SpecConfig(draft_len=0)
    assert SpecConfig(draft_len=4).verify_width == 8
    assert SpecConfig(draft_len=3).verify_width == 4
    cfg = reduced(get_config("gpt2"))
    dcfg = draft_model_config(cfg)
    assert dcfg.lamp.kq.rule == "none" and dcfg.lamp.kq.mu == cfg.lamp.kq.mu
    off = cfg.replace(lamp=cfg.lamp.replace(kq=cfg.lamp.kq.replace(enabled=False)))
    assert draft_model_config(off) is off
    assert draft_model_config(dcfg) is dcfg


def test_rollback_frees_tail_and_copies_shared_tail():
    cfg = reduced(get_config("gpt2"))
    pool = PagedKVPool(cfg, n_blocks=12, block_size=4, device="cpu",
                       enable_prefix_cache=True)
    pool.k.normal_()
    ids = pool.alloc(4)                   # 16 positions
    # rolled back to 6 tokens: blocks 3 and 4 freed, block 2 kept
    free0 = pool.num_free
    kept = pool.rollback(ids, 6)
    assert kept == ids[:2] and pool.num_free == free0 + 2
    assert pool.cow_copies == 0
    # a second owner shares the partially filled tail: rollback copies it
    pool.share([kept[1]])
    before = pool.k[:, kept[1]].clone()
    kept2 = pool.rollback(kept, 5)
    assert kept2[0] == kept[0] and kept2[1] != kept[1]
    assert pool.cow_copies == 1
    assert torch.equal(pool.k[:, kept2[1]], before)
    assert pool.refcount[kept[1]] == 1    # the other owner keeps its block
    # a full tail needs no copy; asking for more blocks than owned raises
    assert pool.rollback(kept2, 8) == kept2 and pool.cow_copies == 1
    with pytest.raises(ValueError, match="needs 3 blocks"):
        pool.rollback(kept2, 9)


# ----------------------------------------------------------------- engine

_BASE = dict(block_size=4, max_model_len=64, max_prefill_batch=4,
             max_decode_batch=8, max_prefill_tokens=16, prefix_cache=True,
             chunked_prefill=True)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(jax_get_config("gpt2")).replace(vocab=128)
    cfg = reduced(get_config("gpt2")).replace(vocab=128)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, tparams


def _stream(vocab, n=6, seed=21):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=9).tolist()
    reqs = []
    for i in range(n):
        prompt = (shared if i % 2 else []) + \
            rng.integers(0, vocab, size=int(rng.integers(3, 20))).tolist()
        reqs.append((prompt, int(rng.integers(2, 10)), i))
    return reqs


def _run(cfg, params, reqs, **ekw):
    eng = LampEngine(cfg, params, EngineConfig(device="cpu", **dict(_BASE, **ekw)))
    for i, (prompt, n_new, seed) in enumerate(reqs):
        sp = (n_new if isinstance(n_new, SamplingParams)
              else SamplingParams(max_new_tokens=n_new, seed=seed))
        eng.add_request(prompt, sp, arrival_time=float(i))
    outs = {o.req_id: o for o in eng.run_to_completion()}
    assert eng.pool.num_used == 0, "leaked KV blocks"
    return eng, outs


@pytest.mark.parametrize("n_blocks", [0, 20])     # auto-sized / tight pool
def test_spec_engine_replays_jax_plan_stream(model, n_blocks):
    """The tight pool sheds draft budgets and preempts: the port must
    follow the JAX spec engine plan for plan and emit its tokens."""
    jcfg, cfg, jparams, tparams = model
    reqs = _stream(cfg.vocab)
    base = dict(_BASE, n_blocks=n_blocks, speculative=True, draft_len=3)
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(
        fused_step=True, kernel="gather", **base))
    trace = record_plans(jeng)
    for i, (prompt, n_new, seed) in enumerate(reqs):
        jeng.add_request(prompt, JaxSamplingParams(max_new_tokens=n_new,
                                                   seed=seed),
                         arrival_time=float(i))
    jouts = {o.req_id: o for o in jeng.run_to_completion()}

    teng = LampEngine(cfg, tparams, EngineConfig(device="cpu", **base))
    seen = check_replay(teng, trace)
    for i, (prompt, n_new, seed) in enumerate(reqs):
        teng.add_request(prompt, SamplingParams(max_new_tokens=n_new,
                                                seed=seed),
                         arrival_time=float(i))
    touts = {o.req_id: o for o in teng.run_to_completion()}
    assert seen == trace
    assert any(r is not None and any(r.draft_lens) for r in trace)
    for rid, jo in jouts.items():
        to = touts[rid]
        assert to.tokens == jo.tokens, rid
        assert (to.spec_drafted, to.spec_accepted) == (jo.spec_drafted,
                                                       jo.spec_accepted)
        assert to.num_preemptions == jo.num_preemptions
    js, ts = jeng.stats(), teng.stats()
    for key in ("steps", "mixed_steps", "decode_steps", "spec_rounds",
                "spec_drafted_tokens", "spec_accepted_tokens",
                "spec_tokens_per_round", "preemptions", "cow_copies",
                "cached_tokens", "blocks_allocated"):
        assert ts[key] == js[key], key
    assert ts["launches_by_fn"]["draft"] == ts["spec_rounds"] > 0
    if n_blocks:
        assert ts["preemptions"] > 0


def test_spec_engine_greedy_identity_fused_and_split(model):
    """Greedy spec-on equals spec-off, and the split twin equals the fused
    step token for token, with the launch kinds each path must use."""
    _, cfg, _, tparams = model
    reqs = _stream(cfg.vocab, seed=22)
    off_e, off = _run(cfg, tparams, reqs, max_prefill_tokens=8)
    launches = (PA.paged_mixed_attention.launches,
                PA.paged_decode_attention.launches)
    fused_e, fused = _run(cfg, tparams, reqs, max_prefill_tokens=8,
                          speculative=True, draft_len=3)
    split_e, split = _run(cfg, tparams, reqs, max_prefill_tokens=8,
                          speculative=True, draft_len=3, mixed_exec="split")
    assert launches == (PA.paged_mixed_attention.launches,
                        PA.paged_decode_attention.launches)   # CPU: plain
    for i in off:
        assert fused[i].tokens == off[i].tokens == split[i].tokens, i
        assert (fused[i].spec_drafted, fused[i].spec_accepted) == \
            (split[i].spec_drafted, split[i].spec_accepted)
        assert 0.0 <= fused[i].spec_acceptance_rate <= 1.0
    fs, ss = fused_e.stats(), split_e.stats()
    assert fs["spec_rounds"] == ss["spec_rounds"] > 0
    assert fs["spec_tokens_per_round"] > 1.0 and fs["verify_recompute_rate"] > 0
    assert fused_e.decode_steps < off_e.decode_steps
    assert set(k for k, v in fs["launches_by_fn"].items() if v) == \
        {"mixed", "draft"}
    assert ss["launches_by_fn"]["mixed"] == 0
    assert min(ss["launches_by_fn"][k] for k in ("prefill", "draft",
                                                 "verify")) > 0
    assert off_e.stats()["spec_rounds"] == 0


def test_split_without_speculation_uses_the_decode_step(model):
    _, cfg, _, tparams = model
    reqs = _stream(cfg.vocab, n=4, seed=23)
    _, fused = _run(cfg, tparams, reqs)
    split_e, split = _run(cfg, tparams, reqs, mixed_exec="split")
    assert all(fused[i].tokens == split[i].tokens for i in fused)
    assert split_e.stats()["launches_by_fn"]["decode"] > 0


def test_spec_engine_sampled_streams(model):
    """Temperature / top-k rows: full lengths, sane telemetry, and the
    split twin draws the same tokens (every draw is keyed per row)."""
    _, cfg, _, tparams = model
    rng = np.random.default_rng(24)
    reqs = [(rng.integers(0, cfg.vocab, size=int(rng.integers(3, 16))).tolist(),
             SamplingParams(max_new_tokens=6, seed=i, temperature=0.8,
                            top_k=0 if i % 2 else 16), i) for i in range(5)]
    eng, fused = _run(cfg, tparams, reqs, speculative=True, draft_len=4)
    _, split = _run(cfg, tparams, reqs, speculative=True, draft_len=4,
                    mixed_exec="split")
    for i, (_, sp, _) in enumerate(reqs):
        assert len(fused[i].tokens) == sp.max_new_tokens
        assert all(0 <= t < cfg.vocab for t in fused[i].tokens)
        assert fused[i].tokens == split[i].tokens
    assert eng.stats()["spec_drafted_tokens"] > 0


def test_spec_stop_token_and_token_limit(model):
    """A stop token accepted mid-run ends the request there; a one-token
    request has no draft budget (verify-only rounds)."""
    _, cfg, _, tparams = model
    prompt = list(np.random.default_rng(25).integers(0, cfg.vocab, size=7))
    prompt = [int(t) for t in prompt]
    _, g = _run(cfg, tparams, [(prompt, 8, 0)])
    greedy = g[0].tokens
    stop = greedy[len(greedy) // 2]
    want = greedy[:greedy.index(stop) + 1]
    sp = SamplingParams(max_new_tokens=8, stop_token=stop)
    _, s = _run(cfg, tparams, [(prompt, sp, 0)], speculative=True, draft_len=4)
    assert s[0].tokens == want and s[0].finish_reason == "stop_token"
    eng, one = _run(cfg, tparams, [(prompt, 1, 0)], speculative=True,
                    draft_len=4)
    assert one[0].tokens == greedy[:1] and one[0].spec_drafted == 0
    assert eng.stats()["spec_acceptance_rate"] == 0.0


def test_engine_rejects_bad_spec_configs(model):
    _, cfg, _, tparams = model
    with pytest.raises(ValueError, match="draft_len"):
        LampEngine(cfg, tparams, EngineConfig(device="cpu", speculative=True,
                                              draft_len=0))
    with pytest.raises(ValueError, match="mixed_exec"):
        LampEngine(cfg, tparams, EngineConfig(device="cpu", mixed_exec="both"))
