"""Port vs JAX: the serving engine on the fused step.

The JAX `LampEngine` (`fused_step=True`, `kernel="gather"`, prefix caching
and chunked prefill on) serves a greedy stream with a shared prefix and
records its plan stream (tests/plan_replay.py). The port's engine, on the
same weights (`params_from_jax`) and the same requests, replays under a
checker that fails at the first plan that differs; then every request's
tokens must be identical, and the cache statistics equal.

Tolerance: tokens, plans, valid-product counts and cache statistics are
exact. Per-request selected counts get a slack of 0.1% of the valid
products: q and k reach the PS(mu) rounding with last-bit differences (each
backend sums its FP32 matmuls in its own order), so a y_low on a rounding
boundary may flip a selection now and then.
"""

import numpy as np
import pytest
import torch

import jax

from plan_replay import check_replay, record_plans
from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.models import transformer as JT
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import LampEngine as JaxEngine
from repro.serving import SamplingParams as JaxSamplingParams
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import paged_attention as PA
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import EngineConfig, LampEngine, SamplingParams

_BASE = dict(block_size=4, max_model_len=64, max_prefill_batch=4,
             max_decode_batch=16, max_prefill_tokens=24,
             prefix_cache=True, chunked_prefill=True)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(jax_get_config("gpt2"))
    cfg = reduced(get_config("gpt2"))
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, tparams


def _stream(vocab, n=8, seed=3):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=9).tolist()
    reqs = []
    for i in range(n):
        prompt = (shared if i % 3 == 0 else []) + \
            rng.integers(0, vocab, size=int(rng.integers(4, 30))).tolist()
        reqs.append((prompt, int(rng.integers(6, 12)), i))
    return reqs


@pytest.mark.parametrize("n_blocks", [0, 20])     # auto-sized / tight pool
def test_engine_replays_jax_plan_stream(model, n_blocks):
    """The tight pool forces preemptions: evicted requests resume through
    the prefix cache and must still emit the JAX engine's tokens."""
    jcfg, cfg, jparams, tparams = model
    reqs = _stream(cfg.vocab)
    base = dict(_BASE, n_blocks=n_blocks)
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(
        fused_step=True, kernel="gather", **base))
    trace = record_plans(jeng)
    for i, (prompt, n_new, seed) in enumerate(reqs):
        jeng.add_request(prompt, JaxSamplingParams(max_new_tokens=n_new,
                                                   seed=seed),
                         arrival_time=float(i))
    jouts = {o.req_id: o for o in jeng.run_to_completion()}

    launches = PA.paged_mixed_attention.launches
    teng = LampEngine(cfg, tparams, EngineConfig(device="cpu", **base))
    seen = check_replay(teng, trace)
    for i, (prompt, n_new, seed) in enumerate(reqs):
        teng.add_request(prompt, SamplingParams(max_new_tokens=n_new,
                                                seed=seed),
                         arrival_time=float(i))
    touts = {o.req_id: o for o in teng.run_to_completion()}
    assert PA.paged_mixed_attention.launches == launches   # CPU: plain path

    assert seen == trace
    assert touts.keys() == jouts.keys() == set(range(len(reqs)))
    for rid, jo in jouts.items():
        to = touts[rid]
        assert to.tokens == jo.tokens, rid
        assert to.finish_reason == jo.finish_reason
        assert to.num_cached_tokens == jo.num_cached_tokens
        assert to.num_preemptions == jo.num_preemptions
        assert to.lamp_valid == jo.lamp_valid
        assert abs(to.lamp_selected - jo.lamp_selected) <= 1e-3 * jo.lamp_valid

    js, ts = jeng.stats(), teng.stats()
    for key in ("num_finished", "steps", "mixed_steps", "prefill_steps",
                "decode_steps", "prefill_chunks", "preemptions",
                "blocks_allocated", "blocks_saved", "cached_tokens",
                "resume_cached_tokens", "prefill_tokens_run",
                "cache_hit_rate", "cow_copies", "cache_evictions"):
        assert ts[key] == js[key], key
    assert ts["prefill_chunks"] > 0
    if n_blocks:
        assert ts["preemptions"] > 0
    else:
        assert ts["cached_tokens"] > 0
    assert abs(ts["lamp_recompute_rate"] - js["lamp_recompute_rate"]) < 1e-3


def test_engine_samples_deterministically(model):
    """Sampled streams use per-row torch generators keyed on (seed, count):
    the same request gives the same tokens whatever it is batched with."""
    _, cfg, _, tparams = model
    prompt = list(range(5, 17))
    sp = SamplingParams(max_new_tokens=6, temperature=0.8, top_k=20, seed=7)
    alone = LampEngine(cfg, tparams, EngineConfig(device="cpu", **_BASE))
    alone.add_request(prompt, sp)
    [a] = alone.run_to_completion()
    crowd = LampEngine(cfg, tparams, EngineConfig(device="cpu", **_BASE))
    for i in range(3):
        crowd.add_request(list(range(30 + i, 40 + i)),
                          SamplingParams(max_new_tokens=4, seed=i))
    rid = crowd.add_request(prompt, sp)
    outs = {o.req_id: o for o in crowd.run_to_completion()}
    assert outs[rid].tokens == a.tokens
    assert all(0 <= t < cfg.vocab for t in a.tokens)


def test_engine_rejects_bad_requests(model):
    _, cfg, _, tparams = model
    eng = LampEngine(cfg, tparams, EngineConfig(device="cpu", **_BASE))
    with pytest.raises(ValueError, match="empty"):
        eng.add_request([])
    with pytest.raises(ValueError, match="max_model_len"):
        eng.add_request([1] * 60, SamplingParams(max_new_tokens=8))
    with pytest.raises(ValueError, match="token outside"):
        eng.add_request([cfg.vocab])
