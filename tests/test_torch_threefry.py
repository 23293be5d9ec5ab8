"""Port vs JAX: the sampler's random bits (serving/sampling.py).

The port hashes JAX's keys and bits itself: `row_key` is
``fold_in(PRNGKey(seed), count)`` (then the salt), `threefry2x32` the
20-round hash, the bits JAX's partitionable layout, uniforms and Gumbel
noise as ``jax.random.uniform`` / ``gumbel`` build them. Checked here
against `jax.random` and `repro.serving.sampling` at several seeds
(negative and above 2^31 included), counts, salts and shapes (50257, GPT-2's
vocabulary, included); then `sample_rows`, `row_uniforms`, `row_gumbel`;
then sampled engine streams (temperature 0.8, top-k 50) against the JAX
engine's on one plan stream (tests/plan_replay.py): fused, speculative
fused and speculative split.

Tolerances: keys, bits and uniforms bit-exact. Gumbel values: torch's and
XLA's float32 `log` each differ from the correctly rounded log by at most
one ulp, and here from each other by at most 2 ulp (checked on each of the
two logs). The outer log of ``-log(-log(u))`` is ill-conditioned where
``a = -log(u)`` is near 1 (its result near 0), so the composite is held to
2 ulp of the result plus the inner log's 2 ulp carried through the outer
(``2 ulp(a) / a``); about 2.5% of the values at V = 50257 need that second
term, none exceeds 0.6 of the bound. Tokens exact: a sampled token that
differed would have to sit on a near-tie of logit / t + noise (an
absolute difference of ~1e-6), and none does at these seeds.
"""

import inspect

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
from repro_torch.configs import get_config, reduced
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import EngineConfig, LampEngine, SamplingParams
from repro_torch.serving import sampling as SM
from repro_torch.serving import speculative as SP

SEEDS = [0, 7, -3, -2 ** 31, 2 ** 31 + 5, 2 ** 32 + 9]
COUNTS = [0, 1, 77, 2 ** 31 - 1]
TINY = np.finfo(np.float32).tiny


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _jax_draws(seeds, counts, salt, shape):
    """(uniform, uniform from TINY, gumbel) of `row_key(seed, count, salt)`
    per row, from one jitted vmap."""
    def one(s, c):
        k = JSM.row_key(s, c, salt)
        return (jax.random.uniform(k, shape),
                jax.random.uniform(k, shape, minval=TINY),
                jax.random.gumbel(k, shape))
    out = jax.jit(jax.vmap(one))(jnp.asarray(seeds, jnp.int32),
                                 jnp.asarray(counts, jnp.int32))
    return [np.asarray(o) for o in out]


def _ulps(a, b):
    return np.abs(_bits(a).astype(np.int64) - _bits(b).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_row_key_matches_jax(seed):
    for count in COUNTS:
        for salt in (JSM.SALT_SAMPLE, JSM.SALT_DRAFT, JSM.SALT_ACCEPT,
                     JSM.SALT_RESIDUAL):
            want = np.asarray(jax.random.key_data(JSM.row_key(seed, count,
                                                              salt)))
            got = SM.row_key(seed, count, salt)
            assert [int(w) for w in got] == [int(w) for w in want]
    # vectorized over rows: the keys of each element
    counts = np.asarray(COUNTS)
    k0, k1 = SM.row_key(seed, counts, JSM.SALT_ACCEPT)
    for i, c in enumerate(COUNTS):
        assert (int(k0[i]), int(k1[i])) == tuple(SM.row_key(seed, c, 2))


def test_threefry2x32_matches_jax_hash():
    """The hash itself, on random keys and counter words, in numpy and in
    torch's int64 words."""
    from jax._src import prng
    rng = np.random.default_rng(0)
    key = rng.integers(0, 2 ** 32, size=2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2 ** 32, size=(2, 301),
                     dtype=np.uint64).astype(np.uint32)
    y = prng.threefry2x32_p.bind(jnp.uint32(key[0]), jnp.uint32(key[1]),
                                 jnp.asarray(x[0]), jnp.asarray(x[1]))
    got = SM.threefry2x32(key[0], key[1], x[0], x[1])
    tt = [torch.from_numpy(a.astype(np.int64))
          for a in (key[0:1], key[1:2], x[0], x[1])]
    got_t = SM.threefry2x32(*tt)
    for g, gt, w in zip(got, got_t, y):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(gt.numpy(),
                                      np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("shape", [(), (7,), (3, 5), (50257,)])
def test_uniform_and_gumbel_match_jax(shape):
    seeds = np.asarray([0, 5, -7, 2 ** 31 - 1])
    counts = np.asarray([0, 3, 9, 100000])
    for salt in (JSM.SALT_SAMPLE, JSM.SALT_RESIDUAL):
        ju, jut, jg = _jax_draws(seeds, counts, salt, shape)
        u = SM.row_uniform(seeds, counts, salt, shape).numpy()
        np.testing.assert_array_equal(_bits(u), _bits(ju))
        ut = SM.row_uniform(seeds, counts, salt, shape, minval=TINY).numpy()
        np.testing.assert_array_equal(_bits(ut), _bits(jut))
        # Gumbel: each log within 2 ulp of XLA's, the composite within the
        # bound of the docstring
        ja = -np.asarray(jnp.log(jut))
        a = -torch.log(torch.from_numpy(ut)).numpy()
        assert _ulps(a, ja).max() <= 2
        outer = -torch.log(torch.from_numpy(ja)).numpy()
        assert _ulps(outer, -np.asarray(jnp.log(ja))).max() <= 2
        g = SM.row_gumbel(seeds, counts, salt, shape).numpy()
        bound = 2 * np.spacing(np.abs(jg)) + 2 * np.spacing(ja) / ja
        assert (np.abs(g - jg) <= bound).all()
        assert np.isfinite(g).all()


def test_row_uniforms_and_row_gumbel_match_jax():
    seeds = np.asarray([3, -4, 2 ** 31 - 2], np.int64)
    counts2 = np.asarray([[0, 1, 2], [5, 6, 7], [2 ** 20, 1, 1]], np.int64)
    u = SM.row_uniforms(seeds, counts2, SM.SALT_ACCEPT).numpy()
    ju = JSM.row_uniforms(jnp.asarray(seeds, jnp.int32),
                          jnp.asarray(counts2, jnp.int32), JSM.SALT_ACCEPT)
    np.testing.assert_array_equal(_bits(u), _bits(ju))
    u1 = SM.row_uniforms(seeds, counts2[:, 0], SM.SALT_ACCEPT).numpy()
    np.testing.assert_array_equal(_bits(u1), _bits(ju)[:, 0])
    g = SM.row_gumbel(seeds, counts2[:, 1], SM.SALT_RESIDUAL, (11,)).numpy()
    jg = JSM.row_gumbel(jnp.asarray(seeds, jnp.int32),
                        jnp.asarray(counts2[:, 1], jnp.int32),
                        JSM.SALT_RESIDUAL, (11,))
    np.testing.assert_allclose(g, np.asarray(jg), rtol=0, atol=2e-6)


@pytest.mark.parametrize("top_k", [None, 50])
def test_sample_rows_matches_jax(top_k):
    """Greedy and sampled rows mixed, GPT-2's vocabulary, two salts."""
    rng = np.random.default_rng(11)
    R, V = 6, 50257
    logits = (rng.standard_normal((R, V)) * 3).astype(np.float32)
    seeds = np.asarray([0, 1, -9, 2 ** 31 - 1, 4, 5])
    counts = np.asarray([0, 7, 3, 100, 1, 2])
    temps = np.asarray([0.8, 0.0, 1.3, 0.8, 1e-7, 0.5], np.float32)
    tk = None if top_k is None else np.asarray([top_k, 0, top_k, 5, top_k, 1])
    for salt in (SM.SALT_SAMPLE, SM.SALT_DRAFT):
        got = SM.sample_rows(torch.from_numpy(logits), seeds, counts, temps,
                             tk, salt=salt).numpy()
        want = jax.jit(JSM.sample_rows, static_argnames="salt")(
            jnp.asarray(logits), jnp.asarray(seeds, jnp.int32),
            jnp.asarray(counts, jnp.int32), jnp.asarray(temps),
            None if tk is None else jnp.asarray(tk, jnp.int32), salt=salt)
        np.testing.assert_array_equal(got, np.asarray(want))
        assert got[1] == np.argmax(logits[1])


def test_no_torch_generator_left():
    """Sampling and speculation draw only keyed threefry noise."""
    for mod in (SM, SP):
        assert "Generator" not in inspect.getsource(mod)


_BASE = dict(block_size=4, max_model_len=64, max_prefill_batch=4,
             max_decode_batch=16, max_prefill_tokens=24, prefix_cache=True,
             chunked_prefill=True)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(jax_get_config("gpt2"))
    cfg = reduced(get_config("gpt2"))
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, tparams


def _requests(vocab, n=4, seed=8):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(4, 16))).tolist(),
             int(rng.integers(5, 8)), 100 + 7 * i) for i in range(n)]


def _jax_run(model, reqs, spec, extra):
    jcfg, _, jparams, _ = model
    jeng = JaxEngine(jcfg, jparams, JaxEngineConfig(
        fused_step=True, kernel="gather", **_BASE, **extra))
    trace = record_plans(jeng)
    for i, (prompt, n_new, seed) in enumerate(reqs):
        jeng.add_request(prompt, JaxSamplingParams(
            max_new_tokens=n_new, seed=seed, temperature=0.8,
            top_k=50 if i % 2 else 0), arrival_time=float(i))
    jouts = {o.req_id: o for o in jeng.run_to_completion()}
    _JAX_RUNS[spec] = trace, jouts
    return trace, jouts


# the JAX engine's run per speculation setting, shared by the fused and
# split replays
_JAX_RUNS = {}


@pytest.mark.parametrize("spec,mixed_exec", [(False, "fused"), (True, "fused"),
                                             (True, "split")])
def test_sampled_engine_streams_match_jax(model, spec, mixed_exec):
    """temperature 0.8, top-k 50 on half the requests: the port replays the
    JAX engine's plans and emits its tokens, token for token."""
    _, cfg, _, tparams = model
    reqs = _requests(cfg.vocab)
    extra = dict(speculative=True, draft_len=3) if spec else {}
    trace, jouts = _JAX_RUNS.get(spec) or _jax_run(model, reqs, spec, extra)
    teng = LampEngine(cfg, tparams, EngineConfig(
        device="cpu", mixed_exec=mixed_exec, **_BASE, **extra))
    seen = check_replay(teng, trace)
    for i, (prompt, n_new, seed) in enumerate(reqs):
        teng.add_request(prompt, SamplingParams(
            max_new_tokens=n_new, seed=seed, temperature=0.8,
            top_k=50 if i % 2 else 0), arrival_time=float(i))
    touts = {o.req_id: o for o in teng.run_to_completion()}
    assert seen == trace
    assert touts.keys() == jouts.keys() == set(range(len(reqs)))
    for rid, jo in jouts.items():
        assert touts[rid].tokens == jo.tokens, rid
        assert touts[rid].spec_accepted == jo.spec_accepted, rid
    if spec:
        assert teng.stats()["spec_drafted_tokens"] > 0
