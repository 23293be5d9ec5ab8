"""Port vs JAX: the rest of the LAMP numerics.

`core/prng.py` (JAX's PRNGKey, split, bits, uniform), `core/numerics.py`
(stochastic rounding and the format helpers), `core/mixed_matmul.py` (the
stochastic tier of `dot_ps`, `matmul_lamp`, `dot_ps_error_bound`,
`lamp_matmul_softmax`) and `core/lamp.py` (`select_rmsnorm`, the kappa
evaluators, `select_activation`, `gelu_criterion`, `recompute_rate`, the
strict rule's `z=`), each against its JAX function on the same numpy
inputs.

Tolerances:
  * keys, bits, uniforms and stochastic rounding: bit-exact (Inf and NaN
    patterns included);
  * stochastic `dot_ps`: bit-exact. At granularity 1 on normal inputs (no
    sum inside a lane). At granularity 0 and 8 the chunk sums are FP32
    matmuls, summed in each backend's own order, so the inputs there are
    multiples of 1/8 in [-2, 2]: every partial sum of 20 of their products
    is exact in FP32 whatever the order, and the test sees the key schedule
    and the rounding alone;
  * `select_rmsnorm` masks: bit-exact, with ties (integer inputs, exact
    sums) and on normal inputs;
  * products, softmax outputs, kappa values and criteria: rtol 2e-5 /
    atol 2e-6 (tests/test_paged_kernel.py:50-65); the FP32 products are
    summed in each backend's order. The softmax kappas where z -> 1: atol
    4 ulp of 1 times 2 max|y| (each backend's softmax is within a few ulp
    of 1 there, and 2 z (1 - z) |y| carries that through 2 |y|);
  * masks of the max-based rules (relaxed, relaxed_ln, none): exact; the
    strict rule: a slack of 1 per softmax row (its normalizer is summed in
    each backend's order, which can move a criterion across tau).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import lamp as JL
from repro.core import mixed_matmul as JM
from repro.core import numerics as JN
from repro_torch.core import lamp as TL
from repro_torch.core import mixed_matmul as TM
from repro_torch.core import numerics as TN
from repro_torch.core import prng

TOL = dict(rtol=2e-5, atol=2e-6)
SEEDS = [0, 7, -3, 2 ** 31 + 5]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are tiny: more torch threads only contend with XLA's
    (and the other test workers') threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _words(k) -> np.ndarray:
    return np.asarray(k).astype(np.int64)


def _wide(seed: int, n: int) -> np.ndarray:
    """Normal values over 60 decades, random bit patterns, and the special
    cases: ties, carries, subnormals, signed zeros, Inf, NaN."""
    rng = np.random.default_rng(seed)
    wide = (rng.standard_normal(n)
            * 10.0 ** rng.integers(-30, 30, n)).astype(np.float32)
    pats = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    special = np.asarray(
        [0x3F800000 + (1 << 15), 0x3F800000 + (3 << 15), 0x3FFFFFFF,
         0x7F7FFFFF, 0xFF7FFFFF, 0x00000001, 0x007FFFFF, 0x807FFFFF,
         0x80000000, 0x00000000, 0x7F800000, 0xFF800000, 0x7FC00000,
         0x7F800001, 0xFFFFFFFF], np.uint32)
    return np.concatenate([wide, pats.view(np.float32),
                           special.view(np.float32)])


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_matches_jax(seed):
    """PRNGKey, split (twice deep), bits and uniform, bit for bit."""
    tk, jk = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _words(jk))
    ts, js = prng.split(tk, 5), jax.random.split(jk, 5)
    np.testing.assert_array_equal(ts.numpy(), _words(js))
    np.testing.assert_array_equal(prng.split(ts[3]).numpy(),
                                  _words(jax.random.split(js[3])))
    for shape in [(), (3, 4, 5)]:
        np.testing.assert_array_equal(
            prng.bits(ts[1], shape).numpy(),
            _words(jax.random.bits(js[1], shape)))
        for minval in (0.0, float(np.finfo(np.float32).tiny)):
            u = prng.uniform(ts[2], shape, minval=minval).numpy()
            ju = jax.random.uniform(js[2], shape, minval=minval)
            np.testing.assert_array_equal(_bits(u), _bits(ju))


@pytest.mark.parametrize("mu", [1, 4, 7, 22])
def test_round_to_mantissa_stochastic_bit_exact(mu):
    x = _wide(mu, 4000)
    for seed, shape in (((0, (-1,)),) if mu < 7 else ((11, (4, -1)),)):
        xs = x[:x.size // 4 * 4].reshape(shape)
        want = JN.round_to_mantissa_stochastic(jnp.asarray(xs), mu,
                                               jax.random.PRNGKey(seed))
        got = TN.round_to_mantissa_stochastic(torch.from_numpy(xs), mu,
                                              prng.PRNGKey(seed))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # the stochastic grid is RNE's: both land on PS(mu) values
    fin = np.isfinite(x)
    assert TN.is_representable(got[torch.from_numpy(
        fin[:xs.size].reshape(xs.shape))], mu).all()


def test_quantize_ps_and_format_helpers_match_jax():
    x = _wide(5, 500)
    for mu in (3, 10, 23):
        np.testing.assert_array_equal(
            _bits(TN.quantize_ps(torch.from_numpy(x), mu).numpy()),
            _bits(JN.quantize_ps(jnp.asarray(x), mu)))
        np.testing.assert_array_equal(
            _bits(TN.quantize_ps(torch.from_numpy(x), mu, stochastic=True,
                                 key=prng.PRNGKey(4)).numpy()),
            _bits(JN.quantize_ps(jnp.asarray(x), mu, stochastic=True,
                                 key=jax.random.PRNGKey(4))))
        # XLA's CPU comparison treats subnormals as zero (so JAX calls
        # every subnormal representable); torch compares them as IEEE
        # values, so there the port's answer is the bit patterns' equality
        sub = (x != 0) & (np.abs(x) < np.finfo(np.float32).tiny)
        rep = TN.is_representable(torch.from_numpy(x), mu).numpy()
        np.testing.assert_array_equal(
            rep[~sub], np.asarray(JN.is_representable(jnp.asarray(x), mu))[~sub])
        rounded = _bits(TN.round_to_mantissa(torch.from_numpy(x), mu).numpy())
        np.testing.assert_array_equal(rep[sub], rounded[sub] == _bits(x)[sub])
        assert TN.unit_roundoff(mu) == JN.unit_roundoff(mu)
        assert TN.effective_mantissa_bits(mu, 0.083) == \
            JN.effective_mantissa_bits(mu, 0.083)
        for k, g in ((64, 1), (64, 8), (64, 0), (100, 7)):
            assert TM.dot_ps_error_bound(k, mu, g) == \
                JM.dot_ps_error_bound(k, mu, g)
    with pytest.raises(ValueError, match="requires a PRNG key"):
        TN.quantize_ps(torch.from_numpy(x), 7, stochastic=True)
    assert TN.PS_FORMATS == JN.PS_FORMATS
    for f in ("bf16", "tf32", "fp32", 5, np.int64(9)):
        assert TN.mu_of(f) == JN.mu_of(f)


@pytest.mark.parametrize("granularity", [0, 1, 8])
def test_stochastic_dot_ps_bit_exact(granularity):
    """Each chunk's sum rounded under key i of split(key, steps); one
    rounding under `key` (PRNGKey(0) when none is given) at granularity 0.
    Inputs: module docstring."""
    rng = np.random.default_rng(granularity)
    if granularity == 1:
        a = rng.standard_normal((2, 5, 20)).astype(np.float32)
        b = rng.standard_normal((2, 20, 6)).astype(np.float32)
    else:
        a = (rng.integers(-16, 17, (2, 5, 20)) / 8).astype(np.float32)
        b = (rng.integers(-16, 17, (2, 20, 6)) / 8).astype(np.float32)
    for mu, seed in ((4, 3),):
        want = JM.dot_ps(jnp.asarray(a), jnp.asarray(b), mu,
                         granularity=granularity, stochastic=True,
                         key=jax.random.PRNGKey(seed))
        got = TM.dot_ps(torch.from_numpy(a), torch.from_numpy(b), mu,
                        granularity=granularity, stochastic=True,
                        key=prng.PRNGKey(seed))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
        rne = TM.dot_ps(torch.from_numpy(a), torch.from_numpy(b), mu,
                        granularity=granularity)
        assert not torch.equal(got, rne)      # the noise does round
    if granularity == 0:
        want = JM.dot_ps(jnp.asarray(a), jnp.asarray(b), 4, granularity=0,
                         stochastic=True)
        got = TM.dot_ps(torch.from_numpy(a), torch.from_numpy(b), 4,
                        granularity=0, stochastic=True)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    else:
        with pytest.raises(ValueError, match="requires key"):
            TM.dot_ps(torch.from_numpy(a), torch.from_numpy(b), 4,
                      granularity=granularity, stochastic=True)


def test_matmul_lamp_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 8, 16)).astype(np.float32)
    b = rng.standard_normal((3, 16, 12)).astype(np.float32)
    mask = rng.random((3, 8, 12)) < 0.3
    for y_low in (None, "given"):
        kw = {}
        if y_low:
            kw = dict(y_low=TM.dot_ps(torch.from_numpy(a),
                                      torch.from_numpy(b), 5))
        got = TM.matmul_lamp(torch.from_numpy(a), torch.from_numpy(b), 5,
                             torch.from_numpy(mask), **kw).numpy()
        want = np.asarray(JM.matmul_lamp(jnp.asarray(a), jnp.asarray(b), 5,
                                         jnp.asarray(mask)))
        # the PS(5) entries (granularity 1) bit-exact, the FP32 ones to TOL
        np.testing.assert_array_equal(_bits(got[~mask]), _bits(want[~mask]))
        np.testing.assert_allclose(got[mask], want[mask], **TOL)


@pytest.mark.parametrize("rule", ["strict", "relaxed", "relaxed_ln", "none"])
def test_lamp_matmul_softmax_matches_jax(rule):
    rng = np.random.default_rng(2)
    a = (rng.standard_normal((2, 16, 32)) * 1.5).astype(np.float32)
    b = (rng.standard_normal((2, 32, 24)) * 1.5).astype(np.float32)
    where = np.arange(24)[None, :] <= np.arange(16)[:, None] + 8
    lengths = where.sum(-1)
    for w in (None, where):
        rl = np.broadcast_to(lengths if w is not None else np.full(16, 24),
                             (2, 16))
        kw = dict(rule=rule, granularity=1)
        jz, jy, jm = JM.lamp_matmul_softmax(
            jnp.asarray(a), jnp.asarray(b), 4, 0.05,
            where=None if w is None else jnp.asarray(w),
            row_lengths=jnp.asarray(rl), **kw)
        tz, ty, tm = TM.lamp_matmul_softmax(
            torch.from_numpy(a), torch.from_numpy(b), 4, 0.05,
            where=None if w is None else torch.from_numpy(w),
            row_lengths=torch.from_numpy(np.ascontiguousarray(rl)), **kw)
        jm, tm = np.asarray(jm), tm.numpy()
        if rule == "strict":
            # slack of 1 a softmax row (module docstring)
            assert np.abs(tm.sum(-1) - jm.sum(-1)).max() <= 1
            assert (tm != jm).sum(-1).max() <= 1
        else:
            np.testing.assert_array_equal(tm, jm)
        assert rule == "none" or 0 < tm.sum() < tm.size
        same = (tm == jm).all(-1)
        np.testing.assert_allclose(tz.numpy()[same], np.asarray(jz)[same],
                                   **TOL)
        np.testing.assert_allclose(ty.numpy()[same], np.asarray(jy)[same],
                                   **TOL)
    with pytest.raises(ValueError, match="unknown rule"):
        TM.lamp_matmul_softmax(torch.from_numpy(a), torch.from_numpy(b), 4,
                               0.1, rule="random")


def test_select_rmsnorm_ties_bit_exact():
    """Integer inputs (exact sums) full of ties in y^2, on either axis and
    across tau, including the select-all fallback."""
    rng = np.random.default_rng(3)
    y = rng.integers(-3, 4, (6, 16)).astype(np.float32)
    y[0] = 2.0                      # every entry tied
    y[1, :8], y[1, 8:] = 1.0, -1.0  # ties across signs
    # eager: a Python tau enters (2 - tau) in double, as in the port
    for tau in (1.9, 1.0, 0.1, 0.0):
        for axis in (-1, 0):
            got = TL.select_rmsnorm(torch.from_numpy(y), tau, axis=axis)
            want = JL.select_rmsnorm(jnp.asarray(y), tau, axis=axis)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_select_rmsnorm_and_kappas_match_jax():
    rng = np.random.default_rng(4)
    y = (rng.standard_normal((8, 64))
         * np.exp(rng.standard_normal((8, 1)))).astype(np.float32)
    jkappas = [jax.jit(jax.vmap(f)) for f in (
        JL.kappa_c_rmsnorm, JL.kappa_1_softmax, JL.kappa_c_softmax)]
    for tau in (1.9, 1.2, 1.05):
        q = TL.select_rmsnorm(torch.from_numpy(y), tau)
        np.testing.assert_array_equal(
            q.numpy(), np.asarray(JL.select_rmsnorm(jnp.asarray(y), tau)))
        want = [np.asarray(jf(jnp.asarray(y), jnp.asarray(q.numpy())))
                for jf in jkappas]
        for i in range(y.shape[0]):
            yi, qi = y[i], q[i].numpy()
            # each backend's softmax is within a few ulp of 1 where z -> 1,
            # and the softmax kappas carry that through 2 |y|: 4 ulp of 1
            # times 2 max|y|
            atol = max(TOL["atol"], 8 * 2 ** -24 * float(np.abs(yi).max()))
            for tf, w in zip((TL.kappa_c_rmsnorm, TL.kappa_1_softmax,
                              TL.kappa_c_softmax), want):
                np.testing.assert_allclose(
                    float(tf(torch.from_numpy(yi), torch.from_numpy(qi))),
                    float(w[i]), rtol=TOL["rtol"], atol=atol)
    # kappa_c of RMSNorm with exactly one entry left out: the single branch
    q1 = np.ones(64, bool)
    q1[5] = False
    np.testing.assert_allclose(
        float(TL.kappa_c_rmsnorm(torch.from_numpy(y[0]), torch.from_numpy(q1))),
        float(JL.kappa_c_rmsnorm(jnp.asarray(y[0]), jnp.asarray(q1))), **TOL)


def test_select_activation_and_gelu_criterion_match_jax():
    """The default derivative (autograd against jax.grad) and a given one;
    no criterion lies within 1e-4 of a tau, so the masks are exact."""
    rng = np.random.default_rng(5)
    y = (rng.standard_normal((4, 50)) * 3).astype(np.float32)
    yt, yj = torch.from_numpy(y), jnp.asarray(y)
    crit = TL.gelu_criterion(yt).numpy()
    np.testing.assert_allclose(crit, np.asarray(JL.gelu_criterion(yj)), **TOL)
    # the exact GELU as JAX writes it (torch's F.gelu cancels where y < 0)
    pairs = ((lambda t: 0.5 * t * torch.special.erfc(-t * float(np.sqrt(
              np.float32(0.5)))), lambda t: jax.nn.gelu(t, approximate=False)),
             (torch.tanh, jnp.tanh),
             (torch.nn.functional.silu, jax.nn.silu))
    for tau in (0.5, 4.0):
        assert np.abs(crit - tau).min() > 1e-4
        for tphi, jphi in pairs[:1] if tau > 1 else pairs:
            np.testing.assert_array_equal(
                TL.select_activation(yt, tau, tphi).numpy(),
                np.asarray(JL.select_activation(yj, tau, jphi)))
        np.testing.assert_array_equal(
            TL.select_activation(yt, tau, torch.tanh,
                                 dphi=lambda t: 1 - torch.tanh(t) ** 2).numpy(),
            np.asarray(JL.select_activation(yj, tau, jnp.tanh,
                                            dphi=lambda t: 1 - jnp.tanh(t) ** 2)))


def test_recompute_rate_and_strict_z_match_jax():
    rng = np.random.default_rng(6)
    y = (rng.standard_normal((3, 10, 12)) * 2).astype(np.float32)
    where = np.arange(12)[None, :] <= np.arange(10)[:, None] + 2
    mask = rng.random((3, 10, 12)) < 0.4
    for w in (None, where):
        got = TL.recompute_rate(torch.from_numpy(mask),
                                None if w is None else torch.from_numpy(w))
        want = JL.recompute_rate(jnp.asarray(mask),
                                 None if w is None else jnp.asarray(w))
        assert float(got) == pytest.approx(float(want), rel=1e-6)
    # z= passes a softmax the caller has: its own, or another one
    z = rng.dirichlet(np.ones(12), (3, 10)).astype(np.float32)
    for zz in (None, z):
        got = TL.select_softmax_strict(
            torch.from_numpy(y), 0.05, where=torch.from_numpy(where),
            z=None if zz is None else torch.from_numpy(zz))
        want = JL.select_softmax_strict(
            jnp.asarray(y), 0.05, where=jnp.asarray(where),
            z=None if zz is None else jnp.asarray(zz))
        assert np.abs(got.numpy().sum(-1)
                      - np.asarray(want).sum(-1)).max() <= (1 if zz is None else 0)
