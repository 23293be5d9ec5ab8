"""Port vs JAX: PS(mu) rounding and the simulated mixed-precision product.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: `round_to_mantissa` is bit-exact (compared on the bit
patterns); `dot_ps` at granularity 1 is bit-exact too, because every
rounding point is fixed (product, sum, round). At granularity 0 and g > 1
the FP32 sum inside a chunk runs in each backend's own order, so a value
may differ by one FP32 ulp before the PS(mu) rounding and land on the other
side of a rounding boundary: those are held to one PS(mu) ulp relative
(2^-mu).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.mixed_matmul import dot_ps as jax_dot_ps
from repro.core.numerics import round_to_mantissa as jax_round
from repro_torch.core.mixed_matmul import dot_ps
from repro_torch.core.numerics import round_to_mantissa


def _special_values(mu: int) -> np.ndarray:
    """Ties, carries into the exponent, subnormals, Inf and NaN."""
    shift = 23 - mu
    one = np.float32(1.0).view(np.uint32)
    bits = [one + (1 << (shift - 1)) if shift else one,              # tie, even
            one + (3 << (shift - 1)) if shift else one,              # tie, odd
            np.float32(1.9999999).view(np.uint32),                   # carry
            np.uint32(0x7F7FFFFF),                                   # -> Inf
            np.uint32(0x00000001), np.uint32(0x007FFFFF),            # subnormal
            np.uint32(0x807FFFFF), np.uint32(0x80000000),
            np.uint32(0x7F800000), np.uint32(0xFF800000),            # +-Inf
            np.uint32(0x7FC00000), np.uint32(0x7F800001)]            # NaNs
    return np.asarray(bits, np.uint32).view(np.float32)


@pytest.mark.parametrize("mu", [1, 5, 7, 10, 22, 23])
def test_round_to_mantissa_bit_exact(mu):
    rng = np.random.default_rng(mu)
    wide = rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)
    with np.errstate(over="ignore", invalid="ignore"):
        wide = wide.astype(np.float32)        # overflow to +-Inf is wanted
    x = np.concatenate([
        wide,
        rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
        .view(np.float32),                                   # every bit pattern
        _special_values(mu)]).astype(np.float32)
    want = np.asarray(jax_round(jnp.asarray(x), mu)).view(np.uint32)
    got = round_to_mantissa(torch.from_numpy(x), mu).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_round_to_mantissa_rejects_bad_mu():
    with pytest.raises(ValueError):
        round_to_mantissa(torch.ones(3), 0)
    with pytest.raises(TypeError):
        round_to_mantissa(torch.ones(3), 7.0)


@pytest.mark.parametrize("granularity", [0, 1, 4])
@pytest.mark.parametrize("mu", [5, 7])
def test_dot_ps_matches_jax(granularity, mu):
    rng = np.random.default_rng(10 * granularity + mu)
    a = (rng.standard_normal((2, 3, 5, 16)) * 1.5).astype(np.float32)
    b = (rng.standard_normal((2, 3, 16, 7)) * 1.5).astype(np.float32)
    want = np.asarray(jax_dot_ps(jnp.asarray(a), jnp.asarray(b), mu,
                                 granularity=granularity))
    got = dot_ps(torch.from_numpy(a), torch.from_numpy(b), mu,
                 granularity=granularity).numpy()
    if granularity == 1:
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -mu, atol=1e-6)
