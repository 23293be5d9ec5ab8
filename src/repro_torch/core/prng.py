"""JAX's threefry random numbers, bit for bit, in PyTorch.

The port draws the same random bits as the JAX package wherever the JAX
package draws them: the engine's sampler (``serving/sampling.py``), the
stochastic rounding of ``core/numerics.py`` and the random control arm of
``core/attention.py``. JAX 0.9 with ``jax_threefry_partitionable`` on (its
default) and 64-bit types off builds them as follows.

  * A key is two 32-bit words. ``PRNGKey(seed)`` is (0, seed mod 2^32).
  * ``threefry2x32`` hashes two counter words under a key (20 rounds).
  * ``split(key, n)``: key i is the pair of words hashed from the counter
    (i >> 32, i mod 2^32).
  * ``bits(key, shape)``: element i of the flattened shape hashes the same
    counter, and its 32 bits are the two output words xor-ed.
  * ``uniform(key, shape)`` in [minval, 1): the bits shifted right by 9
    under the exponent of 1.0, bitcast to float32, minus 1, scaled by
    (1 - minval), plus minval, and raised to at least minval.

Keys are int64 tensors of shape (2,) and words are int64 tensors holding
32-bit values (PyTorch's uint32 kernels are sparse); everything is computed
on the key's device. ``threefry2x32`` works on numpy uint32 arrays too,
which the sampler uses to hash its keys on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash of JAX (``jax._src.prng``, 20 rounds) of the
    counter words (x0, x1) under the key (k0, k1). Works on numpy uint32
    arrays and on torch int64 tensors holding 32-bit values (the operands
    broadcast); returns (y0, y1) of the same kind."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _hash_counters(k0, k1, n: int, device):
    """The two threefry words of the counters 0 .. n-1 under (k0, k1),
    which broadcast against the counters' trailing axis."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return threefry2x32(k0, k1, i >> 32, i & _M32)


def _bits(key, n: int, device) -> torch.Tensor:
    """Random bits for a flat shape of n under each of R keys given as two
    host uint32 word arrays (R,): (R, n) int64 on `device`."""
    k0 = torch.from_numpy(key[0].astype(np.int64)).to(device)[:, None]
    k1 = torch.from_numpy(key[1].astype(np.int64)).to(device)[:, None]
    y0, y1 = _hash_counters(k0, k1, n, device)
    return y0 ^ y1


def _uniform(bits: torch.Tensor, minval: float) -> torch.Tensor:
    """``jax.random.uniform`` in [minval, 1) from 32 random bits, float32:
    mantissa bits under the exponent of 1.0, minus 1, scaled, shifted."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, f * (1.0 - lo) + lo)


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: (0, seed mod
    2^32) as an int64 tensor of shape (2,) on `device`."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) int64 keys on key's
    device."""
    y0, y1 = _hash_counters(key[0], key[1], int(num), key.device)
    return torch.stack([y0, y1], dim=-1)


def bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)``: uint32 values in an int64 tensor of
    `shape` on key's device."""
    shape = tuple(shape)
    y0, y1 = _hash_counters(key[0], key[1], math.prod(shape), key.device)
    return (y0 ^ y1).reshape(shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=minval)`` (maxval 1):
    float32 of `shape` on key's device."""
    return _uniform(bits(key, shape), minval)


# XLA's float32 erf_inv (M. Giles' single-precision approximation, as
# ``xla/client/lib/math.cc`` spells it): a degree-8 polynomial in
# w - 2.5 for w = -log(1 - x^2) < 5, else in sqrt(w) - 3
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 erf^-1 by XLA's polynomial (``lax.erf_inv``); +-1 give
    +-Inf. The log1p runs in float64 and rounds once to float32: PyTorch's
    float32 log1p on the CPU differs by an ulp between its vectorized and
    its scalar loop, which split a tensor by the thread count, and near
    x = +-1 erf^-1 turns an ulp of w into 1e-3."""
    w = -torch.log1p((-x * x).double()).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], dtype=x.dtype,
                                            device=x.device),
                           torch.tensor(_ERFINV_GE5[i], dtype=x.dtype,
                                        device=x.device))
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape)``, float32 on key's device: a
    uniform in (nextafter(-1, 0), 1) mapped through sqrt(2) erf^-1."""
    u = uniform(key, shape, float(np.nextafter(np.float32(-1.0),
                                               np.float32(0.0))))
    return torch.tensor(math.sqrt(2), dtype=torch.float32,
                        device=u.device) * erf_inv(u)
