"""Bit-exact PS(mu) rounding (port of ``repro/core/numerics.py``).

PS(mu) = sign (1) + exponent (8) + mantissa (mu in 1..23) bits; PS(23) ==
FP32, PS(10) == TF32, PS(7) == BF16. A PS(mu) value is an FP32 number whose
trailing (23 - mu) mantissa bits are zero, produced by round-to-nearest,
ties-to-even on the FP32 bit pattern.

PyTorch's CPU kernels for uint32 are sparse, so the bit pattern is read
through an int32 view and the arithmetic runs in int64, where the unsigned
32-bit value fits without wrapping. The CUDA kernels carry the same
function as a ``__device__`` helper (``kernels/csrc/paged_attention.cu``).

Stochastic rounding (SR) adds random bits below the kept mantissa and
truncates: the noise is JAX's ``randint(key, shape, 0, 2^shift, uint32)``,
which is ``bits(split(key)[1], shape)`` masked to its low `shift` bits
(``core/prng.py``), so SR equals the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import prng

_F32_MANT_BITS = 23
_EXP_MASK = 0x7F800000
_U32 = 0xFFFFFFFF


def check_mu(mu) -> None:
    """A kernel's static mantissa width: an int >= 1 (mu >= 23 keeps FP32,
    as in the JAX kernels). The CUDA kernels take it unchecked."""
    if not isinstance(mu, int) or mu < 1:
        raise ValueError(f"mu must be an int >= 1, got {mu!r}")


def round_to_mantissa(x: torch.Tensor, mu: int) -> torch.Tensor:
    """Round FP32 `x` to `mu` mantissa bits with round-to-nearest-ties-to-even.

    Carries out of the mantissa pass into the exponent (overflow to Inf,
    subnormal -> smallest normal); Inf and NaN pass through unchanged.
    """
    if not isinstance(mu, int):
        raise TypeError(f"mu must be a static int, got {type(mu)}")
    if not 1 <= mu <= 23:
        raise ValueError(f"mu must be in [1, 23], got {mu}")
    x = torch.as_tensor(x, dtype=torch.float32)
    if mu == _F32_MANT_BITS:
        return x
    shift = _F32_MANT_BITS - mu
    bits = _bits_of(x)
    rem = bits & ((1 << shift) - 1)
    half = 1 << (shift - 1)
    lsb = (bits >> shift) & 1
    round_up = (rem > half) | ((rem == half) & (lsb == 1))
    rounded = (bits & (~((1 << shift) - 1) & _U32)) + round_up.to(torch.int64) * (1 << shift)
    return _float_of(torch.where((bits & _EXP_MASK) == _EXP_MASK, bits, rounded))


def _bits_of(x: torch.Tensor) -> torch.Tensor:
    """The FP32 bit patterns of x as int64 values in [0, 2^32)."""
    return x.contiguous().view(torch.int32).to(torch.int64) & _U32


def _float_of(bits: torch.Tensor) -> torch.Tensor:
    """FP32 values of int64 bit patterns in [0, 2^32)."""
    # back to the signed int32 range before reinterpreting as float32
    bits = torch.where(bits >= (1 << 31), bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def round_to_mantissa_stochastic(x: torch.Tensor, mu: int,
                                 key: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding of FP32 `x` to `mu` mantissa bits: uniform random
    bits below the kept mantissa are added, then truncated, so P(round up)
    is the dropped fraction. `key` is a ``prng`` key (JAX's key words);
    Inf and NaN pass through unchanged."""
    if not 1 <= mu <= 23:
        raise ValueError(f"mu must be in [1, 23], got {mu}")
    x = torch.as_tensor(x, dtype=torch.float32)
    if mu == _F32_MANT_BITS:
        return x
    shift = _F32_MANT_BITS - mu
    bits = _bits_of(x)
    key = torch.as_tensor(key, device=x.device)
    noise = prng.bits(prng.split(key)[1], x.shape) & ((1 << shift) - 1)
    rounded = (bits + noise) & (~((1 << shift) - 1) & _U32)
    return _float_of(torch.where((bits & _EXP_MASK) == _EXP_MASK, bits, rounded))


def unit_roundoff(mu: int) -> float:
    """Unit round-off u = 2^-(mu+1) of PS(mu) under RNE."""
    return 2.0 ** -(mu + 1)


def quantize_ps(x: torch.Tensor, mu: int, *, stochastic: bool = False,
                key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize to the PS(mu) representable set (RNE by default)."""
    if stochastic:
        if key is None:
            raise ValueError("stochastic rounding requires a PRNG key")
        return round_to_mantissa_stochastic(x, mu, key)
    return round_to_mantissa(x, mu)


def is_representable(x: torch.Tensor, mu: int) -> torch.Tensor:
    """True where `x` is exactly representable in PS(mu)."""
    return round_to_mantissa(x, mu) == torch.as_tensor(x, dtype=torch.float32)


def effective_mantissa_bits(mu: int, recompute_rate: float,
                            high_mu: int = 23) -> float:
    """Average mantissa bits per inner product (the paper's footnote 3):
    the low-precision pass for every product plus the FP32 recompute of the
    selected fraction, e.g. mu 7 at rate 0.083 -> 7 + 0.083 * 23 = 8.909."""
    return 1.0 * mu + recompute_rate * high_mu


# Named formats (the paper's Sec. 4.1).
PS_FORMATS = {
    "fp32": 23,
    "tf32": 10,
    "bf16": 7,
}


def mu_of(format_or_mu) -> int:
    """Accept 'bf16' / 'tf32' / 'fp32' / int mu."""
    if isinstance(format_or_mu, str):
        return PS_FORMATS[format_or_mu]
    return int(format_or_mu)
