"""Bit-exact PS(mu) rounding (port of ``repro/core/numerics.py``).

PS(mu) = sign (1) + exponent (8) + mantissa (mu in 1..23) bits; PS(23) ==
FP32, PS(10) == TF32, PS(7) == BF16. A PS(mu) value is an FP32 number whose
trailing (23 - mu) mantissa bits are zero, produced by round-to-nearest,
ties-to-even on the FP32 bit pattern.

PyTorch's CPU kernels for uint32 are sparse, so the bit pattern is read
through an int32 view and the arithmetic runs in int64, where the unsigned
32-bit value fits without wrapping. The CUDA kernels carry the same
function as a ``__device__`` helper (``kernels/csrc/paged_attention.cu``).
"""

from __future__ import annotations

import torch

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
    bits = x.contiguous().view(torch.int32).to(torch.int64) & _U32
    rem = bits & ((1 << shift) - 1)
    half = 1 << (shift - 1)
    lsb = (bits >> shift) & 1
    round_up = (rem > half) | ((rem == half) & (lsb == 1))
    rounded = (bits & (~((1 << shift) - 1) & _U32)) + round_up.to(torch.int64) * (1 << shift)
    out = torch.where((bits & _EXP_MASK) == _EXP_MASK, bits, rounded)
    # back to the signed int32 range before reinterpreting as float32
    out = torch.where(out >= (1 << 31), out - (1 << 32), out)
    return out.to(torch.int32).view(torch.float32)
