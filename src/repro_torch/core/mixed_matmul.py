"""Simulated PS(mu) matrix products (port of ``repro/core/mixed_matmul.py:41``).

``granularity`` selects the simulation tier:

  1   per-step rounding: ``c = round(c + a_k * b_k)``, the product and the sum
      each rounded to FP32 first (paper-faithful);
  g   FP32 accumulation inside K-chunks of g lanes, the running sum re-rounded
      after each chunk;
  0   one FP32 product, one final rounding (cast-only).

At granularity 1 the rounding points are fixed, so the result is bit-exact
against the JAX package. At granularity 0 (and g > 1) the FP32 sum inside a
chunk is taken in whatever order the backend's matmul uses.

``slab_sums`` is the g > 1 tier with the order inside a chunk spelled out
(lane by lane, k ascending): the order of the port's CUDA kernels, and so
the plain version that they are held against.
"""

from __future__ import annotations

import torch

from .numerics import round_to_mantissa


def dot_ps(a: torch.Tensor, b: torch.Tensor, mu: int, *,
           granularity: int = 1) -> torch.Tensor:
    """Batched a @ b with simulated PS(mu) accumulation.
    a: (..., M, K), b: (..., K, N) -> (..., M, N) float32."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32)
    K = a.shape[-1]
    if b.shape[-2] != K:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if mu >= 23:
        return torch.matmul(a, b)
    if granularity == 0 or granularity >= K:
        return round_to_mantissa(torch.matmul(a, b), mu)
    g = int(granularity)
    acc = 0.0
    for s in range(0, K, g):
        if g == 1:
            # one lane: the exact FP32 product, as a K=1 matmul gives it
            part = a[..., :, s:s + 1] * b[..., s:s + 1, :]
        else:
            part = torch.matmul(a[..., s:s + g], b[..., s:s + g, :])
        acc = round_to_mantissa(acc + part, mu)
    return acc


def slab_sums(a: torch.Tensor, b: torch.Tensor, mu: int,
              granularity: int) -> torch.Tensor:
    """Batched (..., M, K) @ (..., K, N) -> (..., M, N) float32 in the CUDA
    kernels' order: inside each slab of `granularity` lanes every product
    and every sum is rounded to FP32, k ascending, from a zero partial; the
    running accumulator is rounded to PS(mu) after each slab is added (not
    at mu >= 23). ps_matmul's plain version, and y_low of the attention
    micro kernels' plain versions (``lamp_device.cuh::dot_low_chunked``
    sums each k_subtile chunk this way)."""
    a = a.float()
    b = b.float()
    K = a.shape[-1]
    if b.shape[-2] != K:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + \
        (a.shape[-2], b.shape[-1])
    acc = torch.zeros(shape, dtype=torch.float32, device=a.device)
    for s in range(0, K, granularity):
        part = torch.zeros_like(acc)
        for k in range(s, min(s + granularity, K)):
            part = part + a[..., :, k:k + 1] * b[..., k:k + 1, :]
        acc = acc + part
        if mu < 23:
            acc = round_to_mantissa(acc, mu)
    return acc
