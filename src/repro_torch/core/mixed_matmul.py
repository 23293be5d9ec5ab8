"""Simulated PS(mu) matrix products (port of ``repro/core/mixed_matmul.py``).

``granularity`` selects the simulation tier:

  1   per-step rounding: ``c = round(c + a_k * b_k)``, the product and the sum
      each rounded to FP32 first (paper-faithful);
  g   FP32 accumulation inside K-chunks of g lanes, the running sum re-rounded
      after each chunk;
  0   one FP32 product, one final rounding (cast-only).

At granularity 1 the rounding points are fixed, so the result is bit-exact
against the JAX package. The stochastic tier rounds each chunk's sum with
``round_to_mantissa_stochastic`` under key i of ``split(key, steps)``, as
the JAX package's scan does (one rounding under `key`, or ``PRNGKey(0)``,
at granularity 0 or g >= K). At granularity 0 (and g > 1) the FP32 sum inside a
chunk is taken in whatever order the backend's matmul uses.

``slab_sums`` is the g > 1 tier with the order inside a chunk spelled out
(lane by lane, k ascending): the order of the port's CUDA kernels, and so
the plain version that they are held against.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import lamp as L
from . import prng
from .numerics import round_to_mantissa, round_to_mantissa_stochastic, \
    unit_roundoff


def _round(c: torch.Tensor, mu: int, key) -> torch.Tensor:
    if key is not None:
        return round_to_mantissa_stochastic(c, mu, key)
    return round_to_mantissa(c, mu)


def dot_ps(a: torch.Tensor, b: torch.Tensor, mu: int, *,
           granularity: int = 1, stochastic: bool = False,
           key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched a @ b with simulated PS(mu) accumulation.
    a: (..., M, K), b: (..., K, N) -> (..., M, N) float32. `stochastic`
    rounds stochastically under the ``prng`` key `key`."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32)
    K = a.shape[-1]
    if b.shape[-2] != K:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if mu >= 23:
        return torch.matmul(a, b)
    if granularity == 0 or granularity >= K:
        if stochastic and key is None:
            key = prng.PRNGKey(0, a.device)
        return _round(torch.matmul(a, b), mu, key if stochastic else None)
    g = int(granularity)
    keys = [None] * -(-K // g)
    if stochastic:
        if key is None:
            raise ValueError("stochastic dot_ps requires key")
        keys = prng.split(torch.as_tensor(key, device=a.device), len(keys))
    acc = 0.0
    for i, s in enumerate(range(0, K, g)):
        if g == 1:
            # one lane: the exact FP32 product, as a K=1 matmul gives it
            part = a[..., :, s:s + 1] * b[..., s:s + 1, :]
        else:
            part = torch.matmul(a[..., s:s + g], b[..., s:s + g, :])
        acc = _round(acc + part, mu, keys[i])
    return acc


def matmul_lamp(a: torch.Tensor, b: torch.Tensor, mu: int, mask: torch.Tensor,
                *, granularity: int = 1,
                y_low: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LAMP refinement: the PS(mu)-accumulated a @ b with the entries flagged
    in `mask` taken from the exact FP32 product (the paper's Sec 2.2.2).
    `y_low` passes a low-precision product already computed (the LAMP
    workflow selects `mask` from it first). The simulation computes the
    whole FP32 product and selects, which is numerically identical to
    recomputing the flagged entries alone."""
    if y_low is None:
        y_low = dot_ps(a, b, mu, granularity=granularity)
    y_exact = torch.matmul(torch.as_tensor(a, dtype=torch.float32),
                           torch.as_tensor(b, dtype=torch.float32))
    return torch.where(mask, y_exact, y_low)


def dot_ps_error_bound(k: int, mu: int, granularity: int = 1) -> float:
    """First-order worst-case relative error coefficient c_g * u of a
    length-k inner product (Higham 2002): about ceil(k / g) * u."""
    g = max(int(granularity), 1) if granularity else k
    return -(-k // g) * unit_roundoff(mu)


def lamp_matmul_softmax(a: torch.Tensor, b: torch.Tensor, mu: int, tau: float,
                        *, rule: str = "strict", granularity: int = 1,
                        where: Optional[torch.Tensor] = None,
                        row_lengths: Optional[torch.Tensor] = None,
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LAMP evaluation of softmax(a @ b) (the paper's Algorithm 1 with
    g = matmul, f = softmax). Returns (z, y, mask): the probabilities of the
    adaptively refined logits, those logits, and the recompute mask."""
    y_low = dot_ps(a, b, mu, granularity=granularity)
    if rule == "strict":
        mask = L.select_softmax_strict(y_low, tau, where=where)
    elif rule == "relaxed":
        mask = L.select_softmax_relaxed(y_low, tau, where=where)
    elif rule == "relaxed_ln":
        if row_lengths is None:
            raise ValueError("relaxed_ln needs row_lengths")
        mask = L.select_softmax_relaxed_ln(y_low, tau, row_lengths, where=where)
    elif rule == "none":
        mask = torch.zeros(y_low.shape, dtype=torch.bool, device=y_low.device)
    else:
        raise ValueError(f"unknown rule {rule!r}")
    y = matmul_lamp(a, b, mu, mask, granularity=granularity, y_low=y_low)
    return L.masked_softmax(y, where), y, mask


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
