"""Per-row token sampling for the engine (port of
``repro/serving/sampling.py:38-41,54,86,111,122``).

Greedy rows (temperature <= 0) take the argmax, the first index among ties,
exactly as the JAX package does. A sampled row draws Gumbel noise from its
own ``torch.Generator``, seeded from (request seed, tokens generated so
far, salt) only, so a request's stream is deterministic whatever the
batching, bucketing or preemption. The bits are not JAX's threefry bits:
sampled streams match the JAX engine's in distribution, not token for
token.

Salts: speculative decoding draws several independent values per position
(draft proposal, acceptance coin, residual resample); each folds its own
salt into the generator seed, and salt 0 is the plain sampler.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

_MASK64 = (1 << 64) - 1

# generator salts (0 = the plain sampler)
SALT_SAMPLE = 0
SALT_DRAFT = 1
SALT_ACCEPT = 2
SALT_RESIDUAL = 3


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def row_seed(seed: int, count: int, salt: int = SALT_SAMPLE) -> int:
    """splitmix64 of (seed, count), then of the salt unless it is
    SALT_SAMPLE: the per-row generator seed."""
    z = _splitmix64((int(seed) & 0xFFFFFFFF) << 32 | (int(count) & 0xFFFFFFFF))
    if salt != SALT_SAMPLE:
        z = _splitmix64(z ^ int(salt))
    return z & ((1 << 63) - 1)


def _generator(device, seed: int, count: int, salt: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(row_seed(seed, count, salt))
    return gen


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the logits tied with or above the kth largest (k <= 0: all)."""
    V = logits.shape[-1]
    if k <= 0 or k >= V:
        return logits
    kth = torch.sort(logits, dim=-1).values[..., V - k, None]
    return torch.where(logits >= kth, logits,
                       torch.full_like(logits, float("-inf")))


def apply_top_k_rows(logits: torch.Tensor, top_k) -> torch.Tensor:
    """Per-row top-k filter: logits (R, ..., V), top_k (R,) (0 = that row
    unfiltered); a row keeps every logit tied with its kth largest."""
    V = logits.shape[-1]
    top_k = torch.as_tensor(top_k, device=logits.device).long()
    k = torch.clamp(top_k, 1, V).reshape((-1,) + (1,) * (logits.ndim - 1))
    srt = torch.sort(logits, dim=-1).values
    kth = torch.gather(srt, -1, (V - k).expand(logits.shape[:-1] + (1,)))
    filtered = torch.where(logits >= kth, logits,
                           torch.full_like(logits, float("-inf")))
    on = (top_k > 0).reshape(k.shape)
    return torch.where(on, filtered, logits)


def _gumbel(shape, gen: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_rows(logits: torch.Tensor, seeds: Sequence[int],
                counts: Sequence[int], temps: Sequence[float],
                top_k: Optional[Sequence[int]] = None,
                salt: int = SALT_SAMPLE) -> torch.Tensor:
    """logits (R, V) on any device; seeds, counts, temps and top_k are host
    sequences of length R. Returns (R,) int64 token ids on logits' device."""
    out = torch.argmax(logits, dim=-1)
    for i in range(logits.shape[0]):
        t = float(temps[i])
        if t <= 0:
            continue
        lg = logits[i].float()
        if top_k is not None:
            lg = apply_top_k(lg, int(top_k[i]))
        gen = _generator(logits.device, seeds[i], counts[i], salt)
        out[i] = torch.argmax(lg / max(t, 1e-6)
                              + _gumbel(lg.shape, gen, logits.device))
    return out


def row_uniforms(seeds: Sequence[int], counts, salt: int,
                 device="cpu") -> torch.Tensor:
    """One uniform draw per (row, count), keyed on (seed, count, salt): the
    speculative acceptance coins. counts: (R,) or (R, k) host integers."""
    counts = np.asarray(counts)
    out = torch.empty(counts.shape, dtype=torch.float32)
    for idx in np.ndindex(*counts.shape):
        gen = _generator("cpu", seeds[idx[0]], int(counts[idx]), salt)
        out[idx] = torch.rand((), generator=gen)
    return out.to(device)


def row_gumbel(seeds: Sequence[int], counts: Sequence[int], salt: int,
               shape, device="cpu") -> torch.Tensor:
    """One Gumbel tensor of `shape` per row, keyed on (seed, count, salt):
    the speculative residual resample. Returns (R, *shape)."""
    return torch.stack([
        _gumbel(shape, _generator(device, s, int(c), salt), device)
        for s, c in zip(seeds, counts)])
