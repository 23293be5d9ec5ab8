"""Per-row token sampling for the engine (port of
``repro/serving/sampling.py:86``).

Greedy rows (temperature <= 0) take the argmax, the first index among ties,
exactly as the JAX package does. A sampled row draws Gumbel noise from its
own ``torch.Generator``, seeded from (request seed, tokens generated so
far) only, so a request's stream is deterministic whatever the batching,
bucketing or preemption. The bits are not JAX's threefry bits: sampled
streams match the JAX engine's in distribution, not token for token.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_MASK64 = (1 << 64) - 1


def row_seed(seed: int, count: int) -> int:
    """splitmix64 of (seed, count): the per-row generator seed."""
    z = ((int(seed) & 0xFFFFFFFF) << 32 | (int(count) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the logits tied with or above the kth largest (k <= 0: all)."""
    V = logits.shape[-1]
    if k <= 0 or k >= V:
        return logits
    kth = torch.sort(logits, dim=-1).values[..., V - k, None]
    return torch.where(logits >= kth, logits,
                       torch.full_like(logits, float("-inf")))


def sample_rows(logits: torch.Tensor, seeds: Sequence[int],
                counts: Sequence[int], temps: Sequence[float],
                top_k: Optional[Sequence[int]] = None) -> torch.Tensor:
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
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(row_seed(seeds[i], counts[i]))
        u = torch.rand(lg.shape, generator=gen, device=logits.device)
        u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
        gumbel = -torch.log(-torch.log(u))
        out[i] = torch.argmax(lg / max(t, 1e-6) + gumbel)
    return out
