"""Token sampling: per-row for the engine, and one key for the whole batch
for the static loop (port of ``repro/serving/sampling.py``).

Greedy rows (temperature <= 0) take the argmax, the first index among ties,
exactly as the JAX package does. A sampled row adds Gumbel noise keyed on
(request seed, tokens generated so far, salt) only, so a request's stream
is deterministic whatever the batching, bucketing or preemption, and the
noise is the JAX engine's own:

  * ``row_key`` is ``fold_in(PRNGKey(seed), count)``, then
    ``fold_in(·, salt)`` unless the salt is SALT_SAMPLE: threefry2x32 (20
    rounds, JAX's key schedule) on 32-bit words. Seeds are 32-bit, as the
    JAX engine's int32 seed arrays are (``PRNGKey`` of a seed s is the key
    (0, s mod 2^32) with 64-bit types off).
  * The noise for a shape is JAX's partitionable random bits
    (``jax_threefry_partitionable``, on by default): element i of the
    flattened shape hashes the counter words (i >> 32, i mod 2^32) under
    the row's key, and its 32 bits are the two output words xor-ed.
  * A uniform in [minval, 1) is ``jax.random.uniform``'s: the bits shifted
    right by 9 under the exponent of 1.0, bitcast, minus 1, scaled by
    (1 - minval), plus minval, and raised to at least minval. Gumbel noise
    is ``-log(-log(u))`` with minval the smallest normal float32 (JAX's
    mode "low").

The hash, the bits and the uniforms are ``core/prng.py``'s, shared with
stochastic rounding and the random control arm.

The uniforms are JAX's bit for bit; the Gumbel values are as close as
torch's ``log`` is to XLA's (within 2 ulp). Keys are hashed on the host in
numpy (a few words a row); the noise of all sampled rows is one batched
computation on the logits' device in int64 tensors holding 32-bit words.

``sample`` is the static loop's (``runtime.serve_loop``): one ``core.prng``
key for the whole batch, the top-k filter, then the argmax at temperature
<= 0, else the Gumbel-max draw of ``jax.random.gumbel(key, logits.shape)``
(JAX's bits and uniforms, minval the smallest normal float32).

Salts: speculative decoding draws several independent values per position
(draft proposal, acceptance coin, residual resample); each folds its own
salt into the key, and salt 0 is the plain sampler.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.prng import _M32, _bits, _uniform, threefry2x32, uniform

# key salts (folded after the position counter; 0 = the plain sampler)
SALT_SAMPLE = 0
SALT_DRAFT = 1
SALT_ACCEPT = 2
SALT_RESIDUAL = 3

_TINY = float(np.finfo(np.float32).tiny)


def _words(a) -> np.ndarray:
    """Integers as uint32 words (two's complement, mod 2^32)."""
    return (np.asarray(a, np.int64) & _M32).astype(np.uint32)


def fold_in(key: Tuple[np.ndarray, np.ndarray], data) -> Tuple[np.ndarray,
                                                               np.ndarray]:
    """``jax.random.fold_in`` on keys given as two uint32 word arrays:
    the key hashes the counter words (0, data)."""
    d = _words(data)
    return threefry2x32(key[0], key[1], np.zeros_like(d), d)


def row_key(seed, count, salt: int = SALT_SAMPLE):
    """The engine's per-request keys (JAX ``sampling.row_key``), vectorized:
    ``fold_in(PRNGKey(seed), count)``, then the salt unless it is
    SALT_SAMPLE. seed and count broadcast; returns the keys' two uint32
    words."""
    seed, count = np.broadcast_arrays(np.asarray(seed, np.int64),
                                      np.asarray(count, np.int64))
    k1 = _words(seed.reshape(-1))      # flat: numpy wraps arrays silently
    key = fold_in((np.zeros_like(k1), k1), count.reshape(-1))
    if salt != SALT_SAMPLE:
        key = fold_in(key, np.full(k1.shape, salt))
    return key[0].reshape(seed.shape), key[1].reshape(seed.shape)


def row_uniform(seeds, counts, salt: int, shape, device="cpu",
                minval: float = 0.0) -> torch.Tensor:
    """One ``jax.random.uniform(row_key(seed, count, salt), shape)`` per
    row, minval as JAX's: (R, *shape) float32 on `device`."""
    shape = tuple(shape)
    key = row_key(np.asarray(seeds).reshape(-1), np.asarray(counts).reshape(-1),
                  salt)
    n = int(np.prod(shape, dtype=np.int64))
    return _uniform(_bits(key, n, device), minval).reshape((-1,) + shape)


def row_gumbel(seeds: Sequence[int], counts: Sequence[int], salt: int,
               shape, device="cpu") -> torch.Tensor:
    """One ``jax.random.gumbel(row_key(seed, count, salt), shape)`` per row
    (mode "low"): the speculative residual resample and the sampler's
    noise. Returns (R, *shape) float32 on `device`."""
    u = row_uniform(seeds, counts, salt, shape, device, minval=_TINY)
    return -torch.log(-torch.log(u))


def row_uniforms(seeds: Sequence[int], counts, salt: int,
                 device="cpu") -> torch.Tensor:
    """One uniform draw per (row, count), keyed on (seed, count, salt): the
    speculative acceptance coins (JAX ``row_uniforms``). counts: (R,) or
    (R, k) host integers; returns float32 of counts' shape on `device`.
    A few values: computed on the host and copied once, rather than about
    170 small launches on the device."""
    counts = np.asarray(counts, np.int64)
    seeds = np.asarray(seeds, np.int64).reshape((-1,) + (1,) * (counts.ndim - 1))
    seeds = np.broadcast_to(seeds, counts.shape)
    return row_uniform(seeds, counts, salt, (), "cpu").reshape(
        counts.shape).to(device)


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


def sample_rows(logits: torch.Tensor, seeds: Sequence[int],
                counts: Sequence[int], temps: Sequence[float],
                top_k: Optional[Sequence[int]] = None,
                salt: int = SALT_SAMPLE) -> torch.Tensor:
    """logits (R, V) on any device; seeds, counts, temps and top_k are host
    sequences of length R. Returns (R,) int64 token ids on logits' device:
    greedy rows the argmax (JAX's ``where(t > 0, ..., argmax)`` gives the
    same token, so their noise is not drawn), sampled rows the argmax of
    the (top-k filtered) logits over max(t, 1e-6) plus the row's Gumbel
    noise, as JAX's ``_gumbel_argmax``."""
    out = torch.argmax(logits, dim=-1)
    temps = np.asarray(temps, np.float32)
    rows = np.flatnonzero(temps > 0)
    if rows.size == 0:
        return out
    dev = logits.device
    idx = torch.from_numpy(rows).to(dev)
    lg = logits[idx].float()
    if top_k is not None:
        lg = apply_top_k_rows(lg, np.asarray(top_k)[rows])
    t = torch.from_numpy(np.maximum(temps[rows], np.float32(1e-6))).to(dev)
    g = row_gumbel(np.asarray(seeds)[rows], np.asarray(counts)[rows], salt,
                   (lg.shape[-1],), dev)
    out[idx] = torch.argmax(lg / t[:, None] + g, dim=-1)
    return out


def sample(logits: torch.Tensor, key: torch.Tensor, temperature: float,
           top_k: int = 0) -> torch.Tensor:
    """Single-key batch sampling (the static loop): logits (..., V) float32,
    one ``core.prng`` key on the logits' device, a Python temperature
    (greedy at <= 0). Returns int64 token ids of logits' leading shape."""
    logits = apply_top_k(logits, top_k)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    g = -torch.log(-torch.log(uniform(key, logits.shape, minval=_TINY)))
    return torch.argmax(logits / temperature + g, dim=-1)
