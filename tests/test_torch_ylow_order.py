"""The plain versions of the attention micro kernels sum y_low in the CUDA
kernels' order, bit for bit.

``lamp_device.cuh::dot_low_chunked`` (lamp_attention.cu, flash_decode.cu)
sums q . k in chunks of k_subtile lanes: inside a chunk every product and
every sum is rounded to FP32, k ascending; the running sum is rounded to
PS(mu) once per chunk (not at mu >= 23). ``emulate`` spells that order in
numpy float32, with the kernel's round_to_mantissa (round half to even on
the bits, the carry running into the exponent). The plain versions
(``lamp_flash_attention_plain``, ``flash_decode_plain``) must compute that
same y_low through ``core.mixed_matmul.slab_sums``, and select the keys
that the rule selects on it, so that the kernels are held to them with
exact counts; lamp_flash_attention_plain's y_exact is the same chunks
summed unrounded (``slab_sums`` at mu 23), as the kernel takes it. ps_matmul's plain version sums its slabs the same way.

No JAX here: these are properties of the port alone.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.mixed_matmul import slab_sums
from repro_torch.core.numerics import round_to_mantissa
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import lamp_attention as LA
from repro_torch.kernels import ps_matmul as PM

NEG = np.float32(-1e30)


def round_bits(x: np.ndarray, mu: int) -> np.ndarray:
    """round to nearest, ties to even, on float32 bits: the rule of
    lamp_device.cuh::round_to_mantissa, spelled by comparisons."""
    if mu >= 23:
        return x
    bits = x.astype(np.float32).view(np.uint32)
    shift = 23 - mu
    low = np.uint32((1 << shift) - 1)
    rem = bits & low
    half = np.uint32(1 << (shift - 1))
    lsb = (bits >> np.uint32(shift)) & np.uint32(1)
    up = (rem > half) | ((rem == half) & (lsb == 1))
    out = (bits & ~low) + np.where(up, np.uint32(1 << shift), np.uint32(0))
    special = (bits & np.uint32(0x7F800000)) == np.uint32(0x7F800000)
    return np.where(special, bits, out).astype(np.uint32).view(np.float32)


def emulate(q: np.ndarray, k: np.ndarray, mu: int, g: int) -> np.ndarray:
    """dot_low_chunked for every (query, key) pair: q (..., T, D) and
    k (..., S, D) float32 -> (..., T, S) float32."""
    D = q.shape[-1]
    acc = np.zeros(q.shape[:-1] + (k.shape[-2],), np.float32)
    for s in range(0, D, g):
        part = q[..., :, None, s] * k[..., None, :, s]
        for d in range(s + 1, min(s + g, D)):
            part = part + q[..., :, None, d] * k[..., None, :, d]
        acc = round_bits(acc + part, mu)
    return acc


def spy(monkeypatch, module):
    """Record what `module`'s plain version gets from slab_sums."""
    seen = []

    def recorded(*args, **kw):
        seen.append(slab_sums(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(module, "slab_sums", recorded)
    return seen


def same_bits(x: np.ndarray, y: np.ndarray) -> bool:
    return x.shape == y.shape and np.array_equal(
        x.astype(np.float32).view(np.uint32), y.astype(np.float32).view(np.uint32))


def scaled(q: np.ndarray) -> np.ndarray:
    """q times D^-0.5 in float32, as the kernels scale it."""
    return q * np.float32(q.shape[-1] ** -0.5)


def score(y: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore"):
        return y + np.log(np.abs(y))


CASES = [(mu, sub) for mu in (4, 7, 23) for sub in (1, 5, 32)]


@pytest.mark.parametrize("mu,sub", CASES)
def test_lamp_attention_plain_sums_ylow_in_kernel_order(monkeypatch, mu, sub):
    """D 64 (k_subtile 5 leaves a chunk of 4), T 48 in k-blocks of 16,
    causal and not."""
    rng = np.random.default_rng(100 + 10 * mu + sub)
    B, H, T, D, bk, tau = 1, 2, 48, 64, 16, 0.05
    q, k = (rng.standard_normal((B, H, T, D)).astype(np.float32) * 1.5
            for _ in range(2))
    v = rng.standard_normal((B, H, T, D)).astype(np.float32)
    want = emulate(scaled(q), k, mu, sub)
    for causal in (True, False):
        seen = spy(monkeypatch, LA)
        _, cnt = LA.lamp_flash_attention_plain(
            *(torch.from_numpy(a) for a in (q, k, v)), mu=mu, tau=tau,
            causal=causal, block_q=16, block_k=bk, k_subtile=sub, reduce=False)
        assert len(seen) == 2 and same_bits(seen[0].numpy(), want)
        assert same_bits(seen[1].numpy(), emulate(scaled(q), k, 23, sub))
        ok = np.tril(np.ones((T, T), bool)) if causal else np.ones((T, T), bool)
        s = np.where(ok, score(want), NEG)
        run = np.maximum.accumulate(s.reshape(B, H, T, T // bk, bk).max(-1), -1)
        thr = np.repeat(np.float32(FD.log_tau(tau)) + np.maximum(run, NEG), bk, -1)
        sel = ok & (s > thr)
        assert np.array_equal(cnt.numpy(), sel.sum(-1).astype(np.float32))
        assert sel.sum() > 0


@pytest.mark.parametrize("mu,sub", CASES)
def test_flash_decode_plain_sums_ylow_in_kernel_order(monkeypatch, mu, sub):
    """Lengths 0 (no key), 1, mid-cache and full."""
    rng = np.random.default_rng(200 + 10 * mu + sub)
    B, H, S, D, tau = 4, 2, 80, 64, 0.05
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32) * 1.5
    k = rng.standard_normal((B, H, S, D)).astype(np.float32) * 1.5
    v = rng.standard_normal((B, H, S, D)).astype(np.float32)
    length = np.asarray([0, 1, 37, S], np.int32)
    seen = spy(monkeypatch, FD)
    _, cnt = FD.flash_decode_plain(
        *(torch.from_numpy(a) for a in (q, k, v, length)), mu=mu, tau=tau,
        block_k=16, k_subtile=sub, reduce=False)
    want = emulate(scaled(q), k, mu, sub)                   # (B, H, 1, S)
    assert len(seen) == 1 and same_bits(seen[0].numpy(), want)
    ok = (np.arange(S)[None, :] < length[:, None])[:, None, None, :]
    s = np.where(ok, score(want), NEG)
    smax = np.maximum(s.max(-1, keepdims=True), NEG)
    sel = ok & (s > np.float32(FD.log_tau(tau)) + smax)
    assert np.array_equal(cnt.numpy(), sel.sum(-1)[..., 0].astype(np.float32))
    assert cnt[0].sum() == 0 and sel.sum() > 0


@pytest.mark.parametrize("mu", [4, 7, 23])
def test_slab_sums_is_ps_matmul_plain_at_every_slab_width(mu):
    """Every divisor of K 24 as block_k, 1 (per-lane rounding) to 24 (one
    slab); both in the emulated order."""
    rng = np.random.default_rng(300 + mu)
    M, K, N = 12, 24, 20
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for w in (w for w in range(1, K + 1) if K % w == 0):
        got = slab_sums(ta, tb, mu, w)
        assert torch.equal(got, PM.ps_matmul_plain(ta, tb, mu=mu, block_k=w))
        assert same_bits(got.numpy(), emulate(a, np.ascontiguousarray(b.T), mu, w))


def round_bits_branch_free(x: np.ndarray, mu: int) -> np.ndarray:
    """lamp_device.cuh::round_ps as the kernels spell it: add half an ulp
    minus 1 plus the kept lsb, clear the dropped bits; Inf and NaN kept."""
    bits = x.astype(np.float32).view(np.uint32)
    shift = np.uint32(23 - mu)
    half_m1 = np.uint32((1 << (23 - mu - 1)) - 1)
    keep = np.uint32(~((1 << (23 - mu)) - 1) & 0xFFFFFFFF)
    up = (bits + half_m1 + ((bits >> shift) & np.uint32(1))) & keep
    special = (bits & np.uint32(0x7F800000)) == np.uint32(0x7F800000)
    return np.where(special, bits, up).astype(np.uint32).view(np.float32)


def test_branch_free_rounding_is_round_to_nearest_even():
    """The kernels' branch-free rounding gives the bits of the comparison
    form and of ``core.numerics.round_to_mantissa`` at every mu below 23:
    random bit patterns, ties, carries into the exponent, subnormals, Inf
    and NaN with payloads."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 1 << 32, size=1 << 16, dtype=np.uint64).astype(np.uint32)
    special = np.asarray([0x3F800000 + (1 << 15), 0x3F800000 + (3 << 15),
                          0x3FFFFFFF, 0x7F7FFFFF, 0xFF7FFFFF, 0x00000001,
                          0x007FFFFF, 0x807FFFFF, 0x80000000, 0x7F800000,
                          0xFF800000, 0x7FC00000, 0x7F800001, 0x7FFFFFFF,
                          0xFFFFFFFF], np.uint32)
    x = np.concatenate([bits, special]).view(np.float32)
    for mu in range(1, 23):
        got = round_bits_branch_free(x, mu).view(np.uint32)
        assert np.array_equal(got, round_bits(x, mu).view(np.uint32)), mu
        want = round_to_mantissa(torch.from_numpy(x.copy()), mu).numpy()
        assert np.array_equal(got, want.view(np.uint32)), mu
