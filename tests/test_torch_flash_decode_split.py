"""flash_decode's split-over-keys arithmetic (csrc/flash_decode.cu),
emulated in numpy on the CPU, against the plain version and against JAX's
kernel.

The kernel cuts a row's keys into splits of KS (``KEYS_PER_SPLIT``), one
thread block each, one key a thread, four warps of 32 keys. ``emulate``
spells its order out in float32:
- y_low from ``slab_sums`` (the kernels' chunk order, held bit for bit to
  ``dot_low_chunked`` by tests/test_torch_ylow_order.py); smax is the max
  of the splits' maxima of s = y + log|y|; a selected key's logit is the
  FP32 product taken by fmaf in d order;
- in a split: m = the max of its logits, p = exp(y - m), l = the warps'
  sums of p (each an xor butterfly of shuffles) added in warp order, and
  acc = each warp's P.V (fmaf over its 32 keys in order) added in warp
  order;
- a row of one split writes acc / max(l, 1e-30); a longer row merges its
  splits in split order: M = max m_i, l = sum l_i e^(m_i - M),
  out = sum acc_i e^(m_i - M) / max(l, 1e-30).
The transcendental functions are torch's, as the plain version's, so that
what is compared is the order of the sums.

Tolerances: against the plain version every query row within rtol 2e-5 /
atol 2e-6 and every count exact (the two select on the same y_low and the
same smax). Against JAX (interpret mode, as tests/conftest.py pins it) the
same, but where a y_low chunk sum sits on a PS(mu) midpoint and XLA's dot
rounds it apart (``test_torch_micro_kernels.ylow_apart``): none does at
these seeds, so those cases are held exact too.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as JOPS
from repro_torch.core.mixed_matmul import slab_sums
from repro_torch.kernels import build
from repro_torch.kernels import flash_decode as FD
from test_torch_micro_kernels import ylow_apart

KS = FD.KEYS_PER_SPLIT
TOL = dict(rtol=2e-5, atol=2e-6)
S = 3 * KS + 40
LENGTHS = [0, 1, KS - 1, KS, KS + 1, S]


def fma(a, b, c):
    """fmaf in float32: the product and the sum taken in float64 (the
    product exactly), rounded once."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def butterfly(x):
    """A warp's xor-shuffle sum over its last axis (32 lanes): lane 0's."""
    x = x.astype(np.float32)
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = x + x[..., lanes ^ o]
    return x[..., 0]


def emulate(q, k, v, length, mu, tau, sub):
    """The kernel's arithmetic on (B, H, 1, D) / (B, H, S, D) float32
    arrays; returns (out (B, H, 1, D), counts (B, H))."""
    B, H, _, D = q.shape
    S_ = k.shape[2]
    qs = (q * np.float32(D ** -0.5)).astype(np.float32)
    y_low = slab_sums(torch.from_numpy(qs), torch.from_numpy(k).transpose(-1, -2),
                      mu, sub).numpy()[:, :, 0]                    # (B, H, S)
    y_t = torch.from_numpy(y_low)
    s = (y_t + torch.log(y_t.abs())).numpy()
    out = np.zeros((B, H, 1, D), np.float32)
    cnt = np.zeros((B, H), np.int64)
    for b in range(B):
        L = min(max(int(length[b]), 0), S_)
        nlive = -(-L // KS)
        if nlive == 0:
            continue
        for h in range(H):
            smax = max(max(np.float32(-1e30), s[b, h, i * KS:min((i + 1) * KS, L)].max())
                       for i in range(nlive))
            thr = np.float32(FD.log_tau(tau)) + np.float32(smax)
            parts = []
            for i in range(nlive):
                keys = np.arange(i * KS, (i + 1) * KS)
                ok = keys < L
                kk = np.minimum(keys, L - 1)
                y = y_low[b, h, kk].copy()
                sel = ok & (s[b, h, kk] > thr)
                exact = np.zeros(int(sel.sum()), np.float32)
                for d in range(D):
                    exact = fma(qs[b, h, 0, d], k[b, h, kk[sel], d], exact)
                y[sel] = exact
                y = np.where(ok, y, np.float32(-1e30)).astype(np.float32)
                m = y.max()
                p = torch.exp(torch.from_numpy(y - m)).numpy()
                p = np.where(ok, p, np.float32(0))
                vv = np.where(ok[:, None], v[b, h, kk], np.float32(0))
                warps = p.reshape(-1, 32)
                l = np.float32(0)
                acc = np.zeros(D, np.float32)
                for w in range(warps.shape[0]):
                    wl = butterfly(warps[w])
                    l = wl if w == 0 else np.float32(l + wl)
                    a = np.zeros(D, np.float32)
                    for key in range(32):
                        a = fma(np.full(D, warps[w, key], np.float32),
                                vv[w * 32 + key], a)
                    acc = a if w == 0 else (acc + a).astype(np.float32)
                parts.append((np.float32(m), np.float32(l), acc, int(sel.sum())))
            cnt[b, h] = sum(c for *_, c in parts)
            if nlive == 1:
                m, l, acc, _ = parts[0]
                out[b, h, 0] = acc / np.maximum(l, np.float32(1e-30))
                continue
            M = max(m for m, *_ in parts)
            f = [torch.exp(torch.tensor(m - M)).item() for m, *_ in parts]
            f = [np.float32(x) for x in f]
            lsum = parts[0][1] * f[0]
            a = parts[0][2] * f[0]
            for (m, l, acc, _), fi in zip(parts[1:], f[1:]):
                lsum = np.float32(lsum + l * fi)
                a = (a + acc * fi).astype(np.float32)
            out[b, h, 0] = a / np.maximum(lsum, np.float32(1e-30))
    return out, cnt


def inputs(seed, B=6, H=2, D=32, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, 1, D)) * 1.5).astype(np.float32)
    k = (rng.standard_normal((B, H, S, D)) * 1.5).astype(np.float32)
    v = rng.standard_normal((B, H, S, D)).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


def assert_held(out, cnt, ref, cref):
    np.testing.assert_allclose(out, ref, **TOL)
    assert np.array_equal(cnt, cref)


@pytest.mark.parametrize("mu", [5, 7, 23])
@pytest.mark.parametrize("sub", [1, 8, 32])
def test_split_order_matches_plain(mu, sub):
    """Lengths 0, 1, KS - 1, KS, KS + 1 and S: a row of no split, rows of
    one split (written directly) and rows merged from two to four."""
    q, k, v, length = inputs(10 * mu + sub)
    out, cnt = emulate(q, k, v, length, mu, 0.05, sub)
    ref, cref = FD.flash_decode_plain(
        *(torch.from_numpy(a) for a in (q, k, v, length)), mu=mu, tau=0.05,
        block_k=S, k_subtile=sub, reduce=False)
    assert_held(out, cnt, ref.numpy(), cref.numpy().astype(np.int64))
    assert not out[0].any() and cnt[0].sum() == 0 and cnt.sum() > 0


@pytest.mark.parametrize("mu,sub", [(5, 8), (7, 1), (23, 32)])
def test_split_order_matches_jax(mu, sub):
    q, k, v, length = inputs(50 + mu + sub, B=6, H=2, D=32)
    out, cnt = emulate(q, k, v, length, mu, 0.05, sub)
    want, nref = JOPS.flash_decode(*(jnp.asarray(a) for a in (q, k, v, length)),
                                   mu=mu, tau=0.05, block_k=S, k_subtile=sub)
    ok = (np.arange(S)[None, :] < length[:, None])[:, None, None, :]
    assert ylow_apart(q, k, mu, sub, ok).sum() == 0
    np.testing.assert_allclose(out, np.asarray(want), **TOL)
    assert cnt.sum() == float(nref)


def test_bfloat16_caches_widen_exactly():
    """bfloat16 caches, widened in the kernel: the emulation on the widened
    values against the plain version on the bfloat16 tensors."""
    q, k, v, length = inputs(3)
    kb, vb = torch.from_numpy(k).bfloat16(), torch.from_numpy(v).bfloat16()
    out, cnt = emulate(q, kb.float().numpy(), vb.float().numpy(), length, 7,
                       0.05, 8)
    ref, cref = FD.flash_decode_plain(torch.from_numpy(q), kb, vb,
                                      torch.from_numpy(length), mu=7, tau=0.05,
                                      block_k=S, k_subtile=8, reduce=False)
    assert_held(out, cnt, ref.numpy(), cref.numpy().astype(np.int64))


def test_inf_in_live_v_rows():
    """+Inf in the first split and -Inf in the last split of one row's
    column: NaN, as P.V in one sum gives; a lone +Inf stays +Inf."""
    q, k, v, length = inputs(4, B=2, lengths=[S, 2 * KS + 5])
    v[1, 0, 10, 11] = -np.inf
    v[1, 0, 2 * KS + 4, 11] = np.inf
    v[0, 1, 3, 5] = np.inf
    with np.errstate(invalid="ignore"):             # Inf - Inf
        out, cnt = emulate(q, k, v, length, 7, 0.05, 32)
    ref, cref = FD.flash_decode_plain(
        *(torch.from_numpy(a) for a in (q, k, v, length)), mu=7, tau=0.05,
        block_k=S, k_subtile=32, reduce=False)
    ref = ref.numpy()
    assert np.isnan(out[1, 0, 0, 11]) and np.isnan(ref[1, 0, 0, 11])
    assert out[0, 1, 0, 5] == np.inf and ref[0, 1, 0, 5] == np.inf
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(out), fin)
    np.testing.assert_allclose(out[fin], ref[fin], **TOL)
    assert np.array_equal(cnt, cref.numpy().astype(np.int64))


def test_keys_per_split_is_the_kernels():
    """KEYS_PER_SPLIT, which this emulation and the card tests cut by, is
    csrc/flash_decode.cu's KS = NW * 32."""
    with open(os.path.join(build.CSRC, "flash_decode.cu")) as f:
        src = f.read()
    nw = int(re.search(r"constexpr int NW = (\d+);", src).group(1))
    assert "constexpr int KS = NW * 32;" in src
    assert KS == nw * 32
