"""The paged LAMP attention kernel's split-over-keys arithmetic
(csrc/paged_attention.cu), emulated in numpy on the CPU, for both entry
points and both passes, against the plain versions and the JAX Pallas
kernels (interpret mode, as tests/conftest.py pins it).

A unit of the kernel is (row, head, a tile of TQ queries, a split of KS
keys) with NT threads in TR rows, thread (r, c) holding queries r QPT + i
and keys c + TC j (``paged_attention.TILES``). ``emulate`` spells its order
out in float32:
- y_low in dot_low_chunked's chunk order (each chunk's products and sums
  rounded to FP32, the running sum rounded to PS(mu) after each chunk);
  where y_low is the FP32 product rounded (granularity 0, g >= hd, mu >= 23)
  or LAMP is off, the FP32 product by fmaf in d order, as dot_exact;
- pass 1 per split and query: smax and m are maxima, l the sum of
  exp(y - m) in the kernel's order (a thread's keys in j order, xor
  butterflies over a warp's 32 lanes, then a row's warps in order); pass 2
  merges the splits' (smax, m, l): maxima, and l = sum l_i e^(m_i - M) in
  split order;
- pass 2 per split: the rule (lamp_device.cuh::lamp_selects) with
  relaxed_ln's row length min(q + 1, window or the table) for mixed rows
  and L for decode rows; a selected logit becomes the FP32 product; m the
  split's max, p = exp(y - m), l and the count summed as in pass 1; P.V by
  fmaf over the keys in order (a key with p 0 skipped), each of G key
  groups on its own, the groups added in order;
- a tile of one split writes acc / max(l, FLT_MIN); otherwise the splits'
  partials are merged in split order: M = max m_i, l = sum l_i e^(m_i - M),
  out = sum acc_i e^(m_i - M) / max(l, FLT_MIN), the count a sum.
The transcendental functions are torch's float32 ones, as the plain
versions', so that what is compared is the order of the sums.

Tolerances: every live query within rtol 2e-5 / atol 2e-6 of the plain
version and of JAX; counts exact for relaxed and relaxed_ln at
granularity >= 1, rule none and LAMP off; one count a query row of slack
(``count_slack``) for the strict rule (its normalizer l is summed in
another order by the kernel than by the plain version) and at granularity
0 (the FP32 dot before the PS(mu) rounding is a sequential fma chain in
the kernel, a matmul in the plain version). Against JAX, a query row where
JAX's Pallas y_low (``repro.kernels.paged_attention._y_low``) rounds a
live key one PS(mu) step apart from the port's order is found by computing
y_low in both packages (``jax_apart``): at most APART_ROWS such rows a
case, held to APART_ATOL, their counts to the keys apart. The wide bucket
at seed 4 has one (row 3, head 5, query 16; the plain version is as far
from JAX there).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.policy import LampSite as JaxSite
from repro.kernels import ops as JOPS
from repro.kernels.paged_attention import _y_low
from repro_torch.core.numerics import round_to_mantissa
from repro_torch.core.policy import LampSite
from repro_torch.kernels import build
from repro_torch.kernels import paged_attention as PA

F32 = np.float32
NEG, TINY = F32(-1e30), F32(1.1754944e-38)
TOL = dict(rtol=2e-5, atol=2e-6)
APART_ROWS, APART_ATOL = 1, 1e-3
H, HD, BS, N_MAX = 12, 16, 16, 10            # 160 keys a table: past KS + 1

SITES = {
    "off": dict(enabled=False),
    "none": dict(rule="none", mu=5, granularity=0),
    "relaxed-g0": dict(rule="relaxed", mu=7, tau=0.05, granularity=0),
    "relaxed-g1": dict(rule="relaxed", mu=7, tau=0.1, granularity=1),
    "strict-g1": dict(rule="strict", mu=7, tau=0.1, granularity=1),
    "ln-g1": dict(rule="relaxed_ln", mu=7, tau=0.2, granularity=1, n_ref=64),
}


def count_slack(site) -> int:
    return int(site.enabled and site.rule != "none" and
               (site.rule == "strict" or site.granularity == 0))


# --------------------------------------------------------------- emulation

def f32(x):
    return np.asarray(x, F32)


def texp(x):
    return torch.exp(torch.from_numpy(f32(x))).numpy()


def tlog(x):
    return torch.log(torch.from_numpy(f32(x))).numpy()


def fma(a, b, c):
    """fmaf in float32: the product and the sum taken in float64 (the
    product exactly), rounded once."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def rtm(x, mu):
    return round_to_mantissa(torch.from_numpy(f32(x)), mu).numpy()


def logits(qt, kt, site, hd):
    """(y, ye) of every pair: qt (H, TQ, hd), kt (H, KS, hd) -> (H, TQ, KS)."""
    a, b = qt[:, :, None, :], kt[:, None, :, :]
    g = site.granularity
    exact = not site.enabled or site.mu >= 23 or g <= 0 or g >= hd
    if exact:
        ye = np.zeros(a.shape[:-1][:2] + (b.shape[2],), F32)
        for d in range(hd):
            ye = fma(a[..., d], b[..., d], ye)
        return (rtm(ye, site.mu) if site.enabled else ye), ye
    y = np.zeros(a.shape[:2] + (b.shape[2],), F32)
    for s in range(0, hd, g):
        part = f32(a[..., s] * b[..., s])
        for d in range(s + 1, min(s + g, hd)):
            part = f32(part + f32(a[..., d] * b[..., d]))
        y = rtm(f32(y + part), site.mu)
    return y, None


def butterfly(x):
    """A warp's xor-shuffle sum over its last axis (32 lanes): every lane
    ends with the same bits; lane 0's."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = f32(x + x[..., lanes ^ o])
    return x[..., 0]


def row_sum(v, tc, kpt):
    """Sum of (..., KS) values over a thread row, in the kernel's order."""
    vv = v.reshape(v.shape[:-1] + (kpt, tc))     # key c + tc j at [j, c]
    t = np.zeros(v.shape[:-1] + (tc,), F32)
    for j in range(kpt):
        t = f32(t + vv[..., j, :])
    w = butterfly(t.reshape(v.shape[:-1] + (tc // 32, 32)))
    x = w[..., 0]
    for i in range(1, tc // 32):
        x = f32(x + w[..., i])
    return x


def selects(rule, y, ok, smax, m, l, tau, n_row, n_ref):
    """lamp_device.cuh::lamp_selects on float32 arrays."""
    tau = F32(tau)
    if rule == "strict":
        z = np.where(ok, texp(y - m), F32(0))
        z = f32(z / np.maximum(l, TINY))
        return ok & (f32(f32(F32(2) * z) * f32(F32(1) - z)) * np.abs(y) > tau)
    with np.errstate(divide="ignore"):
        s = f32(y + tlog(np.abs(y)))
    if rule == "relaxed":
        thr = f32(tlog(tau) + smax)
    else:
        tau_row = f32(tau * np.sqrt(f32(F32(n_ref) / f32(np.maximum(n_row, 1)))))
        thr = f32(tlog(np.minimum(tau_row, F32(0.999999))) + smax)
    return ok & (s > thr)


def emulate(q, k, v, bt, starts, qlens, site, *, tau=None, window=None,
            decode=False):
    """The kernel on numpy inputs: q (B, H, W, hd); arena (n_blocks, bs,
    Hkv, hd); bt (B, n_max); starts / qlens (B,), or for decode starts the
    lengths L. Returns (out (B, H, W, hd), counts (B, H, W))."""
    B, Hq, W, hd = q.shape
    _, bs, Hkv, _ = k.shape
    Tk = bt.shape[1] * bs
    nt, tr, qpt, kpt = PA.TILES[PA.tile_of(W)]
    tc = nt // tr
    TQ, KS = tr * qpt, tc * kpt
    G = nt // 32 // min(TQ, nt // 32)         # P.V's key groups
    kvh = np.arange(Hq) // (Hq // Hkv)
    tau = site.tau if tau is None else tau
    selecting = site.enabled and site.rule != "none"
    qs = f32(q * F32(hd ** -0.5))
    out = np.zeros((B, Hq, W, hd), F32)
    cnt = np.zeros((B, Hq, W), F32)
    for b in range(B):
        if decode:
            L = int(starts[b])
            start, qlen = L - 1, int(L > 0)
        else:
            start, qlen = int(starts[b]), int(qlens[b])
        for w0 in range(0, W, TQ):
            qe = min(max(qlen - w0, 0), TQ, W - w0)
            if qe <= 0:
                continue
            q_first = start + w0
            hi = min(q_first + qe - 1, Tk - 1)
            lo = 0 if window is None else \
                min(max(q_first - window + 1, 0) // bs, max(hi, 0) // bs) * bs
            nlive = (hi - lo + KS) // KS
            qt = np.zeros((Hq, TQ, hd), F32)
            qt[:, :qe] = qs[b, :, w0:w0 + qe]
            qi = q_first + np.arange(TQ)
            n_row = np.full(TQ, L) if decode else \
                np.minimum(np.maximum(qi + 1, 0), Tk if window is None else window)
            units = []
            for s in range(nlive):
                k0 = lo + s * KS
                n = min(KS, hi - k0 + 1)
                pos = k0 + np.arange(KS)
                kt = np.zeros((KS, Hkv, hd), F32)
                vt = np.zeros((KS, Hkv, hd), F32)
                for key in range(n):           # only the split's live keys are read
                    blk = bt[b, pos[key] // bs]
                    kt[key], vt[key] = k[blk, pos[key] % bs], v[blk, pos[key] % bs]
                kt, vt = kt[:, kvh].transpose(1, 0, 2), vt[:, kvh].transpose(1, 0, 2)
                ok = (np.arange(TQ)[:, None] < qe) & (np.arange(KS)[None, :] < n) \
                    & (pos[None, :] <= qi[:, None])
                if window is not None:
                    ok &= pos[None, :] > qi[:, None] - window
                ok = np.broadcast_to(ok, (Hq, TQ, KS))
                y, ye = logits(qt, kt, site, hd)
                units.append((ok, y, ye, kt, vt, n))
            # pass 1: the splits' statistics, merged in split order
            if selecting:
                parts = []
                for ok, y, *_ in units:
                    with np.errstate(divide="ignore"):
                        sv = np.where(ok, f32(y + tlog(np.abs(y))), NEG)
                    xm = np.where(ok, y, NEG).max(-1)
                    e = np.where(ok, texp(y - xm[..., None]), F32(0))
                    parts.append((sv.max(-1), xm, row_sum(e, tc, kpt)))
                smax = np.max([p[0] for p in parts], axis=0)
                m1 = np.max([p[1] for p in parts], axis=0)
                l1 = np.zeros_like(m1)
                for _, m_i, l_i in parts:
                    l1 = f32(l1 + f32(l_i * texp(m_i - m1)))
            # pass 2: per split partials
            parts = []
            for ok, y, ye, kt, vt, n in units:
                yv = y.copy()
                sel = np.zeros_like(ok)
                if selecting:
                    sel = selects(site.rule, y, ok, smax[..., None], m1[..., None],
                                  l1[..., None], tau, n_row[None, :, None], site.n_ref)
                    if ye is None:
                        ye = np.zeros_like(y)
                        for d in range(hd):
                            ye = fma(qt[:, :, None, d], kt[:, None, :, d], ye)
                    yv = np.where(sel, ye, y)
                pr = np.where(ok, yv, NEG)
                m2 = pr.max(-1)
                e = np.where(ok, texp(pr - m2[..., None]), F32(0))
                l2 = row_sum(e, tc, kpt)
                c2 = row_sum(f32(sel), tc, kpt)
                kg = KS // G
                groups = []
                for gi in range(G):
                    acc = np.zeros((Hq, TQ, hd), F32)
                    for kk in range(gi * kg, min((gi + 1) * kg, n)):
                        pk = e[:, :, kk, None]
                        acc = np.where(pk != 0, fma(pk, vt[:, None, kk, :], acc), acc)
                    groups.append(acc)
                acc = groups[0]
                for a in groups[1:]:
                    acc = f32(acc + a)
                parts.append((m2, l2, acc, c2))
            if nlive == 1:
                m2, l2, acc, c2 = parts[0]
                res = f32(acc / np.maximum(l2, TINY)[..., None])
                cs = c2
            else:
                mx = np.max([p[0] for p in parts], axis=0)
                lsum = np.zeros_like(mx)
                a = np.zeros((Hq, TQ, hd), F32)
                cs = np.zeros_like(mx)
                for m_i, l_i, acc_i, c_i in parts:
                    f = texp(m_i - mx)
                    lsum = f32(lsum + f32(l_i * f))
                    a = f32(a + f32(acc_i * f[..., None]))
                    cs = f32(cs + c_i)
                res = f32(a / np.maximum(lsum, TINY)[..., None])
            out[b, :, w0:w0 + qe] = res[:, :qe]
            cnt[b, :, w0:w0 + qe] = cs[:, :qe]
    return out, cnt


# --------------------------------------------------------------- inputs

def make_case(seed, starts, qlens, W, *, Hkv=4, decode=False):
    """Random arena and shuffled block tables: row r owns the blocks of its
    keys, the rest of its table is the null block."""
    rng = np.random.default_rng(seed)
    B = len(starts)
    n_blocks = 1 + B * N_MAX
    k = (rng.standard_normal((n_blocks, BS, Hkv, HD)) * 1.5).astype(F32)
    v = rng.standard_normal((n_blocks, BS, Hkv, HD)).astype(F32)
    perm = rng.permutation(np.arange(1, n_blocks))
    bt = np.zeros((B, N_MAX), np.int32)
    for r in range(B):
        end = starts[r] if decode else starts[r] + qlens[r]
        nb = -(-end // BS)
        bt[r, :nb] = perm[r * N_MAX:r * N_MAX + nb]
    q = (rng.standard_normal((B, H, W, HD)) * 1.5).astype(F32)
    return q, k, v, bt, np.asarray(starts, np.int32), np.asarray(qlens, np.int32)


# Mixed buckets. wide (TQ 8, KS 64) at width 32: a decode row at 63 keys
# (KS - 1), a verify row of width 5 over 61..65 keys (KS + 1), a prefill
# window of 32 (four tiles), a window of 20 at 91..110 keys, and a decode
# row of length 1. wide at width 8 (the verify bucket): verify rows ending
# at 63 and 65 keys, a decode row at 64 keys (KS), one of length 1 and a
# verify row over three splits. one (KS 64): decode rows at 63, 64 and 65
# keys, one of length 1 and one over three splits.
MIXED = {
    "wide": ([62, 60, 0, 90, 0], [1, 5, 32, 20, 1], 32),
    "verify": ([58, 63, 60, 0, 150], [5, 1, 5, 1, 5], 8),
    "one": ([62, 63, 64, 0, 149], [1, 1, 1, 1, 1], 1),
}
DECODE_LENGTHS = [63, 64, 65, 1, 40, 150]


def torch_args(case):
    return [torch.from_numpy(a) for a in case]


def live(qlens, W):
    return np.arange(W)[None, :] < np.asarray(qlens)[:, None]


def held_mixed(out, cnt, ref, nref, qlens, W, slack):
    lv = live(qlens, W)
    lo = np.broadcast_to(lv[:, None, :, None], out.shape)
    np.testing.assert_allclose(out[lo], ref[lo], **TOL)
    got = cnt.sum(1)[lv]
    want = np.asarray(nref)[lv]
    assert np.abs(got - want).max() <= slack, (got, want)


def check_mixed(name, tile, *, window=None, Hkv=4, seed=0, site=None):
    site = site or LampSite(**SITES[name])
    starts, qlens, W = MIXED[tile]
    case = make_case(seed, starts, qlens, W, Hkv=Hkv)
    out, cnt = emulate(*case, site, window=window)
    ref, nref = PA.paged_mixed_attention_plain(*torch_args(case), site,
                                               window=window)
    held_mixed(out, cnt, ref.numpy(), nref.numpy(), qlens, W, count_slack(site))
    return out, cnt


def check_decode(name, *, window=None, Hkv=4, seed=0, site=None):
    site = site or LampSite(**SITES[name])
    R = len(DECODE_LENGTHS)
    q, k, v, bt, lengths, _ = make_case(seed, DECODE_LENGTHS, [0] * R, 1,
                                        Hkv=Hkv, decode=True)
    out, cnt = emulate(q, k, v, bt, lengths, None, site, window=window,
                       decode=True)
    ref, nref = PA.paged_decode_attention_plain(
        *torch_args((q, k, v, bt, lengths)), site, window=window)
    np.testing.assert_allclose(out, ref.numpy(), **TOL)
    assert np.abs(cnt.sum(1)[:, 0] - nref.numpy()).max() <= count_slack(site)
    return out, cnt


# --------------------------------------------------------------- tests

@pytest.mark.parametrize("name", sorted(SITES))
def test_mixed_split_order_matches_plain(name):
    """Every rule and LAMP off, both tiles at widths 32, 8 and 1, GQA (12
    heads on 4); then
    12 KV heads and a window of 40, which cuts the first live block (its
    early keys masked per query) and caps relaxed_ln's row length."""
    for tile in MIXED:
        check_mixed(name, tile)
        check_mixed(name, tile, window=40, Hkv=12, seed=2)


@pytest.mark.parametrize("name", sorted(SITES))
def test_decode_split_order_matches_plain(name):
    """Lengths KS - 1, KS, KS + 1 and 1 of the width-1 tile, relaxed_ln's
    row length L, with a window of 40 that cuts a block (and without)."""
    check_decode(name)
    check_decode(name, window=40, Hkv=12, seed=1)


@pytest.mark.parametrize("mu,g", [(5, 1), (23, 1), (7, 8), (5, 0), (23, 0)])
def test_mu_and_granularity(mu, g):
    """mu 5, 7 and 23 at granularity 0, 1 and 8 (the exact-product path at
    g 0 and mu 23), relaxed rule, the wide and the one tile."""
    site = LampSite(rule="relaxed", mu=mu, tau=0.05, granularity=g)
    for tile in ("wide", "one"):
        check_mixed(None, tile, site=site, seed=3)


_jit_y_low = jax.jit(_y_low, static_argnums=(2, 3))


def jax_apart(q, k, bt, starts, qlens, site, *, window=None, decode=False):
    """(B, W) live keys a query row (summed over heads) whose y_low JAX's
    Pallas kernel rounds apart from the port's chunk order. Compiled by XLA,
    as in the kernel (which may contract `acc + part` into one rounding);
    taken eagerly, _y_low gives the port's bits."""
    B, Hq, W, hd = q.shape
    bs, Hkv = k.shape[1], k.shape[2]
    apart = np.zeros((B, W), np.int64)
    qs = f32(q * F32(hd ** -0.5))
    for b in range(B):
        start, n = (int(starts[b]) - 1, 1) if decode else \
            (int(starts[b]), int(qlens[b]))
        if n <= 0 or start < 0:
            continue
        pos = np.arange(start + n)
        keys = k[bt[b, pos // bs], pos % bs]                   # (P, Hkv, hd)
        qi = start + np.arange(n)
        ok = pos[None, :] <= qi[:, None]
        if window is not None:
            ok &= pos[None, :] > qi[:, None] - window
        for h in range(Hq):
            kh = keys[:, h // (Hq // Hkv)]
            yj = np.asarray(_jit_y_low(jnp.asarray(qs[b, h, :n]), jnp.asarray(kh),
                                       site.mu, site.granularity))
            yt, _ = logits(qs[b, h:h + 1, :n], kh[None], site, hd)
            apart[b, :n] += ((yj != yt[0]) & ok).sum(-1)
    return apart


def held_jax(out, cnt, want, nsel, apart, live_rows, slack):
    """Rows with no key apart within TOL and their counts within `slack`;
    at most APART_ROWS rows apart, within APART_ATOL, their counts within
    the keys apart."""
    lv = live_rows & (apart == 0)
    assert (live_rows & (apart > 0)).sum() <= APART_ROWS
    lo = np.broadcast_to(lv[:, None, :, None], out.shape)
    np.testing.assert_allclose(out[lo], want[lo], **TOL)
    far = np.broadcast_to((live_rows & (apart > 0))[:, None, :, None], out.shape)
    np.testing.assert_allclose(out[far], want[far], rtol=0, atol=APART_ATOL)
    diff = np.abs(cnt.sum(1) - nsel)[live_rows]
    assert (diff <= slack + apart[live_rows]).all()


@pytest.mark.parametrize("name", ["relaxed-g1", "strict-g1"])
def test_mixed_matches_jax_pallas(name):
    """The emulation against JAX's Pallas kernel on the wide bucket."""
    starts, qlens, W = MIXED["wide"]
    case = make_case(4, starts, qlens, W)
    site = LampSite(**SITES[name])
    out, cnt = emulate(*case, site)
    want, nsel = JOPS.paged_mixed_attention(*(jnp.asarray(a) for a in case),
                                            JaxSite(**SITES[name]))
    apart = jax_apart(case[0], case[1], case[3], case[4], case[5], site)
    held_jax(out, cnt, np.asarray(want), np.asarray(nsel), apart,
             live(qlens, W), count_slack(site))


def test_decode_matches_jax_pallas():
    site = LampSite(**SITES["ln-g1"])
    R = len(DECODE_LENGTHS)
    q, k, v, bt, lengths, _ = make_case(5, DECODE_LENGTHS, [0] * R, 1,
                                        decode=True)
    out, cnt = emulate(q, k, v, bt, lengths, None, site, window=40, decode=True)
    want, nsel = JOPS.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, k, v, bt, lengths)), JaxSite(**SITES["ln-g1"]),
        window=40)
    apart = jax_apart(q, k, bt, lengths, None, site, window=40, decode=True)
    held_jax(out, cnt, np.asarray(want), np.asarray(nsel)[:, None], apart,
             np.ones((R, 1), bool), count_slack(site))


def test_dead_blocks_are_never_read():
    """NaN in every block outside the rows' live spans (past the last
    query, before the window): the emulation reads only live keys, and
    gives the plain version's result on the clean arena."""
    starts, qlens, W = MIXED["wide"]
    q, k, v, bt, st, ql = make_case(6, starts, qlens, W)
    poison = k.shape[0]
    k = np.concatenate([k, np.zeros_like(k[:1])])
    v = np.concatenate([v, np.zeros_like(v[:1])])
    bad_bt = bt.copy()
    for r in range(len(starts)):
        bad_bt[r, -(-(starts[r] + qlens[r]) // BS):] = poison
        bad_bt[r, :max(starts[r] - 40 + 1, 0) // BS] = poison
    k_bad, v_bad = k.copy(), v.copy()
    k_bad[poison] = np.nan
    v_bad[poison] = np.nan
    site = LampSite(**SITES["strict-g1"])
    out, cnt = emulate(q, k_bad, v_bad, bad_bt, st, ql, site, window=40)
    ref, nref = PA.paged_mixed_attention_plain(
        *torch_args((q, k, v, bad_bt, st, ql)), site, window=40)
    assert np.isfinite(out).all()
    held_mixed(out, cnt, ref.numpy(), nref.numpy(), qlens, W, 1)


def test_tiles_are_the_kernels():
    """TILES, by which this emulation cuts units, are csrc/paged_attention.cu's
    Tile<NT, TR, QPT, KPT>, and the wrapper's choice of tile by W is the
    kernel's."""
    with open(os.path.join(build.CSRC, "paged_attention.cu")) as f:
        src = f.read()
    for name, cpp in (("one", "TileOne"), ("wide", "TileWide")):
        m = re.search(rf"using {cpp} = Tile<(\d+), (\d+), (\d+), (\d+)>;", src)
        assert tuple(int(x) for x in m.groups()) == PA.TILES[name]
    assert len(re.findall(r"using Tile\w+ = Tile<", src)) == len(PA.TILES)
    assert "return W == 1 ? 0 : 1;" in src
    assert [PA.tile_of(W) for W in (1, 2, 8, 9, 128)] == \
        ["one", "wide", "wide", "wide", "wide"]


def test_ylow_kept_by_size():
    """Pass 1 keeps y_low only in a two-pass call, and only up to
    YLOW_KEEP_MAX_BYTES of scratch: every bucket of the GPT-2 small engine
    (12 heads, 20 blocks of 16) keeps it."""
    strict, none = LampSite(rule="strict"), LampSite(rule="none")
    assert PA.keeps_ylow(8, 12, 128, 20, 16, strict)
    assert not PA.keeps_ylow(8, 12, 128, 20, 16, none)
    assert not PA.keeps_ylow(8, 12, 128, 20, 16, LampSite(enabled=False))
    big = PA.YLOW_KEEP_MAX_BYTES // (4 * 12 * 128 * 16) + 1
    assert not PA.keeps_ylow(1, 12, 128, big, 16, strict)
