"""The arithmetic of the Hopper lamp_flash_attention kernel, emulated in
numpy on the CPU, against the port's plain version.

``kernel_emulate`` follows ``csrc/lamp_attention.cu`` step by step and is
written without ``slab_sums``:
  * per (query, key) pair the chunk partials of k_subtile lanes, each from
    a zero partial, k ascending, every product and sum rounded to FP32;
    y_low = PS(mu)(y_low + part) and y_exact = y_exact + part at each chunk
    end (one pass gives both);
  * s = y_low + log|y_low| and the selection per k-block against the
    running row max of s, the k-blocks walked in order inside key tiles of
    at most 128 keys (a tile holds whole k-blocks; a longer k-block is its
    own step);
  * the online softmax once per step, its reference m the running max of
    both logits;
  * P.V in 3xTF32: p and V split into hi = tf32(x) and lo = tf32(x - hi)
    (round to nearest, ties away, at 10 mantissa bits, as cvt.rna.tf32.f32
    and the kernel's integer rounding do); the output scaled by the online
    softmax's correction, then per 8-key k-step the hi.hi sum added into it,
    and the tile's lo.hi and hi.lo sums (one accumulator, in turn) added at
    the tile's end. The 1xTF32 control keeps hi.hi alone.

What it shows: y_low and y_exact are bit for bit what the plain version
computes (``slab_sums`` at mu and at 23), so kernel and plain select the
same keys; the 3xTF32 output stays within the card's tolerance of the
plain version (rtol 2e-5 / atol 2e-6 on every query row) and a single
TF32 pass does not. The real MMA sums its 8 lanes in its own order, so the
card run (tests/test_torch_lamp_attention_card.py) checks the margin again.
No JAX here: these are properties of the port alone.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core.mixed_matmul import slab_sums
from repro_torch.kernels import lamp_attention as LA

NEG = np.float32(-1e30)
TOL = dict(rtol=2e-5, atol=2e-6)
KT = 128          # key slots of the kernel's tile


def round_bits(x: np.ndarray, mu: int) -> np.ndarray:
    """lamp_device.cuh::round_to_mantissa on float32 bits (half to even,
    the carry running into the exponent; Inf and NaN kept)."""
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


def chunk_logits(q: np.ndarray, k: np.ndarray, mu: int, sub: int):
    """(y_low, y_exact) of every pair: q (..., T, D), k (..., S, D)."""
    D = q.shape[-1]
    shape = q.shape[:-1] + (k.shape[-2],)
    yl = np.zeros(shape, np.float32)
    ye = np.zeros(shape, np.float32)
    for s in range(0, D, sub):
        part = np.zeros(shape, np.float32)
        for d in range(s, min(s + sub, D)):
            part = part + q[..., :, None, d] * k[..., None, :, d]
        yl = round_bits(yl + part, mu)
        ye = ye + part
    return yl, ye


def tf32(x: np.ndarray) -> np.ndarray:
    """x rounded to 10 mantissa bits, to nearest, ties away from zero."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    hi = tf32(x)
    return hi, tf32(x - hi)


def pv_tf32(acc: np.ndarray, p: np.ndarray, v: np.ndarray, passes: int) -> np.ndarray:
    """acc + P (..., T, n) @ V (..., n, D) as the kernel's mma.sync sum it:
    hi.hi per k-step of 8 keys into acc, and with 3 passes lo.hi and hi.lo
    into one sum over the tile, added last."""
    ph, pl = split(p)
    vh, vl = split(v)
    fine = np.zeros_like(acc)
    for k0 in range(0, p.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        if passes == 3:
            fine = fine + np.matmul(pl[..., ks], vh[..., ks, :])
            fine = fine + np.matmul(ph[..., ks], vl[..., ks, :])
        acc = acc + np.matmul(ph[..., ks], vh[..., ks, :])
    return acc + fine


def steps(S: int, bk: int):
    """The kernel's walk: [(k0, k1, [k-block starts])] -- a tile of whole
    k-blocks (block_k <= 128), or one k-block a step."""
    kt = KT // bk * bk if bk <= KT else bk
    return [(k0, min(k0 + kt, S), list(range(k0, min(k0 + kt, S), bk)))
            for k0 in range(0, S, kt)]


def kernel_emulate(q, k, v, *, mu, tau, causal, block_k, k_subtile, passes=3):
    """out (B, H, T, D) and per-row counts (B, H, T) as the kernel computes
    them; float32 throughout."""
    T, D = q.shape[-2:]
    S = k.shape[-2]
    bk = min(block_k, S)
    qs = q * np.float32(D ** -0.5)
    yl, ye = chunk_logits(qs, k, mu, k_subtile)
    ok = np.arange(S)[None, :] <= np.arange(T)[:, None] if causal else \
        np.ones((T, S), bool)
    with np.errstate(divide="ignore"):
        s = np.where(ok, yl + np.log(np.abs(yl)), NEG)
    log_tau = np.float32(LA.log_tau(tau))
    lead = q.shape[:-1]
    smax = np.full(lead, NEG, np.float32)
    m = np.full(lead, NEG, np.float32)
    l = np.zeros(lead, np.float32)
    cnt = np.zeros(lead, np.int64)
    acc = np.zeros(lead + (D,), np.float32)
    for k0, k1, blocks in steps(S, bk):
        y = np.empty(lead + (k1 - k0,), np.float32)
        for b0 in blocks:
            b1 = min(b0 + bk, k1)
            smax = np.maximum(smax, s[..., b0:b1].max(-1))
            sel = ok[:, b0:b1] & (s[..., b0:b1] > log_tau + smax[..., None])
            cnt += sel.sum(-1)
            y[..., b0 - k0:b1 - k0] = np.where(sel, ye[..., b0:b1], yl[..., b0:b1])
        okt = ok[:, k0:k1]
        m_new = np.maximum(m, np.where(okt, np.maximum(yl[..., k0:k1], ye[..., k0:k1]),
                                       NEG).max(-1))
        with np.errstate(over="ignore"):     # masked pairs: exp is not taken
            corr = np.exp(m - m_new)
            p = np.where(okt, np.exp(y - m_new[..., None]), np.float32(0))
        l = l * corr + p.sum(-1, dtype=np.float32)
        acc = pv_tf32(acc * corr[..., None], p, v[..., k0:k1, :], passes)
        m = m_new
    return acc / np.maximum(l, np.float32(1e-30))[..., None], cnt


def inputs(shape, S, seed):
    rng = np.random.default_rng(seed)
    B, H, T, D = shape
    q = (rng.standard_normal(shape) * 1.5).astype(np.float32)
    k = (rng.standard_normal((B, H, S, D)) * 1.5).astype(np.float32)
    v = rng.standard_normal((B, H, S, D)).astype(np.float32)
    return q, k, v


def apart(out: np.ndarray, ref: np.ndarray):
    """Outputs outside the tolerance, and the worst share of its allowance."""
    err = np.abs(out - ref)
    allow = TOL["atol"] + TOL["rtol"] * np.abs(ref)
    return int((err > allow).sum()), float((err / allow).max())


@settings(max_examples=40, deadline=None)
@given(D=st.integers(2, 32).map(lambda x: 4 * x),
       sub=st.sampled_from(["1", "3", "8", "32", "D", "D+5"]),
       mu=st.sampled_from([1, 4, 7, 23]), seed=st.integers(0, 2 ** 16))
def test_chunk_logits_are_the_plain_versions_bits(D, sub, mu, seed):
    """(a) y_low = slab_sums(., mu, k_subtile) and y_exact =
    slab_sums(., 23, k_subtile), bit for bit."""
    g = {"D": D, "D+5": D + 5}.get(sub) or int(sub)
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((2, 5, D)) * 1.5).astype(np.float32)
    k = (rng.standard_normal((2, 7, D)) * 1.5).astype(np.float32)
    yl, ye = chunk_logits(q, k, mu, g)
    kt = torch.from_numpy(k).transpose(-1, -2)
    want_l = slab_sums(torch.from_numpy(q), kt, mu, g).numpy()
    want_e = slab_sums(torch.from_numpy(q), kt, 23, g).numpy()
    assert np.array_equal(yl.view(np.uint32), want_l.view(np.uint32))
    assert np.array_equal(ye.view(np.uint32), want_e.view(np.uint32))


# the micro-benchmark's lamp row (blocks of 64: two k-blocks a tile) and a
# GPT-2 small prefill over 2 heads (blocks of 128: one a tile)
SHAPES = [((1, 4, 256, 64), 64), ((1, 2, 1024, 64), 128)]


@pytest.mark.parametrize("mu", [4, 7, 23])
@pytest.mark.parametrize("shape,bk", SHAPES, ids=["256", "1024"])
def test_3xtf32_emulation_within_tolerance_of_plain(shape, bk, mu):
    """(b) Every output within rtol 2e-5 / atol 2e-6, counts equal."""
    q, k, v = inputs(shape, shape[2], seed=bk + mu)
    kw = dict(mu=mu, tau=0.05, causal=True, block_k=bk, k_subtile=32)
    out, cnt = kernel_emulate(q, k, v, **kw)
    ref, cref = LA.lamp_flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), block_q=shape[2],
        reduce=False, **kw)
    n_apart, worst = apart(out, ref.numpy())
    assert n_apart == 0 and worst < 1.0, (n_apart, worst)
    assert np.array_equal(cnt, cref.numpy().astype(np.int64))
    assert cnt.sum() > 0


@pytest.mark.parametrize("shape,bk", SHAPES, ids=["256", "1024"])
def test_1xtf32_control_breaks_the_tolerance(shape, bk):
    """(c) hi.hi alone: a TF32 P.V keeps about 10 mantissa bits."""
    q, k, v = inputs(shape, shape[2], seed=bk + 7)
    kw = dict(mu=7, tau=0.05, causal=True, block_k=bk, k_subtile=32)
    out, _ = kernel_emulate(q, k, v, passes=1, **kw)
    ref, _ = LA.lamp_flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), block_q=shape[2], **kw)
    n_apart, worst = apart(out, ref.numpy())
    assert n_apart > out.size // 10 and worst > 10.0, (n_apart, worst)


@pytest.mark.parametrize("bk,S", [(8, 40), (48, 96), (256, 512)])
def test_walk_of_k_blocks_in_tiles_matches_plain(bk, S):
    """The kernel's three walks -- several k-blocks a tile, a tile of
    whole k-blocks that is not 128 keys (96 = 2 x 48), a k-block over
    several tiles -- select what the plain version selects, causal and
    not."""
    for causal in (True, False):
        q, k, v = inputs((1, 2, S, 32), S, seed=bk + S + causal)
        kw = dict(mu=7, tau=0.05, causal=causal, block_k=bk, k_subtile=8)
        out, cnt = kernel_emulate(q, k, v, **kw)
        ref, cref = LA.lamp_flash_attention_plain(
            *(torch.from_numpy(a) for a in (q, k, v)), block_q=S,
            reduce=False, **kw)
        assert np.array_equal(cnt, cref.numpy().astype(np.int64))
        assert apart(out, ref.numpy())[0] == 0


if __name__ == "__main__":
    # the readings of (b) and (c): outputs outside the tolerance and the
    # worst error over its allowance, 3xTF32 at each mu and 1xTF32 at mu 7
    #   PYTHONPATH=src python tests/test_torch_lamp_order.py
    for shape, bk in SHAPES:
        for mu, passes in ((4, 3), (7, 3), (23, 3), (7, 1)):
            q, k, v = inputs(shape, shape[2], seed=bk + mu)
            kw = dict(mu=mu, tau=0.05, causal=True, block_k=bk, k_subtile=32)
            out, cnt = kernel_emulate(q, k, v, passes=passes, **kw)
            ref, cref = LA.lamp_flash_attention_plain(
                *(torch.from_numpy(a) for a in (q, k, v)), block_q=shape[2],
                reduce=False, **kw)
            n_apart, worst = apart(out, ref.numpy())
            print(f"{shape} block_k {bk} mu {mu} {passes}xTF32: {n_apart} of "
                  f"{out.size} apart, worst {worst:.3f} of the allowance, max_err "
                  f"{np.abs(out - ref.numpy()).max():.3g}, counts equal "
                  f"{np.array_equal(cnt, cref.numpy().astype(np.int64))}")
