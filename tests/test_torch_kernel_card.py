"""The CUDA paged LAMP attention kernels (mixed rows and decode) against
their plain versions, on a card.

These tests import no JAX (the machine with the card has none), so they run
there with the repository's conftest left out:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \
        tests/test_torch_kernel_card.py

Without a card they skip. Tolerances are those of
tests/test_paged_kernel.py: outputs rtol 2e-5 / atol 2e-6; counts exact,
except one per query row for strict (the normalizer is summed blockwise by
the kernel, in one pass by the plain version) and at granularity 0 (the
kernel sums the FP32 dot in another order than cuBLAS).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.policy import LampSite
from repro_torch.kernels import paged_attention as PA

H, HKV, HD = 4, 2, 16
BS, N_MAX, W = 4, 8, 8

SITES = {
    "off": dict(enabled=False),
    "none": dict(rule="none", mu=5, granularity=0),
    "relaxed-g0": dict(rule="relaxed", mu=7, tau=0.05, granularity=0),
    "relaxed-g1": dict(rule="relaxed", mu=7, tau=0.1, granularity=1),
    "strict-g1": dict(rule="strict", mu=7, tau=0.1, granularity=1),
    "ln-g1": dict(rule="relaxed_ln", mu=7, tau=0.2, granularity=1, n_ref=64),
}
TOL = dict(rtol=2e-5, atol=2e-6)


def make_case(seed, starts=(0, 5, 13, 22), qlens=(8, 1, 3, 6), H=H, HKV=HKV,
              HD=HD, BS=BS, N_MAX=N_MAX, W=W):
    rng = np.random.default_rng(seed)
    B = len(starts)
    n_blocks = 1 + B * N_MAX
    k = (rng.standard_normal((n_blocks, BS, HKV, HD)) * 1.5).astype(np.float32)
    v = rng.standard_normal((n_blocks, BS, HKV, HD)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_blocks))
    bt = np.zeros((B, N_MAX), np.int32)
    for r in range(B):
        nb = -(-(starts[r] + qlens[r]) // BS)
        bt[r, :nb] = perm[r * N_MAX:r * N_MAX + nb]
    q = (rng.standard_normal((B, H, W, HD)) * 1.5).astype(np.float32)
    return (q, k, v, bt, np.asarray(starts, np.int32),
            np.asarray(qlens, np.int32))


def live_mask(qlens, W=W):
    return np.arange(W)[None, :] < np.asarray(qlens)[:, None]


def check_counts(got, want, name, live):
    got, want = np.asarray(got)[live], np.asarray(want)[live]
    if name in ("strict-g1", "relaxed-g0"):
        np.testing.assert_allclose(got, want, atol=1)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SITES))
def test_kernel_matches_plain_on_card(cuda_device, name):
    case = make_case(3, H=12, HKV=12, HD=64, BS=16, N_MAX=12, W=64,
                     starts=(0, 37, 100, 3), qlens=(64, 5, 1, 17))
    args = [torch.from_numpy(a).to(cuda_device) for a in case]
    site = LampSite(**SITES[name])
    before = PA.paged_mixed_attention.launches
    out, nsel = PA.paged_mixed_attention(*args, site)
    torch.cuda.synchronize()
    assert PA.paged_mixed_attention.launches == before + PA.passes(site)
    ref, nref = PA.paged_mixed_attention_plain(*args, site)
    live = torch.from_numpy(live_mask(case[5], W=64)).to(cuda_device)
    torch.testing.assert_close(out[live[:, None, :].expand(-1, 12, -1)],
                               ref[live[:, None, :].expand(-1, 12, -1)],
                               **TOL)
    check_counts(nsel.cpu(), nref.cpu(), name, live.cpu().numpy())


@pytest.mark.cuda
def test_kernel_skips_poisoned_dead_blocks(cuda_device):
    q, k, v, bt, starts, qlens = make_case(4)
    # one extra block, in no row's live span: dead table entries point at it
    poison = k.shape[0]
    k = np.concatenate([k, np.zeros_like(k[:1])])
    v = np.concatenate([v, np.zeros_like(v[:1])])
    for r in range(len(starts)):
        bt[r, -(-(starts[r] + qlens[r]) // BS):] = poison
    k_bad, v_bad = k.copy(), v.copy()
    k_bad[poison] = np.nan
    v_bad[poison] = np.nan
    site = LampSite(**SITES["relaxed-g1"])
    dev = cuda_device
    t = lambda a: torch.from_numpy(a).to(dev)
    out, _ = PA.paged_mixed_attention(t(q), t(k_bad), t(v_bad), t(bt),
                                      t(starts), t(qlens), site)
    ref, _ = PA.paged_mixed_attention_plain(t(q), t(k), t(v), t(bt),
                                            t(starts), t(qlens), site)
    live = torch.from_numpy(live_mask(qlens)).to(dev)[:, None, :].expand(-1, H, -1)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[live], ref[live], **TOL)


# decode: effective lengths 1, 16 (a block edge), 37, 100 and 191 (ragged
# across blocks), and a pad row (length 1 in the null block); GPT-2 small's
# head shape, and a GQA arena
DEC_LENGTHS = (1, 16, 37, 100, 191, 1)


def make_decode_case(seed, lengths, H=12, HKV=12, HD=64, BS=16, N_MAX=12):
    rng = np.random.default_rng(seed)
    R = len(lengths)
    n_blocks = 1 + R * N_MAX
    k = (rng.standard_normal((n_blocks, BS, HKV, HD)) * 1.5).astype(np.float32)
    v = rng.standard_normal((n_blocks, BS, HKV, HD)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_blocks))
    bt = np.zeros((R, N_MAX), np.int32)
    for r in range(R - 1):                    # the last row is padding
        nb = -(-lengths[r] // BS)
        bt[r, :nb] = perm[r * N_MAX:r * N_MAX + nb]
    q = (rng.standard_normal((R, H, 1, HD)) * 1.5).astype(np.float32)
    return q, k, v, bt, np.asarray(lengths, np.int32)


def check_decode_counts(got, want, name):
    if name in ("strict-g1", "relaxed-g0"):
        np.testing.assert_allclose(got, want, atol=1)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SITES))
def test_decode_kernel_matches_plain_on_card(cuda_device, name):
    """Every site, on a full-head and a GQA arena, with and without a window
    of 40 (which cuts rows 100 and 191 mid-block)."""
    site = LampSite(**SITES[name])
    for hkv, window in ((12, None), (12, 40), (4, None), (4, 40)):
        case = make_decode_case(5, DEC_LENGTHS, HKV=hkv)
        args = [torch.from_numpy(a).to(cuda_device) for a in case]
        before = PA.paged_decode_attention.launches
        out, nsel = PA.paged_decode_attention(*args, site, window=window)
        torch.cuda.synchronize()
        assert PA.paged_decode_attention.launches == before + PA.passes(site)
        ref, nref = PA.paged_decode_attention_plain(*args, site, window=window)
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, ref, **TOL)
        check_decode_counts(nsel.cpu().numpy(), nref.cpu().numpy(), name)


@pytest.mark.cuda
def test_decode_kernel_skips_poisoned_dead_blocks(cuda_device):
    q, k, v, bt0, lengths = make_decode_case(6, DEC_LENGTHS)
    # one extra block, in no row's live span: every dead table entry (past
    # the length, and before the window) points at it
    poison = k.shape[0]
    k = np.concatenate([k, np.zeros_like(k[:1])])
    v = np.concatenate([v, np.zeros_like(v[:1])])
    k_bad, v_bad = k.copy(), v.copy()
    k_bad[poison] = np.nan
    v_bad[poison] = np.nan
    bs = k.shape[1]
    t = lambda a: torch.from_numpy(a).to(cuda_device)
    for window in (None, 40):
        bt = bt0.copy()
        for r in range(len(lengths) - 1):
            L = int(lengths[r])
            bt[r, -(-L // bs):] = poison
            if window is not None:
                bt[r, :max(L - window, 0) // bs] = poison
        for name in ("relaxed-g1", "strict-g1"):
            site = LampSite(**SITES[name])
            out, nsel = PA.paged_decode_attention(
                t(q), t(k_bad), t(v_bad), t(bt), t(lengths), site, window=window)
            ref, nref = PA.paged_decode_attention_plain(
                t(q), t(k), t(v), t(bt), t(lengths), site, window=window)
            assert torch.isfinite(out).all()
            torch.testing.assert_close(out, ref, **TOL)
            check_decode_counts(nsel.cpu().numpy(), nref.cpu().numpy(), name)
