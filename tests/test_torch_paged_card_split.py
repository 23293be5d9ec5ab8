"""The split-over-keys paged LAMP attention kernel (csrc/paged_attention.cu)
against its plain versions, on a card: both entry points at the GPT-2 small
engine's bucket shapes (12 heads, hd 64, block 16) for every rule and
LAMP off, granularities 0, 1 and 8, split edges (KS - 1, KS, KS + 1 keys of
each tile), NaN-poisoned dead blocks, three calls bit-identical, launches
per call equal to ``passes(site)``, the self-resetting arrival counters of
one-pass calls, and y_low recomputed in pass 2 giving the bits of y_low
kept from pass 1.

These tests import no JAX (the machine with the card has none), so they run
there with the repository's conftest left out:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_paged_card_split.py

Without a card they skip. Tolerances are those of tests/test_paged_kernel.py:
outputs rtol 2e-5 / atol 2e-6 a live query; counts exact at every
granularity and mu, except one per query row for the strict rule (the
kernel sums the normalizer over splits in split order, the plain version
in one pass). The plain versions sum y_low and the FP32 logits in the
kernel's order (``order="kernel"`` of ``core.attention``: the chunks of
g lanes and the FP32 product d ascending, each product and sum rounded,
``core.mixed_matmul.slab_sums``), not by cuBLAS, so the kernel is held to
them as they stand.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.policy import LampSite
from repro_torch.kernels import paged_attention as PA

H, HD, BS, N_MAX = 12, 64, 16, 20
TOL = dict(rtol=2e-5, atol=2e-6)

SITES = {
    "off": dict(enabled=False),
    "none": dict(rule="none", mu=5, granularity=0),
    "relaxed-g0": dict(rule="relaxed", mu=7, tau=0.05, granularity=0),
    "relaxed-g1": dict(rule="relaxed", mu=7, tau=0.1, granularity=1),
    "strict-g1": dict(rule="strict", mu=7, tau=0.1, granularity=1),
    "ln-g1": dict(rule="relaxed_ln", mu=7, tau=0.2, granularity=1, n_ref=64),
}

# The engine's mixed buckets at the lengths of its log (chip_smoke.py phase
# kernels): name -> (starts, qlens, W)
MIXED = {
    "8x1": ([261, 44, 183, 99, 34, 221, 128, 60], [1] * 8, 1),
    "8x8": ([265, 46, 183, 99, 34, 221, 128, 60], [5] * 8, 8),
    "8x128": ([88, 64, 0, 257, 40, 0, 0, 0], [92, 32, 4, 1, 1, 1, 1, 1], 128),
    "4x128": ([0, 0, 256, 0], [40, 88, 1, 1], 128),
    # split edges: keys KS - 1, KS, KS + 1 of the width-1 tile (KS 64) and
    # of the wide tile (KS 64) at widths 8 and 64, and a length-1 row
    "edges1": ([62, 63, 64, 0], [1, 1, 1, 1], 1),
    "edges8": ([58, 63, 60, 0], [5, 1, 5, 1], 8),
    "edges64": ([62, 60, 0, 63], [1, 5, 64, 2], 64),
}
# decode rows: the draft's bucket, then the split edges of its tile
DECODE = [261, 44, 183, 99, 34, 221, 1, 1, 63, 64, 65, 300]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def slack(site) -> int:
    return int(site.enabled and site.rule == "strict")


def mixed_case(seed, starts, qlens, W, dev, Hkv=H):
    rng = np.random.default_rng(seed)
    B = len(starts)
    n_blocks = 1 + B * N_MAX
    k = (rng.standard_normal((n_blocks, BS, Hkv, HD)) * 1.5).astype(np.float32)
    v = rng.standard_normal((n_blocks, BS, Hkv, HD)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_blocks))
    bt = np.zeros((B, N_MAX), np.int32)
    for r in range(B):
        nb = -(-(starts[r] + qlens[r]) // BS)
        bt[r, :nb] = perm[r * N_MAX:r * N_MAX + nb]
    q = (rng.standard_normal((B, H, W, HD)) * 1.5).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in
            (q, k, v, bt, np.asarray(starts, np.int32), np.asarray(qlens, np.int32))]


def decode_case(seed, lengths, dev, Hkv=H):
    rng = np.random.default_rng(seed)
    R = len(lengths)
    n_blocks = 1 + R * N_MAX
    k = (rng.standard_normal((n_blocks, BS, Hkv, HD)) * 1.5).astype(np.float32)
    v = rng.standard_normal((n_blocks, BS, Hkv, HD)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_blocks))
    bt = np.zeros((R, N_MAX), np.int32)
    for r in range(R):
        nb = -(-lengths[r] // BS)
        bt[r, :nb] = perm[r * N_MAX:r * N_MAX + nb]
    q = (rng.standard_normal((R, H, 1, HD)) * 1.5).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in
            (q, k, v, bt, np.asarray(lengths, np.int32))]


def run_mixed(args, site, window=None):
    """The kernel once; asserts the launches it adds are passes(site)."""
    before = PA.paged_mixed_attention.launches
    out, nsel = PA.paged_mixed_attention(*args, site, window=window)
    torch.cuda.synchronize()
    assert PA.paged_mixed_attention.launches == before + PA.passes(site)
    return out, nsel


def run_decode(args, site, window=None):
    before = PA.paged_decode_attention.launches
    out, nsel = PA.paged_decode_attention(*args, site, window=window)
    torch.cuda.synchronize()
    assert PA.paged_decode_attention.launches == before + PA.passes(site)
    return out, nsel


def held_mixed(out, nsel, args, site, window=None, plain_args=None):
    ref, nref = PA.paged_mixed_attention_plain(*(plain_args or args), site,
                                               window=window)
    W = out.shape[2]
    live = torch.arange(W, device=out.device)[None, :] < args[5][:, None].long()
    lo = live[:, None, :].expand(-1, out.shape[1], -1)
    assert torch.isfinite(out[lo]).all()
    torch.testing.assert_close(out[lo], ref[lo], **TOL)
    assert (nsel[live] - nref[live]).abs().max().item() <= slack(site)


def held_decode(out, nsel, args, site, window=None, plain_args=None):
    ref, nref = PA.paged_decode_attention_plain(*(plain_args or args), site,
                                                window=window)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, **TOL)
    assert (nsel - nref).abs().max().item() <= slack(site)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SITES))
def test_mixed_buckets(dev, name):
    """Every mixed bucket of the engine and the split edges, a GQA arena (4
    KV heads) on the widest, and a window of 40 cutting a block."""
    site = LampSite(**SITES[name])
    for i, (starts, qlens, W) in enumerate(MIXED.values()):
        args = mixed_case(i, starts, qlens, W, dev)
        held_mixed(*run_mixed(args, site), args, site)
    args = mixed_case(20, *MIXED["8x128"], dev, Hkv=4)
    held_mixed(*run_mixed(args, site), args, site)
    args = mixed_case(21, *MIXED["edges64"], dev)
    held_mixed(*run_mixed(args, site, 40), args, site, 40)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SITES))
def test_decode_rows(dev, name):
    """The draft's bucket and the split edges, a GQA arena, and a window of
    40 (relaxed_ln's row length stays L)."""
    site = LampSite(**SITES[name])
    for hkv, window in ((H, None), (4, None), (H, 40)):
        args = decode_case(30 + hkv, DECODE, dev, Hkv=hkv)
        held_decode(*run_decode(args, site, window), args, site, window)


@pytest.mark.cuda
@pytest.mark.parametrize("mu,g", [(5, 8), (23, 1), (7, 8)])
def test_mu_and_granularity(dev, mu, g):
    site = LampSite(rule="relaxed", mu=mu, tau=0.05, granularity=g)
    for i, key in enumerate(("8x1", "8x8", "8x128")):
        args = mixed_case(40 + i, *MIXED[key], dev)
        held_mixed(*run_mixed(args, site), args, site)
    args = decode_case(43, DECODE, dev)
    held_decode(*run_decode(args, site), args, site)


def poison_mixed(args, window):
    """A NaN block appended, every dead table entry (past the last query,
    before the window) pointing at it; returns (kernel args, plain args)."""
    q, k, v, bt, starts, qlens = args
    poison = k.shape[0]
    zero = torch.zeros_like(k[:1])
    kc, vc = torch.cat([k, zero]), torch.cat([v, zero])
    bt = bt.clone()
    for r in range(bt.shape[0]):
        s, n = int(starts[r]), int(qlens[r])
        bt[r, -(-(s + n) // BS):] = poison
        if window is not None:
            bt[r, :max(s - window + 1, 0) // BS] = poison
    kb, vb = kc.clone(), vc.clone()
    kb[poison] = float("nan")
    vb[poison] = float("nan")
    return [q, kb, vb, bt, starts, qlens], [q, kc, vc, bt, starts, qlens]


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 40])
def test_mixed_poisoned_dead_blocks(dev, window):
    for name in ("strict-g1", "none"):
        site = LampSite(**SITES[name])
        for i, key in enumerate(("8x128", "edges64", "8x8")):
            bad, clean = poison_mixed(mixed_case(50 + i, *MIXED[key], dev), window)
            held_mixed(*run_mixed(bad, site, window), bad, site, window, clean)


@pytest.mark.cuda
def test_decode_poisoned_dead_blocks(dev):
    q, k, v, bt0, lengths = decode_case(60, DECODE, dev)
    poison = k.shape[0]
    zero = torch.zeros_like(k[:1])
    kc, vc = torch.cat([k, zero]), torch.cat([v, zero])
    kb, vb = kc.clone(), vc.clone()
    kb[poison] = float("nan")
    vb[poison] = float("nan")
    for window in (None, 40):
        bt = bt0.clone()
        for r, L in enumerate(DECODE):
            bt[r, -(-L // BS):] = poison
            if window is not None:
                bt[r, :max(L - window, 0) // BS] = poison
        for name in ("relaxed-g1", "strict-g1", "off"):
            site = LampSite(**SITES[name])
            bad = [q, kb, vb, bt, lengths]
            held_decode(*run_decode(bad, site, window), bad, site, window,
                        [q, kc, vc, bt, lengths])


@pytest.mark.cuda
def test_three_calls_bit_identical(dev):
    """Rows of up to five splits merged in split order: the same bits from
    three calls, for both entry points, a two-pass and two one-pass sites
    (which run the self-resetting arrival counters three times in a row)."""
    margs = mixed_case(70, *MIXED["8x128"], dev)
    dargs = decode_case(71, DECODE, dev)
    for name in ("strict-g1", "none", "off"):
        site = LampSite(**SITES[name])
        for run, args in ((run_mixed, margs), (run_decode, dargs)):
            outs = [run(args, site) for _ in range(3)]
            for out, nsel in outs[1:]:
                assert torch.equal(out, outs[0][0]) and torch.equal(nsel, outs[0][1])


@pytest.mark.cuda
def test_one_pass_calls_leave_the_counters_zero(dev):
    """A one-pass call has no pass 1 to zero the arrival counters: the
    merging unit resets each. Two one-pass calls in a row (then a two-pass
    one) give the plain version's results, and every counter of the stream
    is zero after each."""
    site = LampSite(**SITES["none"])
    args = mixed_case(80, *MIXED["8x1"], dev)
    dargs = decode_case(81, DECODE, dev)
    for run, held, a in ((run_mixed, held_mixed, args), (run_decode, held_decode, dargs)):
        for s in (site, site, LampSite(**SITES["strict-g1"])):
            held(*run(a, s), a, s)
            d = a[0].device
            key = (d.index, torch.cuda.current_stream(d).cuda_stream)
            assert int(PA._arrivals[key].abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["strict-g1", "relaxed-g0", "ln-g1"])
def test_recomputed_ylow_gives_the_kept_bits(dev, name, monkeypatch):
    """Pass 2 recomputing y_low (a bucket past YLOW_KEEP_MAX_BYTES, here
    set to 0) gives the bits of pass 2 reading it back from pass 1."""
    site = LampSite(**SITES[name])
    limit = PA.YLOW_KEEP_MAX_BYTES
    for key in ("8x1", "8x8", "8x128"):
        args = mixed_case(90, *MIXED[key], dev)
        B, _, W, _ = args[0].shape
        bs, n_max = args[1].shape[1], args[3].shape[1]
        res = []
        for keep in (True, False):
            monkeypatch.setattr(PA, "YLOW_KEEP_MAX_BYTES", limit if keep else 0)
            assert PA.keeps_ylow(B, H, W, n_max, bs, site) == keep
            launch, out, cnt = PA.prepare_launch(*args, site)
            assert launch() == 2
            torch.cuda.synchronize()
            res.append((out.clone(), cnt.clone()))
        live = torch.arange(args[0].shape[2], device=dev)[None, :] < \
            args[5][:, None].long()
        lo = live[:, None, :].expand(-1, H, -1)
        assert torch.equal(res[0][0][lo], res[1][0][lo])
        assert torch.equal(res[0][1][lo], res[1][1][lo])
