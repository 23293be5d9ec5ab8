"""The split-over-keys flash_decode kernel (csrc/flash_decode.cu) against
its plain version, on a card: the edges of a split (lengths 0, 1, KS - 1,
KS, KS + 1 and S, KS the keys of a thread block) with NaN past every
length, head dims on each staging path, Inf in a live V row, bfloat16
caches read in their own dtype, one long row, and the same bits from three
calls.

These tests import no JAX (the machine with the card has none), so they run
there with the repository's conftest left out:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_flash_decode_card.py

Without a card they skip. Tolerance (``kernels_micro.TOL``): every query
row within rtol 2e-5 / atol 2e-6 of the plain version and every count
exact, since both sum y_low in the same order (``slab_sums``) and take
smax as a max.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_decode as FD
from repro_torch.launch import kernels_micro as KM

KS = FD.KEYS_PER_SPLIT


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def rand(rng, shape, dev, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).to(dev)


def make(rng, dev, B, H, S, D, lengths):
    q = rand(rng, (B, H, 1, D), dev, 1.5)
    k, v = rand(rng, (B, H, S, D), dev, 1.5), rand(rng, (B, H, S, D), dev)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)


def poisoned(t, length):
    """t with NaN in every key at or past its row's length."""
    S = t.shape[2]
    dead = torch.arange(S, device=t.device)[None, :] >= length.long()[:, None]
    return t.masked_fill(dead[:, None, :, None], float("nan"))


def kernel(q, k, v, length, **kw):
    before = FD.flash_decode.launches
    out, cnt = FD.flash_decode(q, k, v, length, reduce=False, **kw)
    torch.cuda.synchronize()
    assert FD.flash_decode.launches == before + 2
    return out, cnt


def held(q, k, v, length, **kw):
    """The kernel on NaN-poisoned caches against the plain version on the
    clean ones: every row within TOL, every count exact."""
    out, cnt = kernel(q, poisoned(k, length), poisoned(v, length), length, **kw)
    ref, cref = FD.flash_decode_plain(q, k, v, length, reduce=False, **kw)
    res = KM.compare_rows(out, cnt, ref, cref)
    assert res["ok"] and res["apart_rows"] == 0, res
    assert torch.equal(cnt.float(), cref.float())
    return out, cnt


@pytest.mark.cuda
@pytest.mark.parametrize("mu,sub", [(5, 1), (7, 8), (7, 32), (23, 32), (5, 7)])
def test_split_edges_with_nan_past_length(dev, mu, sub):
    """Lengths 0, 1, KS - 1, KS, KS + 1 and S over three and a part splits."""
    S = 3 * KS + 40
    rng = np.random.default_rng(100 + mu + sub)
    q, k, v, length = make(rng, dev, 6, 3, S, 64, [0, 1, KS - 1, KS, KS + 1, S])
    out, cnt = held(q, k, v, length, mu=mu, tau=0.05, block_k=S, k_subtile=sub)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert int(cnt[0].sum()) == 0 and int(cnt.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("D", [4, 36, 128])
def test_head_dims(dev, D):
    """D 4 (pass 1's first column half empty), 36 (an odd number of
    4-element groups, no padding) and 128 (above 48 KB of shared memory)."""
    S = 2 * KS + 8
    rng = np.random.default_rng(D)
    q, k, v, length = make(rng, dev, 3, 2, S, D, [S, KS + 3, 17])
    held(q, k, v, length, mu=7, tau=0.05, block_k=8, k_subtile=3)


@pytest.mark.cuda
def test_inf_in_a_live_v_row(dev):
    """+Inf and -Inf in live V rows (in the first and the last split of a
    row) give the plain version's Inf, NaN and finite values."""
    S = 3 * KS
    rng = np.random.default_rng(7)
    q, k, v, length = make(rng, dev, 2, 2, S, 64, [S, 2 * KS + 5])
    v[0, 0, 3, 5] = float("inf")
    v[0, 1, S - 1, 9] = -float("inf")
    v[1, 0, 2 * KS + 4, 11] = float("inf")
    v[1, 0, 10, 11] = -float("inf")
    kw = dict(mu=7, tau=0.05, block_k=S, k_subtile=32)
    out, cnt = kernel(q, poisoned(k, length), poisoned(v, length), length, **kw)
    ref, cref = FD.flash_decode_plain(q, k, v, length, reduce=False, **kw)
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    inf = torch.isinf(ref)
    assert int(inf.sum()) == 2 and torch.equal(out[inf], ref[inf])
    fin = torch.isfinite(ref)
    assert torch.isnan(ref[1, 0, 0, 11])          # Inf - Inf
    torch.testing.assert_close(out[fin], ref[fin], **KM.TOL)
    assert torch.equal(cnt.float(), cref.float())


@pytest.mark.cuda
def test_three_calls_give_the_same_bits(dev):
    """The micro-benchmark's full-width row: splits merged in split order,
    whichever block of a row arrives last."""
    rng = np.random.default_rng(5)
    lengths = np.linspace(1, 1024, 8).round().astype(int).tolist()
    q, k, v, length = make(rng, dev, 8, 12, 1024, 64, lengths)
    kw = dict(mu=7, tau=0.05, block_k=512, k_subtile=32)
    first, c1 = held(q, k, v, length, **kw)
    for _ in range(2):
        out, cnt = kernel(q, k, v, length, **kw)
        assert torch.equal(out, first) and torch.equal(cnt, c1)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [4096, 4000])
def test_one_row_of_4096_keys(dev, L):
    rng = np.random.default_rng(L)
    q, k, v, length = make(rng, dev, 1, 1, 4096, 64, [L])
    held(q, k, v, length, mu=7, tau=0.05, block_k=512, k_subtile=32)


@pytest.mark.cuda
@pytest.mark.parametrize("k_dtype,v_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16)])
def test_bfloat16_caches(dev, k_dtype, v_dtype):
    """Caches in bfloat16 are read as they lie (no float32 copy) and widened
    in the kernel; held to the plain version on the same bfloat16 inputs."""
    S = 2 * KS + 24
    rng = np.random.default_rng(9)
    q, k, v, length = make(rng, dev, 3, 4, S, 64, [S, KS, 77])
    held(q.bfloat16(), k.to(k_dtype), v.to(v_dtype), length, mu=7, tau=0.05,
         block_k=S, k_subtile=8)


@pytest.mark.cuda
def test_misaligned_cache_is_refused(dev):
    """A contiguous view at a storage offset of one element is not 16-byte
    aligned: the wrapper raises rather than copy or misread it."""
    rng = np.random.default_rng(3)
    q, k, v, length = make(rng, dev, 1, 2, 64, 32, [40])
    flat = torch.empty(k.numel() + 1, device=dev)
    k_off = flat[1:].view(k.shape)
    k_off.copy_(k)
    with pytest.raises(ValueError, match="aligned"):
        FD.flash_decode(q, k_off, v, length, block_k=64, k_subtile=8)
