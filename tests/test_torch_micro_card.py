"""The CUDA kernels of the kernel micro-benchmark (flash_decode,
lamp_flash_attention, ps_matmul, rmsnorm) against their plain versions, on
a card.

These tests import no JAX (the machine with the card has none), so they run
there with the repository's conftest left out:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \
        tests/test_torch_micro_card.py

Without a card they skip. Tolerances (those of
``repro_torch.launch.kernels_micro``): attention outputs rtol 2e-5 / atol
2e-6 and counts exact at k_subtile 1, where the kernel and ``dot_ps`` sum
y_low in the same order. At k_subtile > 1 the kernel sums a chunk lane by
lane and the plain version with cuBLAS, so a y_low on a PS(mu) midpoint can
round one step apart: such query rows are found by summing y_low both ways
(``kernels_micro.apart_keys``), their outputs held to atol 1e-2 and their
counts to the number of keys that round apart. ps_matmul is bit-exact;
rmsnorm within rtol 1e-6 in float32 and one step (rtol 2e-2) in bfloat16
and float16.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import lamp_attention as LA
from repro_torch.kernels import ps_matmul as PM
from repro_torch.kernels import rmsnorm as RN
from repro_torch.launch import kernels_micro as KM

TOL = dict(rtol=2e-5, atol=2e-6)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def rand(rng, shape, dev, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mu,sub", [(7, 1), (5, 16), (7, 32), (23, 32)])
def test_lamp_attention_matches_plain_on_card(dev, causal, mu, sub):
    """T 96 with k-blocks of 32 (tiles of 16 rows cut them), S 96; and a
    T 40 tile edge."""
    rng = np.random.default_rng(mu + sub)
    for B, H, T, D, bk in ((2, 3, 96, 64, 32), (1, 2, 40, 32, 8)):
        q, k = rand(rng, (B, H, T, D), dev, 1.5), rand(rng, (B, H, T, D), dev, 1.5)
        v = rand(rng, (B, H, T, D), dev)
        kw = dict(mu=mu, tau=0.05, causal=causal, block_q=T, block_k=bk,
                  k_subtile=sub)
        before = LA.lamp_flash_attention.launches
        out, cnt = LA.lamp_flash_attention(q, k, v, reduce=False, **kw)
        torch.cuda.synchronize()
        assert LA.lamp_flash_attention.launches == before + 1
        ref, cref = LA.lamp_flash_attention_plain(q, k, v, reduce=False, **kw)
        ok = torch.ones((T, T), dtype=torch.bool, device=dev)
        apart = KM.apart_keys(q, k, ok.tril() if causal else ok, mu, sub)
        if sub == 1:
            assert int(apart.sum()) == 0
        res = KM.compare_rows(out, cnt, ref, cref, apart)
        assert res["ok"], res
        assert float(cref.sum()) > 0


@pytest.mark.cuda
def test_lamp_attention_bf16_inputs_on_card(dev):
    rng = np.random.default_rng(8)
    q, k, v = (rand(rng, (1, 2, 64, 64), dev, 1.5).bfloat16() for _ in range(3))
    kw = dict(mu=7, tau=0.1, causal=True, block_q=16, block_k=16, k_subtile=1)
    out, n = LA.lamp_flash_attention(q, k, v, **kw)
    ref, nref = LA.lamp_flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(out, ref, **TOL)
    assert float(n) == float(nref)


@pytest.mark.cuda
@pytest.mark.parametrize("mu,sub", [(7, 1), (5, 8), (7, 32), (23, 32)])
def test_flash_decode_matches_plain_on_card(dev, mu, sub):
    """Lengths 0 (out 0), 1, a block edge, mid-block and full; keys past the
    length NaN-poisoned in the kernel's input."""
    rng = np.random.default_rng(20 + mu + sub)
    B, H, S, D = 5, 3, 256, 64
    q = rand(rng, (B, H, 1, D), dev, 1.5)
    k, v = rand(rng, (B, H, S, D), dev, 1.5), rand(rng, (B, H, S, D), dev)
    length = torch.tensor([0, 1, 64, 157, S], dtype=torch.int32, device=dev)
    ok = torch.arange(S, device=dev)[None, :] < length.long()[:, None]
    dead = ~ok[:, None, :, None]
    k_bad = k.masked_fill(dead, float("nan"))
    v_bad = v.masked_fill(dead, float("nan"))
    kw = dict(mu=mu, tau=0.05, block_k=64, k_subtile=sub)
    before = FD.flash_decode.launches
    out, cnt = FD.flash_decode(q, k_bad, v_bad, length, reduce=False, **kw)
    torch.cuda.synchronize()
    assert FD.flash_decode.launches == before + 2
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    ref, cref = FD.flash_decode_plain(q, k, v, length, reduce=False, **kw)
    apart = KM.apart_keys(q, k, ok[:, None, None, :], mu, sub)[..., 0]
    if sub == 1:
        assert int(apart.sum()) == 0
    res = KM.compare_rows(out, cnt, ref, cref, apart)
    assert res["ok"], res


@pytest.mark.cuda
@pytest.mark.parametrize("mu", [4, 7, 23])
def test_ps_matmul_bit_exact_on_card(dev, mu):
    """Tiles cut by M 96 and N 80; slabs of 16 and of the whole K; bf16
    inputs widened."""
    rng = np.random.default_rng(30 + mu)
    for M, K, N, bk, bf16 in ((96, 80, 48, 16, False), (64, 96, 80, 96, False),
                              (128, 64, 64, 32, True), (256, 256, 256, 128, False)):
        a, b = rand(rng, (M, K), dev), rand(rng, (K, N), dev)
        if bf16:
            a, b = a.bfloat16(), b.bfloat16()
        before = PM.ps_matmul.launches
        out = PM.ps_matmul(a, b, mu=mu, block_m=16, block_n=16, block_k=bk)
        torch.cuda.synchronize()
        assert PM.ps_matmul.launches == before + 1
        ref = PM.ps_matmul_plain(a, b, mu=mu, block_m=16, block_n=16, block_k=bk)
        assert torch.equal(out, ref), (out - ref).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_rmsnorm_on_card(dev, dtype):
    rng = np.random.default_rng(40)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32 else \
        dict(rtol=2e-2, atol=1e-6)
    for shape in ((3, 37, 128), (1024, 512), (7, 3072), (5, 100)):
        x = rand(rng, shape, dev).to(dtype)
        w = rand(rng, shape[-1:], dev, 0.1)
        before = RN.rmsnorm.launches
        out = RN.rmsnorm(x, w)
        torch.cuda.synchronize()
        assert RN.rmsnorm.launches == before + 1
        assert out.dtype == dtype and out.shape == x.shape
        torch.testing.assert_close(out.float(), RN.rmsnorm_plain(x, w).float(),
                                   **tol)


@pytest.mark.cuda
def test_micro_entry_point_on_card(dev):
    rows = KM.run("cuda")
    assert [r["name"] for r in rows] == list(KM.ROW_NAMES)
    assert all(r["ok"] for r in rows), [r for r in rows if not r["ok"]]
    assert all(r["ms"] > 0 for r in rows)
