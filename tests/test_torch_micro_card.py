"""The CUDA kernels of the kernel micro-benchmark (flash_decode,
lamp_flash_attention, ps_matmul, rmsnorm) against their plain versions, on
a card.

These tests import no JAX (the machine with the card has none), so they run
there with the repository's conftest left out:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \
        tests/test_torch_micro_card.py

Without a card they skip. Tolerances (those of
``repro_torch.launch.kernels_micro``): attention outputs rtol 2e-5 / atol
2e-6 on every query row and counts exact at every k_subtile, since kernel
and plain version sum y_low in the same order (``slab_sums``); rmsnorm
within rtol 1e-6 in float32 and one step (rtol 2e-2) in bfloat16 and
float16. ps_matmul, on the tensor cores, is held to its one-PS(mu)-step
slack in tests/test_torch_ps_matmul_card.py.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import lamp_attention as LA
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
        res = KM.compare_rows(out, cnt, ref, cref)
        assert res["ok"] and res["apart_rows"] == 0, res
        assert torch.equal(cnt.float(), cref.float())
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
    res = KM.compare_rows(out, cnt, ref, cref)
    assert res["ok"] and res["apart_rows"] == 0, res
    assert torch.equal(cnt.float(), cref.float())


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
