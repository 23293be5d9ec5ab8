"""The Hopper lamp_flash_attention kernel (csrc/lamp_attention.cu) at its
edges, on a card: NaN and Inf in V, a probability below FLT_MIN times an
Inf, the shared memory of every block_k, and the micro-benchmark's two lamp
rows against a float64 reference (closer to it than the plain version is,
with its FP32 arm in the kernel's order or taken by ``torch.matmul``).
Without a card they skip; run them on one as
``test_torch_lamp_attention_card.py`` says:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_lamp_attention_card_edges.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import lamp_attention as LA
from repro_torch.launch import kernels_micro as KM
from repro_torch.launch import lamp_attention_variants as LV
from test_torch_lamp_attention_card import dev, rand, run_both  # noqa: F401


def poison(v, causal):
    """Non-finite V values in keys every query row attends to (key 0 under
    the causal mask): the GPU's NaN 0x7fffffff in column 5, +Inf in column
    7, +Inf and -Inf in column 9 (keys 0 and 1, or 3 and 17)."""
    v = v.clone()
    vi = v.view(torch.int32)
    vi[:, :, 0, 5] = 0x7FFFFFFF
    v[:, :, 0, 7] = float("inf")
    a, b = (0, 1) if causal else (3, 17)
    v[:, :, a, 9] = float("inf")
    v[:, :, b, 9] = -float("inf")
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,bk", [(96, 32), (256, 128), (512, 256)])
def test_lamp_attention_nonfinite_v_as_fp32(dev, causal, T, bk):
    rng = np.random.default_rng(T + bk + causal)
    q, k = rand(rng, (1, 2, T, 64), dev, 1.5), rand(rng, (1, 2, T, 64), dev, 1.5)
    v = poison(rand(rng, (1, 2, T, 64), dev), causal)
    kw = dict(mu=7, tau=0.05, causal=causal, block_q=T, block_k=bk, k_subtile=32)
    out, cnt, ref, cref = run_both(q, k, v, **kw)
    assert torch.isnan(ref[..., 5]).all() and torch.isinf(ref[..., 7]).all()
    assert torch.isnan(ref[..., 9]).all()
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    inf = torch.isinf(ref)
    assert torch.equal(out[inf], ref[inf])
    fin = torch.isfinite(ref)
    err = (out - ref).abs()[fin]
    assert bool((err <= 2e-6 + 2e-5 * ref.abs()[fin]).all())
    assert torch.equal(cnt, cref.to(cnt.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,bk", [(96, 32), (256, 128), (512, 256)])
def test_lamp_attention_tiny_p_times_inf_v_as_fp32(dev, causal, T, bk):
    """p = exp(y - m) below FLT_MIN times an Inf in V: logit gaps of 90
    (p subnormal) and 100 (p below tf32's smallest step) give an Inf, a gap
    of 110 (p 0 in FP32) a NaN, as in FP32. All rows' logits are exact: q
    is 8 e_0, so y = k[:, 0] after the 1/8 scale."""
    D = 64
    rng = np.random.default_rng(T + bk)
    q = torch.zeros((1, 1, T, D))
    q[..., 0] = 8.0
    k = torch.zeros((1, 1, T, D))
    k[..., 0] = torch.from_numpy(rng.choice([-4.0, -3.0, -1.0, 2.0, 3.0], T)
                                 .astype(np.float32))
    k[0, 0, :4, 0] = torch.tensor([10.0, -80.0, -90.0, -100.0])
    v = torch.from_numpy(rng.standard_normal((1, 1, T, D)).astype(np.float32))
    for key, col in ((1, 3), (2, 5), (3, 7)):
        v[0, 0, key, col] = float("inf")
    q, k, v = q.to(dev), k.to(dev), v.to(dev)
    kw = dict(mu=7, tau=0.05, causal=causal, block_q=T, block_k=bk, k_subtile=32)
    out, cnt, ref, cref = run_both(q, k, v, **kw)
    live = slice(3, None)          # rows that see keys 0-3 under either mask
    assert torch.isinf(ref[..., live, 3]).all() and torch.isinf(ref[..., live, 5]).all()
    assert torch.isnan(ref[..., live, 7]).all()
    assert torch.equal(torch.isnan(out[..., live, :]), torch.isnan(ref[..., live, :]))
    inf = torch.isinf(ref[..., live, :])
    assert torch.equal(out[..., live, :][inf], ref[..., live, :][inf])
    fin = torch.isfinite(ref)
    err = (out - ref).abs()[fin]
    assert bool((err <= 2e-6 + 2e-5 * ref.abs()[fin]).all())
    assert torch.equal(cnt, cref.to(cnt.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,bk,seed", LV.ROWS, ids=["gpt2_prefill_1024", "256"])
@pytest.mark.parametrize("mu", [7, 23])
def test_lamp_attention_micro_rows_closer_to_float64_than_plain(dev, shape, bk, seed, mu):
    """The micro-benchmark's lamp rows, with their inputs, against a float64
    reference (the plain version's selection; y_exact, the softmax and P.V
    in float64): every row within the tolerance, and the kernel no farther
    from it than the plain version, nor than the plain version with its
    FP32 arm taken by ``torch.matmul`` (cuBLAS's order, not the kernel's
    chunk sums). Its margin against the plain version does not rest on the
    two sharing y_exact's order."""
    q, k, v = LV.row_inputs(shape, seed, dev)
    kw = dict(mu=mu, tau=0.05, causal=True, block_k=bk, k_subtile=32)
    out, cnt = LA.lamp_flash_attention(q, k, v, reduce=False, block_q=shape[2], **kw)
    ref, _ = LA.lamp_flash_attention_plain(q, k, v, reduce=False, block_q=shape[2], **kw)
    ref_mm, _ = LV.other_plain(q, k, v, arm="matmul", **kw)
    ref64, cref64 = LV.other_plain(q, k, v, arm="float64", **kw)
    res = KM.compare_rows(out, cnt, ref64, cref64)
    assert res["ok"] and res["apart_rows"] == 0 and res["count_diff"] == 0, res
    err = {n: (t.double() - ref64).abs().max().item()
           for n, t in (("kernel", out), ("plain", ref), ("matmul_arm", ref_mm))}
    assert err["kernel"] <= min(err["plain"], err["matmul_arm"]), err


@pytest.mark.cuda
def test_lamp_attention_shared_memory_fits_every_block_k(dev):
    """Every head dim the kernel takes and every block_k fit the card's
    232,448 bytes: a k-block longer than a tile is walked twice and keeps
    nothing in shared memory."""
    lib = build.load("lamp_attention.cu")
    for D in (4, 32, 64, 96, 128):
        for bk in (1, 8, 48, 64, 96, 128, 129, 256, 512, 1024, 4096, 1 << 20):
            assert 0 < lib.lamp_flash_attention_smem(D, bk) <= LA.SMEM_LIMIT, (D, bk)
