"""The Hopper lamp_flash_attention kernel (csrc/lamp_attention.cu) against
its plain version, on a card.

These tests import no JAX (the machine with the card has none), so they run
there with the repository's conftest left out:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_lamp_attention_card.py

Without a card they skip. Kernel and plain version compute y_low and
y_exact bit for bit alike (chunk partials, ``slab_sums``' order), so the
counts must be exact; they differ only in the softmax's order and in P.V,
which the kernel takes on the tensor cores in 3xTF32: every query row
within rtol 2e-5 / atol 2e-6 (``kernels_micro.compare_rows``). The cases
spread over the kernel's three walks -- a tile of one k-block (block_k 65
to 128), a tile of several (smaller block_k), a k-block over several
tiles (block_k 256 to S) -- and launch each of its 12 instantiations
(float4 or lane-by-lane chunks, D up to 64 or above). Non-finite values,
the shared memory of every block_k and the float64 reference are in
``test_torch_lamp_attention_card_edges.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import lamp_attention as LA
from repro_torch.launch import kernels_micro as KM


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def rand(rng, shape, dev, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).to(dev)


def run_both(q, k, v, **kw):
    """The kernel (one launch, counted) and the plain version."""
    before = LA.lamp_flash_attention.launches
    out, cnt = LA.lamp_flash_attention(q, k, v, reduce=False, **kw)
    torch.cuda.synchronize()
    assert LA.lamp_flash_attention.launches == before + 1
    ref, cref = LA.lamp_flash_attention_plain(q, k, v, reduce=False, **kw)
    return out, cnt, ref, cref


# (B, H, T, S, D, block_k, k_subtile, mu, causal, dtype)
CASES = [
    (1, 2, 40, 40, 32, 8, 1, 4, True, "f32"),         # 16 k-blocks a tile, T off 32
    (2, 3, 96, 96, 64, 32, 24, 7, True, "f32"),       # 4 a tile; chunks 24, 24, 16
    (1, 2, 96, 96, 128, 128, 32, 23, False, "f32"),   # block_k capped at S: 96
    (1, 2, 1024, 1024, 64, 128, 32, 7, True, "f32"),  # the micro row's walk
    (1, 2, 1024, 1024, 64, 256, 1, 4, True, "f32"),   # a k-block over two tiles
    (1, 2, 96, 192, 64, 96, 1, 7, True, "f32"),       # S != T
    (1, 2, 40, 40, 128, 64, 64, 23, False, "f32"),    # block_k capped at S: 40
    (1, 3, 1024, 1024, 32, 64, 24, 23, False, "f32"),
    (1, 2, 96, 96, 64, 32, 32, 7, True, "bf16"),
    (1, 1, 96, 48, 64, 256, 32, 4, True, "f32"),      # S < T, block_k 48
    (1, 2, 96, 96, 128, 96, 1, 7, True, "f32"),       # lane-by-lane chunks, one k-block a tile
    (1, 2, 96, 96, 128, 32, 5, 4, True, "f32"),       # chunks of 5, one K stage
    (1, 1, 512, 512, 96, 256, 1, 7, False, "f32"),    # D 96: k-blocks over tiles
    (1, 1, 256, 256, 96, 256, 32, 23, True, "f32"),
    (1, 2, 1024, 1024, 64, 512, 32, 7, True, "f32"),  # k-blocks of 4 tiles
    (1, 1, 512, 512, 128, 512, 8, 23, False, "f32"),  # one k-block of S, D 128
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_lamp_attention_kernel_matches_plain(dev, case):
    B, H, T, S, D, bk, sub, mu, causal, dtype = case
    rng = np.random.default_rng(T + S + D + bk + sub + mu)
    q = rand(rng, (B, H, T, D), dev, 1.5)
    k, v = rand(rng, (B, H, S, D), dev, 1.5), rand(rng, (B, H, S, D), dev)
    if dtype == "bf16":
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    kw = dict(mu=mu, tau=0.05, causal=causal, block_q=T, block_k=bk, k_subtile=sub)
    out, cnt, ref, cref = run_both(q, k, v, **kw)
    res = KM.compare_rows(out, cnt, ref, cref)
    assert res["ok"] and res["apart_rows"] == 0 and res["count_diff"] == 0, res
    assert torch.equal(cnt.float(), cref.float())
    assert float(cref.sum()) > 0


@pytest.mark.cuda
def test_lamp_attention_registers_and_spills(dev):
    """ptxas: at most 128 registers a thread (two 256-thread blocks an SM)
    in every instantiation, and no spill stores in the one the
    micro-benchmark's full-width row runs (k_subtile % 4 == 0, one
    k-block a tile, D <= 64)."""
    usage = {n: u for n, u in build.ptxas_usage("lamp_attention.cu").items()
             if "lamp_attention_kernel" in n}
    assert len(usage) == 12, usage
    assert all(u["registers"] <= 128 for u in usage.values()), usage
    full = [u for n, u in usage.items() if "ILb1ELi0ELi1E" in n]
    assert len(full) == 1 and full[0]["spill_stores"] == 0, usage
