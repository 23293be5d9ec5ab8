"""The tensor-core ps_matmul kernel (csrc/ps_matmul.cu) against its plain
version, ``core.mixed_matmul.slab_sums``, on a card.

These tests import no JAX (the machine with the card has none), so they run
there with the repository's conftest left out:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_ps_matmul_card.py

Without a card they skip. The kernel sums each block_k slab in 3xTF32 on
the tensor cores, the plain version lane by lane in k order; where a
running accumulator sits on a PS(mu) rounding midpoint the two round one
PS(mu) step apart. The slack (``kernels_micro.ps_matmul_slack``): at
mu < 23 at most max(2, 0.1% of M N) outputs differ, each within
2^(1-mu) (|A| @ |B|); at mu 23 every output within 2e-6 (|A| @ |B|); NaN
and Inf where the plain version has them. (The kernel's tf32 rounding is
held to cvt.rna.tf32.f32's bits by chip_smoke.py, phase round.)
"""

import numpy as np
import pytest
import torch

from repro_torch.core.mixed_matmul import slab_sums
from repro_torch.kernels import ps_matmul as PM
from repro_torch.launch import kernels_micro as KM

# (M, K, N, block_k, variant), both walks of K in the kernel: tiles cut by
# M 96 and N 80 (K 80: general); a slab of the whole K (tiled); bfloat16
# inputs widened (tiled); slabs of 16 inside staged tiles of 32 (general);
# a slab of 12, its last k-step of 8 zero-padded (general); a slab of 6
# with N 37 (4-byte copies of A and B rows); an A that starts 4 bytes into
# its storage (4-byte copies); the full width of GPT-2 small's MLP
# up-projection on a 1024-token prefill (tiled); NaN and Inf operands
# (tiled, general)
SHAPES = [(96, 80, 48, 16, None), (64, 96, 80, 96, None),
          (128, 64, 64, 32, "bf16"), (96, 64, 80, 16, None),
          (72, 48, 40, 12, None), (40, 30, 37, 6, None),
          (64, 32, 48, 16, "offset"), (1024, 768, 3072, 128, None),
          (64, 64, 48, 32, "nonfinite"), (40, 30, 37, 6, "nonfinite")]


def with_nonfinite(a, b):
    """NaN and Inf among finite operands: the GPU's NaN 0x7fffffff (which a
    plain tf32 rounding would wrap into a zero) and 0xffffffff in A; an Inf
    in B (Inf outputs); Inf times 0 and Inf against -Inf (NaN outputs);
    FLT_MAX, whose tf32 rounding overflows (finite outputs)."""
    a, b = a.clone(), b.clone()
    ai = a.view(torch.int32)
    ai[1, 2] = 0x7FFFFFFF
    ai[5, 3] = -1                          # 0xffffffff
    b[4, 10] = float("inf")
    a[9, 5], b[5, 20] = float("inf"), 0.0
    a[13, 6], a[13, 7] = float("inf"), -float("inf")
    a[17, 2], b[2] = torch.finfo(torch.float32).max, 0.5
    return a, b


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s[:4]))
                         + (f"-{s[4]}" if s[4] else ""))
def test_ps_matmul_within_one_step_on_card(dev, shape):
    """mu 4, 7 and 23."""
    M, K, N, bk, variant = shape
    for mu in (4, 7, 23):
        rng = np.random.default_rng(M + K + N + bk + mu)
        a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)).to(dev)
        if variant == "bf16":
            a, b = a.bfloat16(), b.bfloat16()
        if variant == "offset":
            a = torch.cat([a.new_zeros(1), a.flatten()])[1:].view(M, K)
            assert a.is_contiguous() and a.data_ptr() % 16 == 4
        if variant == "nonfinite":
            a, b = with_nonfinite(a, b)
        before = PM.ps_matmul.launches
        out = PM.ps_matmul(a, b, mu=mu, block_m=M, block_n=N, block_k=bk)
        torch.cuda.synchronize()
        assert PM.ps_matmul.launches == before + 1
        ref = slab_sums(a, b, mu, bk)
        assert out.dtype == torch.float32 and out.shape == (M, N)
        if variant == "nonfinite":
            assert torch.isnan(ref).any() and torch.isinf(ref).any()
            assert torch.isfinite(ref[17]).sum() > N // 2
        res = KM.ps_matmul_slack(out, ref, a, b, mu)
        assert res["ok"], (mu, res)

