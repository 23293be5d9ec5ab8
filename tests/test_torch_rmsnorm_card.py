"""The rmsnorm kernel (csrc/rmsnorm.cu) against its plain version, on a
card: both of its paths (the vector path, two warps a row in 16-byte
vectors, and the general path, a thread block a row) in float32, bfloat16
and float16, register buckets of the vector path, a misaligned storage
offset, and 1 and 100,000 rows.

These tests import no JAX (the machine with the card has none), so they run
there with the repository's conftest left out:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_rmsnorm_card.py

Without a card they skip. Tolerance (``kernels_micro.RMS_TOL``'s): rtol
1e-6 in float32 and one step of the output type (rtol 2e-2) otherwise.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import rmsnorm as RN

DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def tol(dtype):
    return dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32 else \
        dict(rtol=2e-2, atol=1e-6)


def rand(rng, shape, dev, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).to(dev)


def vector_path(x, w, out) -> bool:
    """Whether the kernel takes its vector path for these tensors."""
    fn = build.load("rmsnorm.cu").lamp_rmsnorm_vector_path
    return bool(fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[-1],
                   RN.DTYPE_CODES[x.dtype]))


def expect_vector(d, dtype) -> bool:
    elem = torch.empty((), dtype=dtype).element_size()
    return d % (16 // elem) == 0 and d * elem <= RN.VEC_MAX_BYTES


def held(x, w, path):
    before = RN.rmsnorm.launches
    out = RN.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert RN.rmsnorm.launches == before + 1
    assert out.dtype == x.dtype and out.shape == x.shape
    assert vector_path(x, w, out) == path
    torch.testing.assert_close(out.float(), RN.rmsnorm_plain(x, w).float(),
                               **tol(x.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 7, 100, 512, 3072, 8200])
def test_both_paths(dev, dtype, d):
    """d 1 and 7: general; 100: vector in float32 only; 512 and 3072:
    vector; 8200: past the register budget, general."""
    rng = np.random.default_rng(d)
    x = rand(rng, (37, d), dev).to(dtype)
    w = rand(rng, (d,), dev, 0.1)
    held(x, w, expect_vector(d, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2048, 4096, 8192])
def test_vector_buckets(dev, d):
    """4, 8 and 16 vectors a thread in bfloat16 and float16, the last at
    the register budget's edge (d 512 and 3072 take 1 and 6)."""
    rng = np.random.default_rng(d + 1)
    w = rand(rng, (d,), dev, 0.1)
    for dtype in (torch.bfloat16, torch.float16):
        held(rand(rng, (19, d), dev).to(dtype), w, True)


@pytest.mark.cuda
def test_misaligned_storage_offset(dev):
    """A contiguous view one element into its storage takes the general
    path and gives the same result as an aligned copy."""
    rng = np.random.default_rng(11)
    w = rand(rng, (512,), dev, 0.1)
    for dtype in DTYPES:
        flat = rand(rng, (9 * 512 + 1,), dev).to(dtype)
        x = flat[1:].view(9, 512)
        assert x.data_ptr() % 16 != 0
        held(x, w, False)
        aligned = RN.rmsnorm(x.clone(), w)
        torch.testing.assert_close(RN.rmsnorm(x, w).float(), aligned.float(),
                                   **tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 100_000])
def test_one_row_and_many(dev, rows):
    """One row (two warps of one block) and 100,000 rows (blocks walking
    the rows at the grid's stride)."""
    rng = np.random.default_rng(rows)
    w = rand(rng, (512,), dev, 0.1)
    held(rand(rng, (rows, 512), dev).bfloat16(), w, True)
    held(rand(rng, (rows, 100), dev), w[:100].clone(), True)
