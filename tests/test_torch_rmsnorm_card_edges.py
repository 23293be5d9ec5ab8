"""The rmsnorm kernel (csrc/rmsnorm.cu) at its edges, on a card: register
buckets of the vector path, a misaligned storage offset, and 1 and 100,000
rows, against the plain version with ``test_torch_rmsnorm_card.py``'s
helpers and tolerance. Without a card they skip; run them on one as that
file says:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_rmsnorm_card_edges.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import rmsnorm as RN
from test_torch_rmsnorm_card import DTYPES, dev, held, rand, tol  # noqa: F401


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
