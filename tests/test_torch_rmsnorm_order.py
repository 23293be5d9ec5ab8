"""The rmsnorm kernel's sums of x^2 (csrc/rmsnorm.cu), emulated in numpy
on the CPU, against the plain version and against JAX's kernel.

The kernel has two paths, and ``emulate`` spells out the order of each in
float32 (every product and every sum rounded):
- the vector path (a row that is a whole number of 16-byte vectors and at
  most ``VEC_MAX_BYTES``, tensors 16-byte aligned): ``ROW_WARPS`` (2)
  warps a row; thread r of the row's 64 sums x^2 over its vectors r,
  r + 64, ..., each vector's elements in order, from 0; each warp's 32
  sums meet in an xor butterfly of shuffles, and the row's two warp sums
  are added in warp order;
- the general path: 256 threads a row; thread t sums x^2 over the
  elements t, t + 256, ...; each warp's 32 sums meet in an xor butterfly,
  and the 8 warp sums are added in warp order, from 0.
Then r = rsqrt(sum / d + eps) (torch's rsqrt, as the plain version's; the
card's rsqrtf is held to tolerance by tests/test_torch_rmsnorm_card.py)
and out = (x r)(1 + w), rounded to x's dtype.

Tolerance (``kernels_micro.RMS_TOL``'s): rtol 1e-6 in float32 and one step
of the output type (rtol 2e-2) in bfloat16 and float16, against both.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as JOPS
from repro_torch.kernels import build
from repro_torch.kernels import rmsnorm as RN

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
EPS = 1e-6


def butterfly(x):
    """An xor-shuffle sum over the last axis (32 lanes): lane 0's."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = x + x[..., lanes ^ o]
    return x[..., 0]


def strided_sums(x, lanes):
    """(rows, lanes) float32: lane l's sum of x^2 over the columns l,
    l + lanes, ..., in order, from 0."""
    rows, n = x.shape
    ss = np.zeros((rows, lanes), np.float32)
    for j in range(0, n, lanes):
        cols = np.arange(j, j + lanes)
        ok = cols < n
        sq = x[:, np.minimum(cols, n - 1)] ** 2
        ss = np.where(ok, ss + sq, ss).astype(np.float32)
    return ss


def vector_path(d, elem):
    return d % (16 // elem) == 0 and d * elem <= RN.VEC_MAX_BYTES


def emulate(x, w, elem):
    """x (rows, d) float32 (the input's values), w (d,) float32 -> the
    kernel's output in float32, before its rounding to x's dtype."""
    rows, d = x.shape
    if vector_path(d, elem):
        n, rt = 16 // elem, 32 * RN.ROW_WARPS           # elements a vector, threads a row
        nvec = d // n
        ss = np.zeros((rows, rt), np.float32)            # thread r: vectors r, r + rt, ...
        for j in range(0, nvec, rt):
            vecs = np.arange(j, j + rt)
            ok = vecs < nvec
            for e in range(n):
                cols = np.minimum(vecs, nvec - 1) * n + e
                ss = np.where(ok, ss + x[:, cols] ** 2, ss).astype(np.float32)
        warps = butterfly(ss.reshape(rows, RN.ROW_WARPS, 32))
        total = warps[:, 0]
        for j in range(1, RN.ROW_WARPS):
            total = (total + warps[:, j]).astype(np.float32)
    else:
        warps = butterfly(strided_sums(x, 256).reshape(rows, 8, 32))
        total = np.zeros(rows, np.float32)
        for j in range(8):
            total = (total + warps[:, j]).astype(np.float32)
    var = torch.from_numpy(total / np.float32(d))
    r = torch.rsqrt(var + EPS).numpy()[:, None]
    return (x * r) * (np.float32(1) + w)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [1, 7, 100, 512, 3072])
def test_kernel_order_matches_plain_and_jax(dtype, d):
    """d 1 and 7 take the general path; 100 the vector path in float32
    only; 512 and 3072 the vector path."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((6, d)).astype(np.float32)).to(tdt)
    w = (rng.standard_normal(d) * 0.1).astype(np.float32)
    xf = x.float().numpy()
    got = torch.from_numpy(emulate(xf, w, x.element_size())).to(tdt).float()
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else \
        dict(rtol=2e-2, atol=1e-6)
    plain = RN.rmsnorm_plain(x, torch.from_numpy(w)).float()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **tol)
    want = JOPS.rmsnorm(jnp.asarray(xf).astype(jdt), jnp.asarray(w), eps=EPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.astype(jnp.float32)),
                               **tol)


def test_vector_path_constants_are_the_kernels():
    """VEC_MAX_BYTES, which these emulations and the card tests choose the
    path by, and ROW_WARPS, which sets the vector path's order, are
    csrc/rmsnorm.cu's."""
    with open(os.path.join(build.CSRC, "rmsnorm.cu")) as f:
        src = f.read()
    for name in ("VEC_MAX_BYTES", "ROW_WARPS"):
        got = int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
        assert got == getattr(RN, name), name
