"""Blocked matmul with PS(mu) accumulation: the port of the TPU kernel
``repro/kernels/ps_matmul.py::ps_matmul`` (Pallas body ``_kernel``).

(M, K) @ (K, N) in FP32, each output's running accumulator rounded to
PS(mu) after the FP32 partial sum of every ``block_k`` slab of K is added
(no rounding at mu >= 23). On a CUDA tensor the wrapper launches the
hand-written kernel (``csrc/ps_matmul.cu``: 64 x 64 output tiles on the
CUDA cores, each slab summed lane by lane in k order) or raises; on a CPU
tensor it runs ``ps_matmul_plain``, which spells the kernel's order
(``slab_sums``), so the two agree bit for bit. bfloat16 inputs are widened
to float32 by the wrapper before the launch (exact, but one extra pass over
the inputs). What bounds the kernel on the H100: its 2 M N K FP32
operations.

Against the JAX kernel the order inside a slab differs (XLA's dot): where
that sum sits on a PS(mu) rounding midpoint, an output can move by one
PS(mu) step (tests/test_torch_micro_kernels.py counts them).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.numerics import check_mu, round_to_mantissa


def slab_sums(a: torch.Tensor, b: torch.Tensor, mu: int,
              granularity: int) -> torch.Tensor:
    """Batched (..., M, K) @ (..., K, N) -> (..., M, N) float32 in the CUDA
    kernels' order: inside each slab of `granularity` lanes every product
    and every sum is rounded to FP32, k ascending, from a zero partial; the
    running accumulator is rounded to PS(mu) after each slab is added (not
    at mu >= 23). ps_matmul's plain version, and y_low as the attention
    kernels sum it lane by lane (``dot_low_chunked``)."""
    a = a.float()
    b = b.float()
    K = a.shape[-1]
    if b.shape[-2] != K:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]) + \
        (a.shape[-2], b.shape[-1])
    acc = torch.zeros(shape, dtype=torch.float32, device=a.device)
    for s in range(0, K, granularity):
        part = torch.zeros_like(acc)
        for k in range(s, min(s + granularity, K)):
            part = part + a[..., :, k:k + 1] * b[..., k:k + 1, :]
        acc = acc + part
        if mu < 23:
            acc = round_to_mantissa(acc, mu)
    return acc


def _blocks(a, b, block_m, block_n, block_k) -> Tuple[int, int, int]:
    """The JAX wrapper's shape checks; returns (M, N, K)."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"ps_matmul takes (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    bm, bn, bk = min(block_m, M), min(block_n, N), min(block_k, K)
    if min(bm, bn, bk) < 1 or M % bm or N % bn or K % bk:
        raise ValueError(f"{(M, N, K)} not divisible by blocks {(bm, bn, bk)}")
    return M, N, K


def ps_matmul_plain(a: torch.Tensor, b: torch.Tensor, *, mu: int = 7,
                    block_m: int = 128, block_n: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Plain PyTorch version (``kernels/ref.py::ps_matmul_ref``, with the
    kernel's order inside a slab)."""
    check_mu(mu)
    _, _, K = _blocks(a, b, block_m, block_n, block_k)
    return slab_sums(a, b, mu, min(block_k, K))


def prepare_launch(a: torch.Tensor, b: torch.Tensor, *, mu: int = 7,
                   block_k: int = 128):
    """Check, allocate and bind (the blocks already checked). Returns
    (launch, out): each `launch()` enqueues the kernel on the current stream
    (without counting it), raises if it is refused and returns 1."""
    from repro_torch.kernels import build

    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    for name, t in (("a", a), ("b", b)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"ps_matmul takes float32 or bfloat16, got {name} "
                            f"{t.dtype}")
    a32 = a.to(torch.float32).contiguous()
    b32 = b.to(torch.float32).contiguous()
    M, K = a32.shape
    N = b32.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    fn = build.load("ps_matmul.cu").lamp_ps_matmul
    args = (a32.data_ptr(), b32.data_ptr(), out.data_ptr(), M, N, K, mu,
            min(block_k, K), torch.cuda.current_stream(a.device).cuda_stream)

    def launch() -> int:
        build.check_launch(fn(*args), "ps_matmul")
        return 1

    launch.keepalive = (a32, b32, out)
    return launch, out


def ps_matmul(a: torch.Tensor, b: torch.Tensor, *, mu: int = 7,
              block_m: int = 128, block_n: int = 128,
              block_k: int = 128) -> torch.Tensor:
    """a (M, K) @ b (K, N) -> (M, N) float32 on the PS(mu) grid. The blocks
    must divide M, N and K (each capped at its dimension, as in JAX);
    block_k fixes the rounding points, block_m and block_n change no
    result.

    A CUDA tensor launches the kernel and adds one to
    ``ps_matmul.launches``; a CPU tensor runs the plain version."""
    check_mu(mu)
    _blocks(a, b, block_m, block_n, block_k)
    if a.device.type == "cpu":
        return ps_matmul_plain(a, b, mu=mu, block_m=block_m, block_n=block_n,
                               block_k=block_k)
    if a.device.type != "cuda":
        raise ValueError(f"no ps_matmul kernel for device {a.device}")
    launch, out = prepare_launch(a, b, mu=mu, block_k=block_k)
    _wrapper.launches += launch()
    return out


ps_matmul.launches = 0
_wrapper = ps_matmul
