"""Blocked matmul with PS(mu) accumulation: the port of the TPU kernel
``repro/kernels/ps_matmul.py::ps_matmul`` (Pallas body ``_kernel``).

(M, K) @ (K, N) in FP32, each output's running accumulator rounded to
PS(mu) after the FP32 partial sum of every ``block_k`` slab of K is added
(no rounding at mu >= 23). On a CUDA tensor the wrapper launches the
hand-written kernel (``csrc/ps_matmul.cu``: 64 x 64 output tiles on the
tensor cores, each slab summed in 3xTF32 by ``mma.sync``) or raises; on a
CPU tensor it runs ``ps_matmul_plain``, which sums each slab lane by lane
in k order (``core.mixed_matmul.slab_sums``). bfloat16 inputs are widened
to float32 by the wrapper before the launch (exact, but one extra pass over
the inputs). What bounds the kernel on the H100: its 3 x 2 M N K
operations at the dense TF32 rate.

The kernel sums a slab in the tensor cores' order, the plain version and
the JAX kernel (XLA's dot) each in their own: where a running accumulator
sits on a PS(mu) rounding midpoint, the FP32 roundoff between two orders
tips it one PS(mu) step apart, and the step carries to the output. Such
outputs are few, each within 2^(1-mu) (|A| @ |B|)
(``launch/kernels_micro.py`` and tests/test_torch_ps_matmul_card.py hold
the kernel to that; tests/test_torch_micro_kernels.py the plain version
against JAX). NaN and Inf operands give the plain version's NaN and Inf:
a warp that meets one sums its outputs again in the plain version's
order.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.mixed_matmul import slab_sums
from repro_torch.core.numerics import check_mu


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
    """Plain PyTorch version (``kernels/ref.py::ps_matmul_ref``, each slab
    summed lane by lane in k order): the oracle the kernel is held to."""
    check_mu(mu)
    _, _, K = _blocks(a, b, block_m, block_n, block_k)
    return slab_sums(a, b, mu, min(block_k, K))


def tf32_split_device(x: torch.Tensor) -> torch.Tensor:
    """The kernel's split of a CUDA float32 tensor into tf32 hi and lo,
    beside cvt.rna.tf32.f32's (the exported test entry of the kernel
    library): (n, 5) int32, the bits of hi, lo, hi_cvt, lo_cvt, and 1 where
    the split flags x as not finite (NaN, Inf, or hi past FLT_MAX)."""
    from repro_torch.kernels import build

    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError("tf32_split_device takes a CUDA float32 tensor")
    x = x.contiguous().view(-1)
    out = torch.empty((x.numel(), 5), dtype=torch.int32, device=x.device)
    build.check_launch(build.load("ps_matmul.cu").lamp_tf32_split(
        x.data_ptr(), out.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream), "tf32_split")
    return out


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
