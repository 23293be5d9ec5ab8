"""RMSNorm with FP32 statistics: the port of the TPU kernel
``repro/kernels/rmsnorm.py::rmsnorm`` (Pallas body ``_kernel``).

``out = x * rsqrt(mean(x^2) + eps) * (1 + w)`` over the last axis, in x's
dtype. On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/rmsnorm.cu``) or raises; on a CPU tensor it runs
``rmsnorm_plain``. The kernel reads x and writes out in x's own dtype
(float32, bfloat16 or float16). On its vector path two warps hold a row in
registers as 16-byte vectors, sum x^2 with shuffles and one barrier and
write the row from the registers; rows that are not whole 16-byte vectors,
tensors not 16-byte aligned and rows past 16 KB (``VEC_MAX_BYTES``) take
the general path, a thread block a row. What bounds the kernel on the
H100: bytes (x read once, out written once).
"""

from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
VEC_MAX_BYTES = 16384     # csrc/rmsnorm.cu's: the vector path's row budget
ROW_WARPS = 2             # csrc/rmsnorm.cu's: warps a row on the vector path


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version (``kernels/ref.py::rmsnorm_ref``)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def prepare_launch(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
                   lib=None):
    """Check the inputs, allocate the output and bind the kernel's
    arguments. Returns (launch, out): each `launch()` enqueues the kernel on
    the current stream (without counting it), raises if it is refused and
    returns 1. `lib` is the loaded kernel library, the built
    ``csrc/rmsnorm.cu`` unless a measurement passes a variant's
    (``launch.rmsnorm_variants``)."""
    from repro_torch.kernels import build

    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"rmsnorm kernel takes float32, bfloat16 or float16, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    d = x.shape[-1]
    if w.shape != (d,) or w.device != x.device:
        raise ValueError(f"w must be ({d},) on {x.device}, got "
                         f"{tuple(w.shape)} on {w.device}")
    w32 = w.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    fn = (lib or build.load("rmsnorm.cu")).lamp_rmsnorm
    args = (x.data_ptr(), w32.data_ptr(), out.data_ptr(), x.numel() // max(d, 1),
            d, DTYPE_CODES[x.dtype], float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)

    def launch() -> int:
        build.check_launch(fn(*args), "rmsnorm")
        return 1

    launch.keepalive = (x, w32, out)     # the bound pointers must stay valid
    return launch, out


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            block_rows: int = 256) -> torch.Tensor:
    """x (..., d), w (d,) -> out (..., d) in x's dtype. `block_rows` (the
    TPU's row tile) changes no result.

    A CUDA tensor launches the kernel and adds one to ``rmsnorm.launches``;
    a CPU tensor runs the plain version."""
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"no rmsnorm kernel for device {x.device}")
    launch, out = prepare_launch(x, w, eps=eps)
    _wrapper.launches += launch()
    return out


rmsnorm.launches = 0
_wrapper = rmsnorm
