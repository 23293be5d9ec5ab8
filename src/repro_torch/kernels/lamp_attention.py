"""One-pass relaxed-LAMP flash attention (the paper's Sec 4.4): the port of
the TPU kernel ``repro/kernels/lamp_attention.py::lamp_flash_attention``
(Pallas body ``_kernel``).

y_low is q . k summed in chunks of ``k_subtile`` lanes, each chunk lane by
lane in k order from a zero partial, the running sum rounded to PS(mu)
after each chunk (unrounded at mu >= 23). The keys of k-block ik
(``block_k`` keys) are selected against the running row max of s = y +
log|y| over k-blocks 0..ik -- one pass, so early blocks can only
over-select against the two-pass rule -- and the selected logits are
replaced by y_exact, the same chunk partials summed unrounded (in the
Pallas kernel "both values fall out of the same MXU pass"). Causal or not.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/lamp_attention.cu``: 32 query rows per thread block, y_low and
y_exact bit-exact on the CUDA cores in 4 x 4 register tiles, the online
softmax's P.V on the tensor cores in 3xTF32) or raises; on a CPU tensor it
runs ``lamp_flash_attention_plain``, which sums y_low and y_exact in the
kernel's order (``core.mixed_matmul.slab_sums``), so the two select the
same keys and differ only in the softmax's order and the 3xTF32 P.V.
bfloat16 inputs are widened to float32 by the wrapper before the launch
(exact, one extra pass over q, k and v). What bounds the kernel on the
H100: the CUDA-core work of bit-exact y_low per causal (query, key) pair.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.mixed_matmul import slab_sums
from repro_torch.core.numerics import check_mu

from .flash_decode import NEG, log_tau

# a block's dynamic shared memory on an H100 (227 KB)
SMEM_LIMIT = 232448


def _check(q, k, v, block_q: int, block_k: int, k_subtile: int):
    """The JAX wrapper's checks; returns (block_q, block_k) capped at T and
    S."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape or \
            k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (B, H, T, D) and (B, H, S, D)")
    T, S = q.shape[2], k.shape[2]
    bq, bk = min(block_q, T), min(block_k, S)
    if bq < 1 or bk < 1 or T % bq or S % bk:
        raise ValueError(f"T={T} % block_q={bq} or S={S} % block_k={bk}")
    if k_subtile < 1:
        raise ValueError(f"k_subtile must be >= 1, got {k_subtile}")
    return bq, bk


def lamp_flash_attention_plain(q, k, v, *, mu: int = 7, tau: float = 0.05,
                               causal: bool = True, block_q: int = 128,
                               block_k: int = 128, k_subtile: int = 32,
                               reduce: bool = True
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (``kernels/ref.py::lamp_flash_attention_ref``),
    vectorized over batch, heads and query rows: y_low and y_exact from
    ``slab_sums`` in chunks of `k_subtile` lanes (the kernel's order; y_exact
    is the chunks summed unrounded, mu 23), the running max as a cumulative
    max of the per-k-block row maxima, and the softmax taken whole (equal
    to the online one up to roundoff). Returns (out (B, H, T, D) float32,
    n_selected: a float32 scalar, or (B, H, T) per query row with
    reduce=False)."""
    _, bk = _check(q, k, v, block_q, block_k, k_subtile)
    B, H, T, D = q.shape
    S = k.shape[2]
    qf = q.float() * D ** -0.5
    kt = k.float().transpose(-1, -2)
    y_low = slab_sums(qf, kt, mu, k_subtile)                   # (B, H, T, S)
    if causal:
        ok = torch.arange(S, device=q.device)[None, :] <= \
            torch.arange(T, device=q.device)[:, None]
    else:
        ok = torch.ones((T, S), dtype=torch.bool, device=q.device)
    s = torch.where(ok, y_low + torch.log(y_low.abs()), NEG)
    run = s.view(B, H, T, S // bk, bk).amax(-1).cummax(-1).values.clamp_min(NEG)
    thr = (log_tau(tau) + run).repeat_interleave(bk, dim=-1)
    sel = ok & (s > thr)
    y = torch.where(sel, slab_sums(qf, kt, 23, k_subtile), y_low)
    y = torch.where(ok, y, NEG)
    p = torch.where(ok, torch.exp(y - y.amax(-1, keepdim=True)), 0.0)
    out = torch.matmul(p, v.float()) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    counts = sel.sum(-1)
    return out, (counts.sum() if reduce else counts).float()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy of it if its data does not start on 16 bytes (the
    kernel stages rows with 16-byte copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def prepare_launch(q, k, v, *, mu: int = 7, tau: float = 0.05,
                   causal: bool = True, block_k: int = 128,
                   k_subtile: int = 32):
    """Check, allocate and bind (block_k already capped at S and checked).
    Returns (launch, out, cnt): each `launch()` enqueues the kernel on the
    current stream (without counting it), raises if it is refused and
    returns 1; cnt is (B, H, T) int32."""
    from repro_torch.kernels import build

    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"lamp_flash_attention takes float32 or bfloat16, "
                            f"got {name} {t.dtype}")
    B, H, T, D = q.shape
    S = k.shape[2]
    if D > 128 or D % 4:
        raise ValueError(f"kernel takes D <= 128 and D % 4 == 0, got D={D}")
    lib = build.load("lamp_attention.cu")
    smem = lib.lamp_flash_attention_smem(D, block_k)
    if smem > SMEM_LIMIT:
        raise ValueError(f"block_k={block_k} needs {smem} bytes of shared "
                         f"memory per thread block, above the card's "
                         f"{SMEM_LIMIT}")
    q32, k32, v32 = (_aligned(t.to(torch.float32).contiguous()) for t in (q, k, v))
    out = torch.empty((B, H, T, D), dtype=torch.float32, device=dev)
    cnt = torch.empty((B, H, T), dtype=torch.int32, device=dev)
    fn = lib.lamp_flash_attention
    args = (q32.data_ptr(), k32.data_ptr(), v32.data_ptr(), out.data_ptr(),
            cnt.data_ptr(), B * H, T, S, D, mu, k_subtile, int(causal),
            block_k, log_tau(tau), D ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream)

    def launch() -> int:
        build.check_launch(fn(*args), "lamp_flash_attention")
        return 1

    launch.keepalive = (q32, k32, v32, out, cnt)
    return launch, out, cnt


def lamp_flash_attention(q, k, v, *, mu: int = 7, tau: float = 0.05,
                         causal: bool = True, block_q: int = 128,
                         block_k: int = 128, k_subtile: int = 32,
                         reduce: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, H, T, D), k and v (B, H, S, D) -> (out (B, H, T, D) float32,
    n_selected float32 scalar; (B, H, T) per query row with reduce=False).
    block_q must divide T and block_k S (each capped at its dimension, as
    in JAX); block_k fixes the selection checkpoints, block_q changes no
    result.

    A CUDA tensor launches the kernel and adds one to
    ``lamp_flash_attention.launches``; a CPU tensor runs the plain
    version."""
    _, bk = _check(q, k, v, block_q, block_k, k_subtile)
    check_mu(mu)
    if q.device.type == "cpu":
        return lamp_flash_attention_plain(
            q, k, v, mu=mu, tau=tau, causal=causal, block_q=block_q,
            block_k=block_k, k_subtile=k_subtile, reduce=reduce)
    if q.device.type != "cuda":
        raise ValueError(f"no lamp_flash_attention kernel for device {q.device}")
    launch, out, cnt = prepare_launch(q, k, v, mu=mu, tau=tau, causal=causal,
                                      block_k=bk, k_subtile=k_subtile)
    _wrapper.launches += launch()
    return out, (cnt.sum() if reduce else cnt).float()


lamp_flash_attention.launches = 0
_wrapper = lamp_flash_attention
