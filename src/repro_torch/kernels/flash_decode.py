"""LAMP decode attention over a dense KV cache, the exact two-pass relaxed
rule: the port of the TPU kernel ``repro/kernels/flash_decode.py::
flash_decode`` (Pallas bodies ``_smax_kernel`` and ``_decode_kernel``).

One query per (batch, head) against a (B, H, S, D) cache whose valid keys
are [0, length[b]). y_low is q . k summed in chunks of ``k_subtile`` lanes,
the running sum rounded to PS(mu) after each chunk (unrounded at mu >= 23);
pass 1 takes smax = max(y + log|y|) over the valid keys, pass 2 selects
y + log|y| > log(max(tau, 1e-30)) + smax, recomputes those logits in FP32
and attends. A row of length 0 gives 0.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/flash_decode.cu``, two launches, one thread block per (b, h); keys
past length[b] are never read) or raises; on a CPU tensor it runs
``flash_decode_plain``. bfloat16 inputs are widened to float32 by the
wrapper before the launch (exact, one extra pass over the cache). What
bounds the kernel on the H100: bytes (the valid K rows twice, V once) and
the CUDA-core work of y_low.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.mixed_matmul import dot_ps
from repro_torch.core.numerics import check_mu

NEG = -1e30


def log_tau(tau: float) -> float:
    """log(max(tau, 1e-30)) in float32, as the JAX kernels compute it; the
    CUDA kernels receive this value, so they and the plain versions
    threshold on the same number."""
    return float(torch.log(torch.tensor(max(float(tau), 1e-30),
                                        dtype=torch.float32)))


def _check(q, k_cache, v_cache, block_k: int, k_subtile: int) -> int:
    """The JAX wrapper's checks; returns S."""
    if q.ndim != 4 or q.shape[2] != 1:
        raise ValueError(f"q must be (B, H, 1, D), got {tuple(q.shape)}")
    B, H, _, D = q.shape
    if k_cache.ndim != 4 or k_cache.shape[:2] != (B, H) or \
            k_cache.shape[3] != D or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not fit q {tuple(q.shape)}")
    S = k_cache.shape[2]
    bk = min(block_k, S)
    if bk < 1 or S % bk:
        raise ValueError(f"S={S} % block_k={bk}")
    if k_subtile < 1:
        raise ValueError(f"k_subtile must be >= 1, got {k_subtile}")
    return S


def flash_decode_plain(q, k_cache, v_cache, length, *, mu: int = 7,
                       tau: float = 0.05, block_k: int = 512,
                       k_subtile: int = 32, reduce: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (``kernels/ref.py::flash_decode_ref``),
    vectorized over batch and heads; y_low from ``dot_ps`` at granularity
    `k_subtile`. Returns (out (B, H, 1, D) float32, n_selected: a float32
    scalar, or (B, H) per row with reduce=False)."""
    S = _check(q, k_cache, v_cache, block_k, k_subtile)
    D = q.shape[-1]
    qf = q.float() * D ** -0.5
    kt = k_cache.float().transpose(-1, -2)
    y_low = dot_ps(qf, kt, mu, granularity=k_subtile)          # (B, H, 1, S)
    ok = (torch.arange(S, device=q.device)[None, :]
          < length.to(q.device).long()[:, None])[:, None, None, :]
    s = torch.where(ok, y_low + torch.log(y_low.abs()), NEG)
    smax = s.amax(-1, keepdim=True).clamp_min(NEG)
    sel = ok & (s > log_tau(tau) + smax)
    y = torch.where(sel, torch.matmul(qf, kt), y_low)
    y = torch.where(ok, y, NEG)
    p = torch.where(ok, torch.exp(y - y.amax(-1, keepdim=True)), 0.0)
    out = torch.matmul(p, v_cache.float()) / \
        p.sum(-1, keepdim=True).clamp_min(1e-30)
    counts = sel.sum(-1)[..., 0]
    return out, (counts.sum() if reduce else counts).float()


def prepare_launch(q, k_cache, v_cache, length, *, mu: int = 7,
                   tau: float = 0.05, k_subtile: int = 32):
    """Check, allocate and bind (the blocks already checked). Returns
    (launch, out, cnt): each `launch()` enqueues both passes on the current
    stream (without counting them), raises if one is refused and returns 2;
    cnt is (B, H) int32."""
    from repro_torch.kernels import build

    dev = q.device
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("length", length)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"flash_decode takes float32 or bfloat16, got "
                            f"{name} {t.dtype}")
    B, H, _, D = q.shape
    S = k_cache.shape[2]
    if D > 128 or D % 4:
        raise ValueError(f"kernel takes D <= 128 and D % 4 == 0, got D={D}")
    if length.shape != (B,):
        raise ValueError(f"length must be ({B},), got {tuple(length.shape)}")
    q32, k32, v32 = (t.to(torch.float32).contiguous()
                     for t in (q, k_cache, v_cache))
    len32 = length.to(torch.int32).contiguous()
    out = torch.empty((B, H, 1, D), dtype=torch.float32, device=dev)
    smax = torch.empty((B, H), dtype=torch.float32, device=dev)
    cnt = torch.empty((B, H), dtype=torch.int32, device=dev)
    fn = build.load("flash_decode.cu").lamp_flash_decode
    args = (q32.data_ptr(), k32.data_ptr(), v32.data_ptr(), len32.data_ptr(),
            smax.data_ptr(), out.data_ptr(), cnt.data_ptr(), B * H, H, S, D,
            mu, k_subtile, log_tau(tau), D ** -0.5)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch() -> int:
        for p in (1, 2):
            build.check_launch(fn(*args, p, stream), f"flash_decode pass {p}")
        return 2

    launch.keepalive = (q32, k32, v32, len32, smax, out, cnt)
    return launch, out, cnt


def flash_decode(q, k_cache, v_cache, length, *, mu: int = 7,
                 tau: float = 0.05, block_k: int = 512, k_subtile: int = 32,
                 reduce: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, H, 1, D) against caches (B, H, S, D) at valid lengths (B,) ->
    (out (B, H, 1, D) float32, n_selected float32 scalar; (B, H) per row
    with reduce=False). `block_k` must divide S (capped at S, as in JAX)
    and changes no result.

    A CUDA tensor launches the kernel and adds two to
    ``flash_decode.launches`` (its two passes); a CPU tensor runs the plain
    version."""
    _check(q, k_cache, v_cache, block_k, k_subtile)
    check_mu(mu)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, length, mu=mu, tau=tau,
                                  block_k=block_k, k_subtile=k_subtile,
                                  reduce=reduce)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_decode kernel for device {q.device}")
    launch, out, cnt = prepare_launch(q, k_cache, v_cache, length, mu=mu,
                                      tau=tau, k_subtile=k_subtile)
    _wrapper.launches += launch()
    return out, (cnt.sum() if reduce else cnt).float()


flash_decode.launches = 0
_wrapper = flash_decode
