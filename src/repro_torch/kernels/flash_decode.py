"""LAMP decode attention over a dense KV cache, the exact two-pass relaxed
rule: the port of the TPU kernel ``repro/kernels/flash_decode.py::
flash_decode`` (Pallas bodies ``_smax_kernel`` and ``_decode_kernel``).

One query per (batch, head) against a (B, H, S, D) cache whose valid keys
are [0, length[b]). y_low is q . k summed in chunks of ``k_subtile`` lanes,
each chunk lane by lane in k order, the running sum rounded to PS(mu) after
each chunk (unrounded at mu >= 23); pass 1 takes smax = max(y + log|y|)
over the valid keys, pass 2 selects y + log|y| > log(max(tau, 1e-30)) +
smax, recomputes those logits in FP32 and attends. A row of length 0
gives 0.

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/flash_decode.cu``) or raises; on a CPU tensor it runs
``flash_decode_plain``, which sums y_low in the kernel's order
(``core.mixed_matmul.slab_sums``), so the two select the same keys. The
kernel splits each row's keys over thread blocks of ``KEYS_PER_SPLIT``
keys, one key a thread; blocks past the row's length exit at once, and
keys past it are never read. Its first launch writes each valid key's
y_low to a scratch and each split's max of s; its second (launched to
start while the first runs, waiting only before it reads what the first
wrote) selects, reads a K row only for a selected key, attends and merges
the splits of a row in split order (so calls give the same bits). float32
and bfloat16 caches are read in their own dtype and widened in the kernel,
as the Pallas bodies widen them. What bounds the kernel on the H100:
bytes, the valid K and V rows read once.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.mixed_matmul import slab_sums
from repro_torch.core.numerics import check_mu

NEG = -1e30
KEYS_PER_SPLIT = 128      # csrc/flash_decode.cu's KS: keys a thread block
CACHE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    vectorized over batch and heads; y_low from ``slab_sums`` in chunks of
    `k_subtile` lanes (the kernel's order). Returns (out (B, H, 1, D)
    float32, n_selected: a float32 scalar, or (B, H) per row with
    reduce=False)."""
    S = _check(q, k_cache, v_cache, block_k, k_subtile)
    D = q.shape[-1]
    qf = q.float() * D ** -0.5
    kt = k_cache.float().transpose(-1, -2)
    y_low = slab_sums(qf, kt, mu, k_subtile)                   # (B, H, 1, S)
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
                   tau: float = 0.05, k_subtile: int = 32, lib=None):
    """Check, allocate and bind (the blocks already checked). Returns
    (launch, out, cnt): each `launch()` enqueues both passes on the current
    stream (without counting them), raises if one is refused and returns 2;
    cnt is (B, H) int32. The caches are read where they lie, in their own
    dtype: they must be 16-byte aligned (a contiguous view at an odd
    storage offset is refused). `lib` is the loaded kernel library, the
    built ``csrc/flash_decode.cu`` unless a measurement passes a variant's
    (``launch.flash_decode_variants``)."""
    from repro_torch.kernels import build

    dev = q.device
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("length", length)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype not in CACHE_DTYPES:
            raise TypeError(f"flash_decode takes float32 or bfloat16, got "
                            f"{name} {t.dtype}")
    B, H, _, D = q.shape
    S = k_cache.shape[2]
    if D > 128 or D % 4:
        raise ValueError(f"kernel takes D <= 128 and D % 4 == 0, got D={D}")
    if length.shape != (B,):
        raise ValueError(f"length must be ({B},), got {tuple(length.shape)}")
    q32 = q.to(torch.float32).contiguous()
    kc, vc = k_cache.contiguous(), v_cache.contiguous()
    for name, t in (("k_cache", kc), ("v_cache", vc)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    len32 = length.to(torch.int32).contiguous()
    out = torch.empty((B, H, 1, D), dtype=torch.float32, device=dev)
    cnt = torch.empty((B, H), dtype=torch.int32, device=dev)
    lib = lib or build.load("flash_decode.cu")
    work = torch.empty(lib.lamp_flash_decode_workspace(B * H, S, D),
                       dtype=torch.uint8, device=dev)
    args = (q32.data_ptr(), kc.data_ptr(), vc.data_ptr(), len32.data_ptr(),
            work.data_ptr(), out.data_ptr(), cnt.data_ptr(), B * H, H, S, D,
            mu, k_subtile, log_tau(tau), D ** -0.5)
    dtypes = (CACHE_DTYPES[kc.dtype], CACHE_DTYPES[vc.dtype])
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch() -> int:
        for p in (1, 2):
            build.check_launch(lib.lamp_flash_decode(*args, p, *dtypes, stream),
                               f"flash_decode pass {p}")
        return 2

    launch.keepalive = (q32, kc, vc, len32, work, out, cnt)
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
