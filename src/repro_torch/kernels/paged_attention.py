"""Paged LAMP attention: the mixed-row kernel of the fused serving step and
the decode kernel of the split step and the speculative draft.

``paged_mixed_attention`` is the port of the TPU kernel
``repro/kernels/paged_attention.py::paged_prefill_attention`` (its alias
``paged_mixed_attention``, Pallas bodies ``_pre_stats_kernel`` and
``_pre_kernel``). Row b of q holds the window of queries at absolute
positions starts[b] .. starts[b] + qlens[b] - 1; each attends causally to
the positions 0 .. its own of row b's block table in the paged arena. A
decode row is a width-1 window, a chunked-prefill row a width-w window.

``paged_decode_attention`` is the port of the TPU kernel
``repro/kernels/paged_attention.py::paged_decode_attention`` (Pallas bodies
``_dec_stats_kernel`` and ``_dec_kernel``): one query per row at effective
length ``lengths[r]`` (valid keys [0, lengths[r])), relaxed_ln's row length
being lengths[r] itself.

On a CUDA tensor both wrappers launch one hand-written kernel design,
``csrc/paged_attention.cu`` (the decode entry is the mixed kernel at one
query a row at position lengths[r] - 1), or raise: there is no fallback.
Two launches for a rule that selects (the look-ahead statistics pass, then
the select / recompute / attend pass), one for rule "none" and LAMP off. On
a CPU tensor they run ``paged_mixed_attention_plain`` and
``paged_decode_attention_plain``, which gather ``arena[block_tables]`` and
call ``attention_lamp`` / ``decode_attention_lamp`` exactly as the JAX
gather branches do (``repro/models/transformer.py:538-555``,
``repro/models/layers.py:297-303``).

What bounds the kernel on the H100: not bytes (a few MB a call at the
engine's buckets) but the latency of the y_low chains at granularity 1 (hd
dependent multiply / add / round steps per query-key pair). The kernel
splits each row's keys over units of (row, head, query tile, split of keys;
``TILES``), gives each thread several independent
chains, keeps pass 1's y_low in a scratch for pass 2 (up to
``YLOW_KEEP_MAX_BYTES``), and merges the splits in split order, so calls
give the same bits. The merge uses arrival counters that the kernel leaves
at zero after every call; each (device, stream) has its own, allocated
once (``arrival_counters``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.attention import (attention_lamp, attention_reference,
                                       decode_attention_lamp)
from repro_torch.core.policy import LampSite

RULE_CODES = {"none": 0, "strict": 1, "relaxed": 2, "relaxed_ln": 3}

# csrc/paged_attention.cu's tiles by the bucket's window W (1; wider):
# (NT, TR, QPT, KPT), NT threads a unit in TR rows, each QPT queries x KPT
# keys, so a unit holds TQ = TR QPT queries and a split KS = (NT / TR) KPT
# keys
TILES = {"one": (128, 2, 1, 1), "wide": (128, 4, 2, 2)}
# Pass 1 keeps y_low for pass 2 up to this many bytes of scratch (B H W
# n_max bs float32 values); past it pass 2 stages K and recomputes y_low.
# Every bucket of the GPT-2 small engine keeps it (8 x 128 at 320 keys:
# 15.7 MB).
YLOW_KEEP_MAX_BYTES = 32 << 20


def tile_of(W: int) -> str:
    """The tile the kernel uses for a bucket of W queries a row."""
    return "one" if W == 1 else "wide"


def keeps_ylow(B: int, H: int, W: int, n_max: int, bs: int,
               site: LampSite) -> bool:
    """Whether pass 1 keeps y_low for pass 2 (a two-pass call whose scratch
    is at most YLOW_KEEP_MAX_BYTES); else pass 2 recomputes it."""
    return passes(site) == 2 and 4 * B * H * W * n_max * bs <= YLOW_KEEP_MAX_BYTES


def supports_site(site: LampSite) -> bool:
    """The kernel implements every materialized-softmax rule the serving
    path uses; the benchmark-only 'random' control arm is not served."""
    return (not site.enabled) or site.rule in RULE_CODES


def passes(site: LampSite) -> int:
    """Kernel launches per call: the statistics pass runs only for a rule
    that selects."""
    return 2 if site.enabled and site.rule != "none" else 1


def _repeat_kv(t: torch.Tensor, n_rep: int) -> torch.Tensor:
    return t if n_rep == 1 else torch.repeat_interleave(t, n_rep, dim=1)


def paged_mixed_attention_plain(q, arena_k, arena_v, block_tables, starts,
                                qlens, site: LampSite, *, tau=None,
                                window: Optional[int] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: gather each row's whole block-table span, then
    materialized LAMP attention at per-row offsets `starts`. Every query
    position is computed; positions past qlens[b] are padding. Returns
    (out (B, H, W, hd) float32, n_selected (B, W) summed over heads)."""
    del qlens   # padding queries are computed and discarded by the caller
    B, H, W, hd = q.shape
    _, bs, Hkv, _ = arena_k.shape
    n_max = block_tables.shape[1]
    bt = block_tables.long()
    ks = arena_k[bt].reshape(B, n_max * bs, Hkv, hd)
    vs = arena_v[bt].reshape(B, n_max * bs, Hkv, hd)
    kh = _repeat_kv(ks.permute(0, 2, 1, 3), H // Hkv)
    vh = _repeat_kv(vs.permute(0, 2, 1, 3), H // Hkv)
    if site.enabled:
        out, aux = attention_lamp(q, kh, vh, site, causal=True, window=window,
                                  offset=starts, reduce=False, tau=tau)
        return out, aux.n_selected
    out = attention_reference(q, kh, vh, causal=True, window=window,
                              offset=starts)
    return out, torch.zeros((B, W), dtype=torch.float32, device=q.device)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_arena(q, arena_k, arena_v, block_tables, site, window) -> int:
    """Checks shared by both kernels; returns the arena's Hkv."""
    dev = q.device
    _check("q", q, torch.float32, 4, dev)
    _check("arena_k", arena_k, torch.float32, 4, dev)
    _check("arena_v", arena_v, torch.float32, 4, dev)
    _check("block_tables", block_tables, torch.int32, 2, dev)
    B, H, _, hd = q.shape
    _, _, Hkv, hd_k = arena_k.shape
    if arena_v.shape != arena_k.shape or hd_k != hd:
        raise ValueError(f"arena shapes {tuple(arena_k.shape)} / "
                         f"{tuple(arena_v.shape)} do not fit q {tuple(q.shape)}")
    if hd > 128 or hd % 4 or H % Hkv:
        raise ValueError(f"kernel takes hd <= 128, hd % 4 == 0 and H % Hkv == "
                         f"0; got hd={hd}, H={H}, Hkv={Hkv}")
    if block_tables.shape[0] != B:
        raise ValueError("block_tables rows must match q's rows")
    if not supports_site(site):
        raise ValueError(f"paged kernel does not serve LAMP rule {site.rule!r}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    for name, t in (("arena_k", arena_k), ("arena_v", arena_v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return Hkv


def _tau_tensor(tau, site: LampSite, dev) -> torch.Tensor:
    if tau is None:
        tau = site.tau
    if not isinstance(tau, torch.Tensor):
        tau = torch.tensor([float(tau)], dtype=torch.float32, device=dev)
    if tau.numel() != 1 or tau.dtype != torch.float32 or tau.device != dev:
        raise ValueError("tau must be one float32 value on q's device")
    return tau


def _site_args(site: LampSite, window) -> tuple:
    return (site.mu, site.granularity, RULE_CODES.get(site.rule, 0),
            int(site.enabled), site.n_ref, -1 if window is None else int(window))


_arrivals = {}


def arrival_counters(dev: torch.device, n: int) -> torch.Tensor:
    """At least `n` int32 arrival counters for the kernel on `dev` and the
    current stream, zero between calls (the kernel resets each counter it
    uses). Allocated once per (device, stream) and grown as needed; a
    stream's counters are never shared with another stream, whose calls
    could overlap."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    buf = _arrivals.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _arrivals[key] = buf
    return buf


def _launcher(name: str, fn, args, n_pass: int, stream, keepalive):
    """`launch()` enqueues the call's passes (pass 1 only for a selecting
    rule) on `stream` and raises if one is refused; returns n_pass."""
    from repro_torch.kernels import build

    def launch() -> int:
        for p in range(3 - n_pass, 3):
            build.check_launch(fn(*args, p, stream), f"{name} pass {p}")
        return n_pass

    launch.keepalive = keepalive   # the bound pointers must stay valid
    return launch


def _workspace(lib, dev, B, H, W, hd, bs, n_max, keep):
    """The call's scratch and its arrival counters."""
    work = torch.empty(lib.lamp_paged_attention_workspace(B, H, W, hd, bs, n_max,
                                                          int(keep)),
                       dtype=torch.uint8, device=dev)
    arrive = arrival_counters(dev, lib.lamp_paged_attention_arrivals(B, H, W))
    return work, arrive


def prepare_launch(q, arena_k, arena_v, block_tables, starts, qlens, site,
                   tau=None, window=None, *, lib=None):
    """Check the inputs, allocate the outputs and bind the kernel's
    arguments. Returns (launch, out, cnt): each `launch()` enqueues the
    call's passes on the current stream (without counting them) and raises
    if one is refused. The wrapper uses it once per call; a timing loop may
    call `launch` many times. Pass 1 keeps y_low for pass 2 where
    ``keeps_ylow`` says so. `lib` is the loaded kernel library, the built
    ``csrc/paged_attention.cu`` unless a measurement passes a variant's
    (``launch.paged_attention_variants``)."""
    from repro_torch.kernels import build

    dev = q.device
    Hkv = _check_arena(q, arena_k, arena_v, block_tables, site, window)
    _check("starts", starts, torch.int32, 1, dev)
    _check("qlens", qlens, torch.int32, 1, dev)
    B, H, W, hd = q.shape
    if starts.shape != (B,) or qlens.shape != (B,):
        raise ValueError("starts / qlens rows must match q's B")
    bs, n_max = arena_k.shape[1], block_tables.shape[1]
    n_pass = passes(site)
    keep = keeps_ylow(B, H, W, n_max, bs, site)
    tau = _tau_tensor(tau, site, dev)
    out = torch.empty((B, H, W, hd), dtype=torch.float32, device=dev)
    cnt = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    lib = lib or build.load("paged_attention.cu")
    work, arrive = _workspace(lib, dev, B, H, W, hd, bs, n_max, keep)
    args = (q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr(),
            block_tables.data_ptr(), starts.data_ptr(), qlens.data_ptr(),
            tau.data_ptr(), work.data_ptr(), arrive.data_ptr(), out.data_ptr(),
            cnt.data_ptr(), B, H, Hkv, W, hd, bs, n_max,
            *_site_args(site, window), int(keep), hd ** -0.5)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = _launcher("paged_mixed_attention", lib.lamp_paged_mixed_attention,
                       args, n_pass, stream, (tau, work, arrive))
    return launch, out, cnt


def paged_mixed_attention(q, arena_k, arena_v, block_tables, starts, qlens,
                          site: LampSite, *, tau=None,
                          window: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixed-row LAMP attention straight off the paged arena.

    q: (B, H, W, hd) float32; arena_k / arena_v: (n_blocks, block_size, Hkv,
    hd) float32 (one layer); block_tables: (B, n_max) int32 (0 = the null
    block); starts, qlens: (B,) int32; tau: optional float32 value on q's
    device overriding ``site.tau`` (the engine passes ``taus[l]``). Returns
    (out (B, H, W, hd) float32, n_selected (B, W) float32 summed over
    heads). Positions past qlens[b] are padding: the kernel writes zeros
    there, the plain version computes them; callers discard them.

    A CUDA tensor launches the kernel and adds one to
    ``paged_mixed_attention.launches`` per pass launched; a CPU tensor runs
    the plain version."""
    if q.device.type == "cpu":
        return paged_mixed_attention_plain(q, arena_k, arena_v, block_tables,
                                           starts, qlens, site, tau=tau,
                                           window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention for device {q.device}")
    launch, out, cnt = prepare_launch(q, arena_k, arena_v, block_tables,
                                      starts, qlens, site, tau, window)
    _wrapper.launches += launch()
    return out, cnt.sum(dim=1)


paged_mixed_attention.launches = 0
# the counter's owner, kept apart from the module attribute so a caller that
# wraps or swaps the module attribute still counts on the real wrapper
_wrapper = paged_mixed_attention


def round_to_mantissa_device(x: torch.Tensor, mu: int) -> torch.Tensor:
    """The kernels' ``__device__`` round_to_mantissa applied elementwise to a
    CUDA float32 tensor (the exported test entry of the kernel library)."""
    from repro_torch.kernels import build

    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError("round_to_mantissa_device takes a CUDA float32 tensor")
    if not 1 <= mu <= 23:
        raise ValueError(f"mu must be in [1, 23], got {mu}")
    x = x.contiguous()
    y = torch.empty_like(x)
    err = build.load("paged_attention.cu").lamp_round_to_mantissa(
        x.data_ptr(), y.data_ptr(), x.numel(), mu,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"round_to_mantissa kernel failed: CUDA error {err}")
    return y


def paged_decode_attention_plain(q, arena_k, arena_v, block_tables, lengths,
                                 site: LampSite, *, tau=None,
                                 window: Optional[int] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: gather each row's whole block-table span,
    repeat the KV heads and call `decode_attention_lamp` at the effective
    `lengths`, as the JAX gather branch does. Returns (out (R, H, 1, hd)
    float32, n_selected (R,) summed over heads)."""
    R, H, _, hd = q.shape
    _, bs, Hkv, _ = arena_k.shape
    n_max = block_tables.shape[1]
    bt = block_tables.long()
    ks = arena_k[bt].reshape(R, n_max * bs, Hkv, hd)
    vs = arena_v[bt].reshape(R, n_max * bs, Hkv, hd)
    kh = _repeat_kv(ks.permute(0, 2, 1, 3), H // Hkv)
    vh = _repeat_kv(vs.permute(0, 2, 1, 3), H // Hkv)
    out, aux = decode_attention_lamp(q, kh, vh, lengths, site, window=window,
                                     reduce=False, tau=tau)
    return out, aux.n_selected


def prepare_decode_launch(q, arena_k, arena_v, block_tables, lengths, site,
                          tau=None, window=None, *, lib=None):
    """`prepare_launch` for the decode entry: check, allocate, bind.
    Returns (launch, out, cnt), cnt (R, H) per row and head."""
    from repro_torch.kernels import build

    dev = q.device
    Hkv = _check_arena(q, arena_k, arena_v, block_tables, site, window)
    _check("lengths", lengths, torch.int32, 1, dev)
    R, H, T, hd = q.shape
    if T != 1:
        raise ValueError(f"decode takes one query per row, got {T}")
    if lengths.shape != (R,):
        raise ValueError("lengths rows must match q's rows")
    bs, n_max = arena_k.shape[1], block_tables.shape[1]
    n_pass = passes(site)
    keep = keeps_ylow(R, H, 1, n_max, bs, site)
    tau = _tau_tensor(tau, site, dev)
    out = torch.empty((R, H, 1, hd), dtype=torch.float32, device=dev)
    cnt = torch.empty((R, H), dtype=torch.float32, device=dev)
    lib = lib or build.load("paged_attention.cu")
    work, arrive = _workspace(lib, dev, R, H, 1, hd, bs, n_max, keep)
    args = (q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), tau.data_ptr(),
            work.data_ptr(), arrive.data_ptr(), out.data_ptr(), cnt.data_ptr(),
            R, H, Hkv, hd, bs, n_max, *_site_args(site, window), int(keep),
            hd ** -0.5)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = _launcher("paged_decode_attention", lib.lamp_paged_decode_attention,
                       args, n_pass, stream, (tau, work, arrive))
    return launch, out, cnt


def paged_decode_attention(q, arena_k, arena_v, block_tables, lengths,
                           site: LampSite, *, tau=None,
                           window: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step straight off the paged arena.

    q: (R, H, 1, hd) float32; arena_k / arena_v: (n_blocks, block_size, Hkv,
    hd) float32 (one layer); block_tables: (R, n_max) int32; lengths: (R,)
    int32 *effective* lengths (the new token's K/V already written, so the
    valid keys are [0, lengths[r])); tau: optional float32 value on q's
    device overriding ``site.tau``. Returns (out (R, H, 1, hd) float32,
    n_selected (R,) float32 summed over heads), the contract of the JAX
    function.

    A CUDA tensor launches the kernel and adds one to
    ``paged_decode_attention.launches`` per pass launched; a CPU tensor runs
    the plain version."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, arena_k, arena_v, block_tables,
                                            lengths, site, tau=tau,
                                            window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no paged attention for device {q.device}")
    launch, out, cnt = prepare_decode_launch(q, arena_k, arena_v, block_tables,
                                             lengths, site, tau, window)
    _decode_wrapper.launches += launch()
    return out, cnt.sum(dim=1)


paged_decode_attention.launches = 0
_decode_wrapper = paged_decode_attention


def decode_kv_bytes(lengths, *, n_max: int, block_size: int,
                    bytes_per_token: int, window: Optional[int] = None,
                    lamp: bool = True) -> Tuple[int, int]:
    """(gather_bytes, fused_bytes) of KV traffic for one decode step of one
    layer (port of ``repro/kernels/paged_attention.py::decode_kv_bytes``):
    the gather path materializes every row's full block-table span (K and
    V); the kernel reads only live blocks, and a LAMP statistics pass
    re-reads K, so fused = live blocks x (2K + V) with LAMP on.
    ``bytes_per_token`` = Hkv * hd * itemsize."""
    L = np.maximum(np.asarray(lengths, np.int64), 1)
    gather = int(L.size) * n_max * block_size * bytes_per_token * 2
    lo = (np.maximum(L - window, 0) // block_size if window is not None
          else np.zeros_like(L))
    hi = (L - 1) // block_size
    live = int((hi - lo + 1).sum())
    fused = live * block_size * bytes_per_token * (3 if lamp else 2)
    return gather, fused
