"""flash_decode's kernel against variants of itself, on the card.

    PYTHONPATH=src python -m repro_torch.launch.flash_decode_variants

Each variant is ``kernels/csrc/flash_decode.cu`` (with ``tf32_mma.cuh``,
its cp.async helpers, written in) with a few lines replaced
(``VARIANTS``), built by nvcc with the flags of ``kernels.build`` into
``kernels/build/variants/``, and timed (CUDA events, L2 flushed, as in
``kernels_micro``) at the micro-benchmark's two flash_decode rows, with
their inputs, beside SDPA with a length mask in the same process. The
variants run twice, the second time in the reverse order. Each is held
against the plain version (``kernels_micro.compare_rows``), and the
shipped kernel's two launches are timed apart by torch.profiler
(``device_us``: device time only, no gap between launches). One JSON line
per row, after one line with the card and the registers and spills ptxas
gave each variant. Needs a CUDA card and nvcc; the variants are
measurements only, nothing in the port loads them.
"""

from __future__ import annotations

import ctypes
import json
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels import flash_decode as FD
from repro_torch.launch import kernel_variants as KV
from repro_torch.launch import kernels_micro as KM

SOURCE = "flash_decode.cu"

# name -> (what it changes, [(text of flash_decode.cu, replacement)])
VARIANTS: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {
    "shipped": ("csrc/flash_decode.cu as it stands: 128 keys a split", []),
    "ks64": ("64 keys a split (2 warps a block)", [
        ("constexpr int NW = 4;", "constexpr int NW = 2;")]),
    "ks256": ("256 keys a split (8 warps a block)", [
        ("constexpr int NW = 4;", "constexpr int NW = 8;")]),
    "no_pdl": ("pass 2 launched plainly: none of its blocks starts before "
               "pass 1 has ended", [
                   ("cfg.numAttrs = early ? 1 : 0;", "cfg.numAttrs = 0;")]),
}

# the micro-benchmark's flash_decode rows: (B, H, S, D, lengths, seed)
ROWS = [(8, 12, 1024, 64, np.linspace(1, 1024, 8).round().astype(int).tolist(), 5),
        (2, 4, 2048, 64, [2048, 1948], 1)]
ARGS = dict(mu=7, tau=0.05, k_subtile=32)


def variant_source(name: str) -> str:
    """flash_decode.cu with the helpers of ``tf32_mma.cuh`` written in and
    `name`'s replacements; each text must occur in it exactly once."""
    return KV.variant_source(SOURCE, name, VARIANTS[name][1])


def _build(name: str) -> Tuple[str, List[str]]:
    return KV.build_variant(SOURCE, name, variant_source(name))


def _lib(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in build.SIGNATURES[SOURCE].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def row_inputs(B, H, S, D, lengths, seed, dev):
    """The micro row's inputs (``kernels_micro.flash_decode_row``): clean
    caches for the plain version, NaN past each length for the kernels."""
    rng = np.random.default_rng(seed)
    q = KM._t(KM._rand(rng, (B, H, 1, D), 1.5), dev)
    k = KM._t(KM._rand(rng, (B, H, S, D), 1.5), dev)
    v = KM._t(KM._rand(rng, (B, H, S, D)), dev)
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    ok = torch.arange(S, device=dev)[None, :] < length.long()[:, None]
    dead = ~ok[:, None, :, None]
    return (q, k, v, length, ok, k.masked_fill(dead, float("nan")),
            v.masked_fill(dead, float("nan")))


def device_us(fn, flush: torch.Tensor, reps: int = 5) -> Dict[str, float]:
    """Mean device time of each CUDA kernel one call of `fn` runs, in us,
    from torch.profiler, with the L2 flushed before each call (the flush's
    own kernel left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    flush.zero_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    times: Dict[str, List[float]] = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            times.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return {n: sum(t) / len(t) for n, t in times.items() if len(t) == reps
            and "fill" not in n.lower() and "zero" not in n.lower()}


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the variants run only on a card")
    dev = torch.device("cuda")
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as ex:
        built = dict(zip(VARIANTS, ex.map(_build, VARIANTS)))
    libs = {name: _lib(path) for name, (path, _) in built.items()}
    print(json.dumps({"card": KV.card(),
                      "variants": {n: VARIANTS[n][0] for n in VARIANTS},
                      "ptxas": {n: p for n, (_, p) in built.items()}}), flush=True)
    timer = KM.Timer(dev)
    for B, H, S, D, lengths, seed in ROWS:
        q, k, v, length, ok, k_in, v_in = row_inputs(B, H, S, D, lengths, seed, dev)
        ref, cref = FD.flash_decode_plain(q, k, v, length, reduce=False, **ARGS)
        mask = ok[:, None, None, :]
        row = {"shape": [B, H, S, D], "lengths": lengths,
               "sdpa_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask))}
        order = list(libs) + list(libs)[::-1]
        for name in order:
            launch, out, cnt = FD.prepare_launch(q, k_in, v_in, length,
                                                 lib=libs[name], **ARGS)
            launch()
            res = KM.compare_rows(out, cnt, ref, cref)
            r = row.setdefault(name, {"ms": [], "ok": res["ok"],
                                      "apart_rows": res["apart_rows"],
                                      "count_diff": res["count_diff"]})
            r["ms"].append(timer.ms(launch))
            if name == "shipped" and "device_us" not in r:
                r["device_us"] = device_us(launch, timer.flush)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
