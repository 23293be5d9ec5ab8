"""rmsnorm's kernel against variants of itself, on the card.

    PYTHONPATH=src python -m repro_torch.launch.rmsnorm_variants

Each variant is ``kernels/csrc/rmsnorm.cu`` with a few lines replaced
(``VARIANTS``), built by nvcc with the flags of ``kernels.build`` into
``kernels/build/variants/``, and timed (CUDA events, L2 flushed, as in
``kernels_micro``) at the micro-benchmark's two rmsnorm rows, with their
inputs, beside ``F.rms_norm`` and a copy of x (``x.clone()``: the same
bytes read and written, no arithmetic) in the same process. The variants run twice,
the second time in the reverse order, and ``F.rms_norm`` before and after.
Each is held to the plain version within ``kernels_micro.RMS_TOL``. One
JSON line per row, after one line with the card and the registers and
spills ptxas gave each variant. Needs a CUDA card and nvcc; the variants
are measurements only, nothing in the port loads them.
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
from repro_torch.kernels import rmsnorm as RN
from repro_torch.launch import kernel_variants as KV
from repro_torch.launch import kernels_micro as KM

SOURCE = "rmsnorm.cu"
_PERSISTENT = "const dim3 grid((unsigned)(need < fit ? need : fit));"

_W = "constexpr int ROW_WARPS = 2;"
_STREAM = "__stcs(orow + v, Vec<T>::pack(f));"

# name -> (what it changes, [(text of rmsnorm.cu, replacement)])
VARIANTS: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {
    "shipped": ("csrc/rmsnorm.cu as it stands", []),
    "warps1": ("one warp a row, the sum by shuffles alone (rows of at most "
               "16 vectors a lane)", [
        (_W, "constexpr int ROW_WARPS = 1;")]),
    "warps4": ("four warps a row", [(_W, "constexpr int ROW_WARPS = 4;")]),
    "warps8": ("eight warps a row", [(_W, "constexpr int ROW_WARPS = 8;")]),
    "unbounded_grid": ("a block for every RPB rows, no grid-stride walk", [
        (_PERSISTENT, "const dim3 grid((unsigned)need);")]),
    "warps4_unbounded": ("four warps a row, a block for every RPB rows", [
        (_W, "constexpr int ROW_WARPS = 4;"),
        (_PERSISTENT, "const dim3 grid((unsigned)need);")]),
    "stores": ("out stored with the default cache policy, not the streaming "
               "one", [(_STREAM, "orow[v] = Vec<T>::pack(f);")]),
    "general_only": ("every row on the general path (PR 14's design)", [
        ("  if (!vector_path(x, w, out, d, sizeof(T))) {",
         "  if (true) {")]),
}

# the micro-benchmark's rmsnorm rows: (rows, d, seed)
ROWS = [(4096, 3072, 7), (1024, 512, 3)]


def variant_source(name: str) -> str:
    """rmsnorm.cu with `name`'s replacements; each text must occur in it
    exactly once."""
    return KV.variant_source(SOURCE, name, VARIANTS[name][1])


def _build(name: str) -> Tuple[str, List[str]]:
    return KV.build_variant(SOURCE, name, variant_source(name))


def _lib(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in build.SIGNATURES[SOURCE].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


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
    for rows, d, seed in ROWS:
        rng = np.random.default_rng(seed)
        x = KM._t(KM._rand(rng, (rows, d)), dev).to(torch.bfloat16)
        w = KM._t(KM._rand(rng, (d,), 0.1), dev)
        ref = RN.rmsnorm_plain(x, w).float()
        w1 = (1.0 + w).to(x.dtype)
        norm = lambda: F.rms_norm(x, (d,), w1, 1e-6)
        row = {"shape": [rows, d], "dtype": "bfloat16", "rms_norm_ms": [timer.ms(norm)],
               "clone_ms": timer.ms(lambda: x.clone())}
        for name in list(libs) + list(libs)[::-1]:
            launch, out = RN.prepare_launch(x, w, lib=libs[name])
            launch()
            err = (out.float() - ref).abs()
            ok = bool((err <= KM.RMS_TOL["atol"] + KM.RMS_TOL["rtol"] * ref.abs()).all())
            r = row.setdefault(name, {"ms": [], "ok": ok, "max_err": err.max().item()})
            r["ms"].append(timer.ms(launch))
        row["rms_norm_ms"].append(timer.ms(norm))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
