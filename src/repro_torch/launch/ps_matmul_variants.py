"""ps_matmul's tensor-core kernel against variants of itself, on the card.

    PYTHONPATH=src python -m repro_torch.launch.ps_matmul_variants

Each variant is ``kernels/csrc/ps_matmul.cu`` (with ``tf32_mma.cuh``, its
tf32 split and MMA helpers, written in) with a few lines replaced
(``VARIANTS``), built by nvcc with the flags of ``kernels.build`` into
``kernels/build/variants/``, and timed (CUDA events, L2 flushed, as in
``kernels_micro``) at the micro-benchmark's two ps_matmul shapes, at mu 7
and mu 23, beside ``torch.matmul`` (TF32 off) in the same process. Each
variant is also held against ``slab_sums`` with ``kernels_micro``'s slack,
so the 1xTF32 control shows what a single TF32 pass would cost in
accuracy. One JSON line per shape, after one line with the card and the
registers and spills ptxas gave each variant. Needs a CUDA card and nvcc;
the variants are measurements only, nothing in the port loads them.
"""

from __future__ import annotations

import ctypes
import json
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.mixed_matmul import slab_sums
from repro_torch.kernels import build
from repro_torch.launch import kernel_variants as KV
from repro_torch.launch import kernels_micro as KM

# name -> (what it changes, [(text of ps_matmul.cu, replacement)])
VARIANTS: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {
    "shipped": ("csrc/ps_matmul.cu as it stands", []),
    "finite_only": (
        "no NaN/Inf handling: the split without its flag, no exact "
        "recompute", [
            ("  bad |= !(fabsf(d) <= FLT_MAX);\n", ""),
            ("if (__any_sync(FULL, bad)) ", "if (false) ")]),
    "cvt_split": (
        "tf32 rounding by cvt.rna.tf32.f32 instead of two integer "
        "operations", [
            ("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
             "  uint32_t r;\n"
             "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(x));\n"
             "  return r;")]),
    "general_walk": (
        "every shape on the general walk: 4-byte copies mapped lane by "
        "lane, the slab edge checked every k-step", [
            ("const bool tiled = ", "const bool tiled = false && ")]),
    "one_tf32": (
        "accuracy control, 1xTF32: the hi.hi product alone", [
            ("mma_tf32(part[i][j], alo[i], bhi[j]);", "{}"),
            ("mma_tf32(part[i][j], ahi[i], blo[j]);", "{}")]),
}

# the micro-benchmark's ps_matmul rows: (M, K, N, block_k, seed)
SHAPES = [(1024, 768, 3072, 128, 6), (256, 256, 256, 128, 2)]


def variant_source(name: str) -> str:
    """ps_matmul.cu, with the tensor-core helpers of ``tf32_mma.cuh``
    written in where it includes them, and `name`'s replacements; each text
    must occur in it exactly once."""
    return KV.variant_source("ps_matmul.cu", name, VARIANTS[name][1])


def _build(name: str) -> Tuple[str, List[str]]:
    return KV.build_variant("ps_matmul.cu", name, variant_source(name))


def _launcher(fn, a, b, mu: int, block_k: int):
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, mu, block_k,
            torch.cuda.current_stream(a.device).cuda_stream)

    def launch():
        build.check_launch(fn(*args), "ps_matmul variant")
    return launch, out


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the variants run only on a card")
    dev = torch.device("cuda")
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as ex:
        built = dict(zip(VARIANTS, ex.map(_build, VARIANTS)))
    fns = {}
    for name, (lib, _) in built.items():
        fn = ctypes.CDLL(lib).lamp_ps_matmul
        fn.argtypes, fn.restype = build.SIGNATURES["ps_matmul.cu"]["lamp_ps_matmul"]
        fns[name] = fn
    print(json.dumps({"card": KV.card(),
                      "variants": {n: VARIANTS[n][0] for n in VARIANTS},
                      "ptxas": {n: p for n, (_, p) in built.items()}}), flush=True)
    timer = KM.Timer(dev)
    for M, K, N, bk, seed in SHAPES:
        rng = np.random.default_rng(seed)
        a, b = KM._t(KM._rand(rng, (M, K)), dev), KM._t(KM._rand(rng, (K, N)), dev)
        row = {"shape": [M, K, N], "block_k": bk,
               "matmul_ms": timer.ms(lambda: torch.matmul(a, b))}
        for mu in (7, 23):
            ref = slab_sums(a, b, mu, bk)
            for name, fn in fns.items():
                launch, out = _launcher(fn, a, b, mu, bk)
                launch()
                res = KM.ps_matmul_slack(out, ref, a, b, mu)
                row.setdefault(name, {}).update({
                    f"ms_mu{mu}": timer.ms(launch), f"ok_mu{mu}": res["ok"],
                    f"apart_mu{mu}": res["apart"],
                    f"max_err_over_mag_mu{mu}": res["max_err_over_mag"]})
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
