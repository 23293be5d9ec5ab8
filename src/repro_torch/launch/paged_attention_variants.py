"""The paged LAMP attention kernel against variants of itself, on the card.

    PYTHONPATH=src python -m repro_torch.launch.paged_attention_variants

Each variant is ``kernels/csrc/paged_attention.cu`` (with ``tf32_mma.cuh``
written in) with a few lines replaced (``VARIANTS``: the keys a split, the
queries a tile, no programmatic dependent launch, y_low recomputed in pass
2 instead of kept, the FP32 arm by fmaf chains as before the kernel took
the plain version's summation order), built by nvcc with the flags of ``kernels.build`` into
``kernels/build/variants/`` (``launch.kernel_variants``) and launched
through the port's own ``prepare_launch`` / ``prepare_decode_launch`` with
the variant's library. Five synthetic buckets mirror the GPT-2 small
engine's (``BUCKETS``: 12 heads, hd 64, block 16, 20 blocks a row, the
engine's site): 8 decode rows in a width-1 bucket, 8 verify rows of width 5
in a width-8 bucket and the 2-row width-8 bucket at the lengths of its log,
the 8 x 128 bucket's prefill windows, and the draft's 8-row decode bucket
(rule none); then the 8 x 1 and 8 x 8 buckets again at the `dense`
family's deployment site (relaxed rule, granularity 0: ``SITE_BUCKETS``),
where every logit comes from the FP32 arm. Each
variant is held against the plain version (rtol 2e-5 / atol 2e-6 a query,
counts within ``COUNT_SLACK``) and timed twice, the second time in the
reverse order (``kernel_variants.back_to_back_ms``: warm L2, host work out
of the timing); the shipped kernel's passes are also timed apart by
torch.profiler (``pass_us``). One JSON line per bucket, after one line with
the card and the registers and spills ptxas gave each variant. Needs a
CUDA card and nvcc; the variants are measurements only, nothing in the
port loads them. ``--variants shipped,fmaf_exact`` builds and times only
those.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.policy import LampPolicy
from repro_torch.kernels import build
from repro_torch.kernels import paged_attention as PA
from repro_torch.launch import kernel_variants as KV
from repro_torch.models import transformer as TT
from repro_torch.serving.speculative import draft_model_config

SOURCE = "paged_attention.cu"

# name -> (what it changes, [(text of paged_attention.cu, replacement)])
VARIANTS: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {
    "shipped": ("csrc/paged_attention.cu as it stands", []),
    "one_64": ("width 1: 64 keys a split on 64 threads (no empty row)", [
        ("using TileOne = Tile<128, 2, 1, 1>;", "using TileOne = Tile<64, 1, 1, 1>;")]),
    "one_128": ("width 1: 128 keys a split on 128 threads", [
        ("using TileOne = Tile<128, 2, 1, 1>;", "using TileOne = Tile<128, 1, 1, 1>;")]),
    "wide_ks32": ("width 2 and up: 32 keys a split (1 a thread)", [
        ("using TileWide = Tile<128, 4, 2, 2>;", "using TileWide = Tile<128, 4, 2, 1>;")]),
    "wide_tq16": ("width 2 and up: 16 queries a tile (4 pairs a thread)", [
        ("using TileWide = Tile<128, 4, 2, 2>;", "using TileWide = Tile<128, 4, 4, 2>;")]),
    "no_pdl": ("pass 2 launched plainly: none of its units starts before "
               "pass 1 has ended", [
                   ("cfg.numAttrs = early ? 1 : 0;", "cfg.numAttrs = 0;")]),
    "recompute": ("pass 1 keeps no y_low: pass 2 stages K and computes it "
                  "again", [
                      ("p.keep = p.keep && p.lamp && p.rule != RULE_NONE;",
                       "p.keep = false;")]),
    "fmaf_exact": ("the FP32 arm (tile_logits' exact branch, dot_exact_row) "
                   "by fmaf chains: the order before the plain versions "
                   "took the kernel's", [
                       ("""          x = __fadd_rn(x, __fmul_rn(a[i].x, b[j].x));
          x = __fadd_rn(x, __fmul_rn(a[i].y, b[j].y));
          x = __fadd_rn(x, __fmul_rn(a[i].z, b[j].z));
          ye[i][j] = __fadd_rn(x, __fmul_rn(a[i].w, b[j].w));""",
                        """          x = fmaf(a[i].x, b[j].x, x);
          x = fmaf(a[i].y, b[j].y, x);
          x = fmaf(a[i].z, b[j].z, x);
          ye[i][j] = fmaf(a[i].w, b[j].w, x);"""),
                       ("""    acc = __fadd_rn(acc, __fmul_rn(q[d], k4.x));
    acc = __fadd_rn(acc, __fmul_rn(q[d + 1], k4.y));
    acc = __fadd_rn(acc, __fmul_rn(q[d + 2], k4.z));
    acc = __fadd_rn(acc, __fmul_rn(q[d + 3], k4.w));""",
                        """    acc = fmaf(q[d], k4.x, acc);
    acc = fmaf(q[d + 1], k4.y, acc);
    acc = fmaf(q[d + 2], k4.z, acc);
    acc = fmaf(q[d + 3], k4.w, acc);""")]),
}

H, HD, BS, N_MAX = 12, 64, 16, 20
# name -> (kind, starts or lengths, qlens, window W): the engine's buckets
# at the lengths of its log (chip_smoke.py phase kernels)
BUCKETS = {
    "mixed_8x1": ("mixed", [261, 44, 183, 99, 34, 221, 128, 60], [1] * 8, 1),
    "mixed_8x8": ("mixed", [265, 46, 183, 99, 34, 221, 128, 60], [5] * 8, 8),
    "mixed_2x8": ("mixed", [155, 90], [4, 1], 8),
    "mixed_8x128": ("mixed", [88, 64, 0, 257, 40, 0, 0, 0],
                    [92, 32, 4, 1, 1, 1, 1, 1], 128),
    "draft_8": ("decode", [261, 44, 183, 99, 34, 221, 1, 1], None, 1),
}
# buckets timed again at the dense family's deployment site (relaxed, g 0)
SITE_BUCKETS = ("mixed_8x1", "mixed_8x8")
TOL = dict(rtol=2e-5, atol=2e-6)
# the strict rule thresholds on a normalizer summed in another order by the
# kernel than by the plain version: one selection a query may differ
COUNT_SLACK = {"strict": 1}


def variant_source(name: str) -> str:
    """paged_attention.cu with the helpers of ``tf32_mma.cuh`` written in
    and `name`'s replacements; each text must occur in it exactly once."""
    return KV.variant_source(SOURCE, name, VARIANTS[name][1])


def _build(name: str) -> Tuple[str, List[str]]:
    return KV.build_variant(SOURCE, name, variant_source(name))


def _lib(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in build.SIGNATURES[SOURCE].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def bucket_inputs(kind, starts, qlens, W, seed, dev):
    """A random arena (one block table row per request, shuffled blocks),
    queries, and the bucket's row vectors, on `dev`."""
    rng = np.random.default_rng(seed)
    B = len(starts)
    n_blocks = 1 + B * N_MAX
    k = (rng.standard_normal((n_blocks, BS, H, HD)) * 1.5).astype(np.float32)
    v = rng.standard_normal((n_blocks, BS, H, HD)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_blocks))
    bt = np.zeros((B, N_MAX), np.int32)
    for r in range(B):
        end = starts[r] + (qlens[r] if kind == "mixed" else 0)
        nb = -(-end // BS)
        bt[r, :nb] = perm[r * N_MAX:r * N_MAX + nb]
    q = (rng.standard_normal((B, H, W, HD)) * 1.5).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)
    rows = [t(np.asarray(starts, np.int32))]
    if kind == "mixed":
        rows.append(t(np.asarray(qlens, np.int32)))
    return [t(q), t(k), t(v), t(bt)] + rows


def held(kind, out, nsel, ref, nref, qlens, slack) -> Dict:
    """Largest error and count difference (summed over heads) over live
    queries, and whether both are within TOL and the slack."""
    if kind == "mixed":
        live = torch.arange(out.shape[2], device=out.device)[None, :] < \
            qlens[:, None].long()
        lo = live[:, None, :].expand(-1, out.shape[1], -1)
        o, r = out[lo], ref[lo]
        dc = (nsel[live] - nref[live]).abs().max().item()
    else:
        o, r = out, ref
        dc = (nsel - nref).abs().max().item()
    err = (o - r).abs()
    ok = bool((err <= TOL["atol"] + TOL["rtol"] * r.abs()).all()) and \
        bool(torch.isfinite(o).all()) and dc <= slack
    return {"max_err": err.max().item(), "count_diff": dc, "ok": ok}


def pass_us(launch, reps: int = 20) -> Dict[str, float]:
    """Mean device time of each kernel one `launch()` runs, in us, from
    torch.profiler (device time only; with a dependent launch, pass 2's
    time counts from its early start)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
    times: Dict[str, List[float]] = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            m = re.search(r"(\w+_kernel)<.*?Tile<([\d, ]+)>(?: ?, ?(true|false))?",
                          e.name)
            name = " ".join(x for x in m.groups() if x) if m else e.name[:60]
            times.setdefault(name, []).append(e.time_range.elapsed_us())
    return {n: sum(t) / len(t) for n, t in times.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants to build and time")
    names = ap.parse_args(argv).variants.split(",")
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        ap.error(f"unknown variants {unknown}; have {sorted(VARIANTS)}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the variants run only on a card")
    dev = torch.device("cuda")
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        built = dict(zip(names, ex.map(_build, names)))
    libs = {name: _lib(path) for name, (path, _) in built.items()}
    print(json.dumps({"card": KV.card(),
                      "variants": {n: VARIANTS[n][0] for n in names},
                      "ptxas": {n: p for n, (_, p) in built.items()}}), flush=True)
    cfg = get_config("gpt2-small")
    sites = {"mixed": TT._kq_site(cfg, True),
             "decode": TT._kq_site(draft_model_config(cfg), True)}
    runs = [(bucket, spec, sites[spec[0]]) for bucket, spec in BUCKETS.items()]
    runs += [(f"{bucket}@relaxed-g0", BUCKETS[bucket],
              LampPolicy.deployment().kq) for bucket in SITE_BUCKETS]
    for seed, (bucket, (kind, starts, qlens, W), site) in enumerate(runs):
        args = bucket_inputs(kind, starts, qlens, W, seed, dev)
        plain = (PA.paged_mixed_attention_plain if kind == "mixed"
                 else PA.paged_decode_attention_plain)
        prepare = PA.prepare_launch if kind == "mixed" else PA.prepare_decode_launch
        ref, cref = plain(*args, site)
        slack = COUNT_SLACK.get(site.rule, 0) if site.enabled else 0
        row = {"bucket": bucket, "rows": len(starts), "window": W,
               "starts_or_lengths": starts, "qlens": qlens,
               "rule": site.rule if site.enabled else "off",
               "passes": PA.passes(site)}
        for name in list(libs) + list(libs)[::-1]:
            launch, out, cnt = prepare(*args, site, lib=libs[name])
            launch()
            torch.cuda.synchronize()
            res = held(kind, out, cnt.sum(1), ref, cref,
                       args[5] if kind == "mixed" else None, slack)
            r = row.setdefault(name, {"ms": [], **res})
            r["ms"].append(KV.back_to_back_ms(launch))
            if name == "shipped" and "pass_us" not in r:
                r["pass_us"] = pass_us(launch)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
