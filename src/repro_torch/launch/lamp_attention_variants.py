"""lamp_flash_attention's Hopper kernel against variants of itself, and
against three references, on the card.

    PYTHONPATH=src python -m repro_torch.launch.lamp_attention_variants

Each variant is ``kernels/csrc/lamp_attention.cu`` with a few lines
replaced (``VARIANTS``; ``launch.kernel_variants`` builds it into a library
of its own, launched here through its C entry), timed (CUDA events, L2
flushed, as in ``kernels_micro``) at the micro-benchmark's two lamp rows,
at mu 7 and mu 23, beside ``F.scaled_dot_product_attention`` in the same
process. Each is held with ``kernels_micro.compare_rows`` (rtol 2e-5 / atol
2e-6 a row, counts exact) against the plain version, and against the plain
version with its FP32 arm taken by ``torch.matmul`` (cuBLAS's order, not
the kernel's chunk sums); its largest error is also given against a
float64 reference (the same selection, y_exact, the softmax and P.V in
float64), beside both plain versions' own. The variants that drop work
(y_low, P.V, the accurate logf and expf) measure what that work costs;
they are not meant to pass. One JSON line per row and mu, after one line
with the card and the registers and spills ptxas gave each variant. Needs
a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.mixed_matmul import slab_sums
from repro_torch.kernels import build
from repro_torch.kernels import lamp_attention as LA
from repro_torch.kernels.flash_decode import NEG, log_tau
from repro_torch.launch import kernel_variants as KV
from repro_torch.launch import kernels_micro as KM

SOURCE = "lamp_attention.cu"

# name -> (what it changes, [(text of lamp_attention.cu, replacement)])
VARIANTS: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {
    "shipped": ("csrc/lamp_attention.cu as it stands", []),
    "one_block_an_sm": (
        "launch bounds for one 256-thread block an SM: up to 255 registers, "
        "no spills, 8 warps an SM", [
            ("__launch_bounds__(NTH, 2)", "__launch_bounds__(NTH, 1)")]),
    "unroll_2": (
        "the y_low loop over D unrolled twice (more loads in flight, more "
        "registers)", [
            ("#pragma unroll 1\n      for (int d = s; d < e; d += 4)",
             "#pragma unroll 2\n      for (int d = s; d < e; d += 4)")]),
    "one_stage": (
        "one K stage: each tile's K loads after the last tile's P.V, no "
        "overlap with y_low", [
            ("stages = mode != MULTI && ", "stages = false && ")]),
    "pv_4warps": (
        "P.V at D 64 by 4 warps of two n-tiles (the other 4 idle), not 8 "
        "warps of one", [
            ("return p.Dp > 64 ? launch<V4, MODE, 2>", "return p.Dp > 32 ? launch<V4, MODE, 2>")]),
    "no_ylow": (
        "cost of y_low: no dot products (outputs wrong; not a candidate)", [
            ("for (int s = 0; s < D; s += p.sub) {", "for (int s = 0; s < 0; s += p.sub) {")]),
    "fast_math": (
        "cost of the accurate logf and expf: __logf and __expf instead "
        "(counts may move; not a candidate)", [
            ("__fadd_rn(yl[i][j], logf(fabsf(yl[i][j])))",
             "__fadd_rn(yl[i][j], __logf(fabsf(yl[i][j])))"),
            ("const float pv = ok ? expf(", "const float pv = ok ? __expf(")]),
    "no_pv": (
        "cost of P.V: no MMA (outputs wrong; not a candidate)", [
            ("mma_tf32(fine[mt][u], alo[mt], bhx);", "{}"),
            ("mma_tf32(fine[mt][u], ahi[mt], blo);", "{}"),
            ("mma_tf32(part[mt][u], ahi[mt], bhi);", "{}")]),
    "one_tf32": (
        "accuracy control, 1xTF32 P.V: the hi.hi product alone", [
            ("mma_tf32(fine[mt][u], alo[mt], bhx);", "{}"),
            ("mma_tf32(fine[mt][u], ahi[mt], blo);", "{}")]),
    "pv_one_chain": (
        "the three products of a k-step into one accumulator (one chain of "
        "dependent MMAs)", [
            ("mma_tf32(fine[mt][u], alo[mt], bhx);", "mma_tf32(part[mt][u], alo[mt], bhx);"),
            ("mma_tf32(fine[mt][u], ahi[mt], blo);", "mma_tf32(part[mt][u], ahi[mt], blo);")]),
    "pv_fold_tile": (
        "hi.hi summed over a whole tile's 16 k-steps before it is added into "
        "out (the design before folds per k-step)", [
            ("constexpr int PV_FOLD = 1;", "constexpr int PV_FOLD = 64;")]),
    "pv_fold_4": (
        "hi.hi added into out every 4 k-steps (32 keys)", [
            ("constexpr int PV_FOLD = 1;", "constexpr int PV_FOLD = 4;")]),
}

# the micro-benchmark's lamp rows: (shape, block_k, seed)
ROWS = [((1, 12, 1024, 64), 128, 4), ((1, 4, 256, 64), 64, 0)]


def row_inputs(shape, seed: int, dev):
    """q, k, v of the micro-benchmark's lamp row of `shape` and `seed`
    (``kernels_micro.lamp_attention_row``)."""
    rng = np.random.default_rng(seed)
    q, k = (KM._t(KM._rand(rng, shape, 1.5), dev) for _ in range(2))
    return q, k, KM._t(KM._rand(rng, shape), dev)


def variant_source(name: str) -> str:
    """lamp_attention.cu with `name`'s replacements (each text exactly
    once)."""
    return KV.variant_source(SOURCE, name, VARIANTS[name][1])


def _build(name: str) -> Tuple[str, List[str]]:
    return KV.build_variant(SOURCE, name, variant_source(name))


def _launcher(fn, q, k, v, *, mu: int, tau: float, causal: bool, block_k: int,
              k_subtile: int):
    """A launch of the C entry `fn` (a variant's ``lamp_flash_attention``)
    on float32, contiguous, 16-byte aligned q, k, v; returns (launch, out,
    cnt), as ``lamp_attention.prepare_launch`` does for the port's own
    build."""
    B, H, T, D = q.shape
    out = torch.empty_like(q)
    cnt = torch.empty((B, H, T), dtype=torch.int32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            cnt.data_ptr(), B * H, T, k.shape[2], D, mu, k_subtile, int(causal),
            block_k, log_tau(tau), D ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)

    def launch() -> int:
        build.check_launch(fn(*args), "lamp_flash_attention variant")
        return 1

    return launch, out, cnt


def other_plain(q, k, v, *, arm: str, mu: int, tau: float, causal: bool,
                block_k: int, k_subtile: int):
    """``lamp_flash_attention_plain`` with the FP32 arm taken otherwise:
    arm "matmul" takes y_exact from ``torch.matmul`` in float32; arm
    "float64" takes y_exact, the softmax and P.V in float64. y_low and the
    selection are the plain version's. Returns (out, per-row counts)."""
    B, H, T, D = q.shape
    S = k.shape[2]
    bk = min(block_k, S)
    qf = q.float() * D ** -0.5
    kt = k.float().transpose(-1, -2)
    y_low = slab_sums(qf, kt, mu, k_subtile)
    ok = torch.arange(S, device=q.device)[None, :] <= \
        torch.arange(T, device=q.device)[:, None] if causal else \
        torch.ones((T, S), dtype=torch.bool, device=q.device)
    s = torch.where(ok, y_low + torch.log(y_low.abs()), NEG)
    run = s.view(B, H, T, S // bk, bk).amax(-1).cummax(-1).values.clamp_min(NEG)
    sel = ok & (s > (log_tau(tau) + run).repeat_interleave(bk, dim=-1))
    wide = torch.float64 if arm == "float64" else torch.float32
    y = torch.where(sel, torch.matmul(qf.to(wide), kt.to(wide)), y_low.to(wide))
    y = torch.where(ok, y, NEG)
    p = torch.where(ok, torch.exp(y - y.amax(-1, keepdim=True)), 0.0)
    out = torch.matmul(p, v.to(wide)) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out, sel.sum(-1)


def worst(out, ref_mm, ref, ref64) -> Dict:
    """Where `out` lies farthest outside (or nearest) its allowance against
    `ref_mm`: the element, the four values there, and each one's share of
    the allowance against float64."""
    err = (out.double() - ref_mm.double()).abs()
    i = int((err / (KM.TOL["atol"] + KM.TOL["rtol"] * ref_mm.double().abs())).argmax())
    at = {n: t.reshape(-1)[i].item()
          for n, t in (("kernel", out), ("plain_matmul_arm", ref_mm), ("plain", ref),
                       ("float64", ref64))}
    tol = KM.TOL["atol"] + KM.TOL["rtol"] * abs(at["float64"])
    return {"index": [int(x) for x in np.unravel_index(i, out.shape)], "values": at,
            "share_f64": {n: abs(x - at["float64"]) / tol for n, x in at.items()
                          if n != "float64"}}


def share(out, ref) -> float:
    """The largest error of `out` over its allowance, atol + rtol |ref|."""
    err = (out.double() - ref.double()).abs()
    return (err / (KM.TOL["atol"] + KM.TOL["rtol"] * ref.double().abs())).max().item()


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the variants run only on a card")
    dev = torch.device("cuda")
    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as ex:
        built = dict(zip(VARIANTS, ex.map(_build, VARIANTS)))
    fns = {}
    for name, (path, _) in built.items():
        fn = ctypes.CDLL(path).lamp_flash_attention
        fn.argtypes, fn.restype = build.SIGNATURES[SOURCE]["lamp_flash_attention"]
        fns[name] = fn
    print(json.dumps({"card": KV.card(),
                      "variants": {n: VARIANTS[n][0] for n in VARIANTS},
                      "ptxas": {n: p for n, (_, p) in built.items()}}), flush=True)
    timer = KM.Timer(dev)
    for shape, bk, seed in ROWS:
        q, k, v = row_inputs(shape, seed, dev)
        sdpa_ms = timer.ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        for mu in (7, 23):
            kw = dict(mu=mu, tau=0.05, causal=True, block_k=bk, k_subtile=32)
            ref, cref = LA.lamp_flash_attention_plain(q, k, v, reduce=False,
                                                      block_q=shape[2], **kw)
            ref_mm, cref_mm = other_plain(q, k, v, arm="matmul", **kw)
            ref64, _ = other_plain(q, k, v, arm="float64", **kw)
            row = {"shape": list(shape), "block_k": bk, "mu": mu, "sdpa_ms": sdpa_ms,
                   "plain_f64": {"max_err": (ref.double() - ref64).abs().max().item(),
                                 "share": share(ref, ref64)},
                   "plain_matmul_arm_f64": {
                       "max_err": (ref_mm.double() - ref64).abs().max().item(),
                       "share": share(ref_mm, ref64)}}
            for name, fn in fns.items():
                launch, out, cnt = _launcher(fn, q, k, v, **kw)
                launch()
                res = KM.compare_rows(out, cnt, ref, cref)
                res_mm = KM.compare_rows(out, cnt, ref_mm, cref_mm)
                row[name] = {"ms": timer.ms(launch), "ok": res["ok"],
                             "apart_rows": res["apart_rows"],
                             "count_diff": res["count_diff"], "max_err": res["max_err"],
                             "share": share(out, ref),
                             "matmul_arm": {"ok": res_mm["ok"],
                                            "apart_rows": res_mm["apart_rows"],
                                            "count_diff": res_mm["count_diff"],
                                            "max_err": res_mm["max_err"],
                                            "share": share(out, ref_mm)},
                             "f64": {"max_err": (out.double() - ref64).abs().max().item(),
                                     "share": share(out, ref64)}}
                if name == "shipped":
                    row["shipped_worst_against_matmul_arm"] = worst(out, ref_mm, ref, ref64)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
