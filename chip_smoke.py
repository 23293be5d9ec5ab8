"""Drive the PyTorch/H100 port on one NVIDIA card and check it.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); fails, printing no result,
without them or outside a checkout of the repository. Every phase prints
one JSON line; any failure ends the run with a non-zero exit. Phases:

  device   the card's name and power limit (nvidia-smi)
  build    nvcc builds every kernel source (one nvcc per source, in
           parallel); registers and spill stores of each kernel (ptxas)
  round    the kernels' __device__ round_to_mantissa against the PyTorch
           version: random values, ties, carries, subnormals, Inf, NaN;
           bit-exact; and ps_matmul's tf32 split: bit-exact with
           cvt.rna.tf32.f32 on the finite values, its flag raised exactly
           on NaN, Inf and a hi rounded past FLT_MAX
  kernel   paged_mixed_attention on the card against its plain PyTorch
           version at GPT-2 small's shapes (12 heads, hd 64, block 16),
           mixed rows (qlen 1, 5, 64, 128) at ragged starts, for LAMP off,
           rule none, relaxed g0 / g1, strict g1, relaxed_ln g1, and with
           NaN-poisoned dead blocks
  decode_kernel
           paged_decode_attention (the same kernel, one query a row) on the
           card against its plain version at the same shapes: ragged
           effective lengths (1, a block edge, mid-block, a window cutting
           mid-block), every site, a GQA arena (4 KV heads), a pad row, and
           NaN-poisoned dead blocks
  micro    the kernel micro-benchmark (repro_torch.launch.kernels_micro,
           --full-width, in this process): lamp_flash_attention,
           flash_decode, the paged decode gather path and kernel, ps_matmul
           and rmsnorm at the JAX micro-benchmark's shapes, and the four
           micro kernels again at a model's full width (GPT-2 small prefill
           attention, an 8-row GPT-2 small decode, GPT-2 small's MLP
           up-projection, Gemma-7B's RMSNorm); each kernel against its plain
           version (NaN past each decode row's length), timed against the
           plain version and a PyTorch yardstick; launch counts must equal
           the run's calls x passes
  step     one full-width GPT-2 small paged_mixed_step through the kernel
           and through the plain version, on the same arena and plan
  engine   the GPT-2 small LampEngine on the card serving 8 greedy requests
           (prompts of 32-256 tokens, three sharing a 64-token prefix, 32 new
           tokens each, 128-token prefill chunks); the kernel's launch count
           must equal mixed steps x 12 layers x passes; the same stream
           through the plain version must give the same first tokens
  spec     the same engine and stream with speculative decoding (draft_len
           4), fused and then split: greedy tokens must equal the spec-off
           run's, the split twin's the fused run's, and each kernel's launch
           count what the engine's counters predict (draft launches x 4 x 12
           layers x 1 pass, split decode steps x 12 x passes, window
           launches x 12 x passes)
  profile  the fused speculative run under torch.profiler: device busy
           time and idle share, the kernels that take the most device time
  kernels  both paged kernels at every (rows, window) bucket the engine,
           fused spec and split spec runs called them at (decode: every
           (rows, rule) bucket), on a copy of each bucket's first inputs:
           calls, launches, device time (behind a sleeping kernel, and
           without it: ms_unfronted) against bound and plain version,
           the kernel held against the plain version; the buckets' calls x
           passes must add up to the runs' launch counts. Then per kernel:
           launches in the main-path runs, its time at its most common
           bucket (the decode kernel's among the draft's; the micro
           kernels: at full width) against its bound, its plain version
           and its PyTorch yardstick

and last the line {"ok": true, "device": {...}}. Weights are random, drawn
from a seed.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM rate, FP32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# kernel vs plain tolerances (tests/test_paged_kernel.py:50-65)
TOL = dict(rtol=2e-5, atol=2e-6)

H, HD, BS = 12, 64, 16
DEVICE = "cuda"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# --------------------------------------------------------------- phases

def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {src: build.ptxas_usage(src) for src in build.SIGNATURES}
    emit("build", seconds=secs, sources=list(build.SIGNATURES), ptxas=ptxas)


def phase_round():
    from repro_torch.core.numerics import round_to_mantissa
    from repro_torch.kernels.paged_attention import round_to_mantissa_device
    gen = torch.Generator().manual_seed(0)
    wide = torch.randn(1 << 16, generator=gen) * torch.pow(
        10.0, torch.randint(-30, 30, (1 << 16,), generator=gen).float())
    bits = torch.randint(-(1 << 31), (1 << 31) - 1, (1 << 16,), generator=gen,
                         dtype=torch.int64).to(torch.int32).view(torch.float32)
    special = torch.from_numpy(np.asarray(
        [0x3F800000 + (1 << 15), 0x3F800000 + (3 << 15),      # ties
         0x3FFFFFFF, 0x7F7FFFFF,                              # carries
         0x00000001, 0x007FFFFF, 0x807FFFFF, 0x80000000,      # subnormals
         0x7F800000, 0xFF800000, 0x7FC00000, 0x7F800001,      # Inf, NaN
         0x7FFFFFFF, 0xFFFFFFFF],
        np.uint32).view(np.int32)).view(torch.float32)
    x = torch.cat([wide, bits, special])
    mismatches = {}
    for mu in (1, 5, 7, 10, 16, 22, 23):
        want = round_to_mantissa(x, mu).view(torch.int32)
        got = round_to_mantissa_device(x.to(DEVICE), mu).cpu().view(torch.int32)
        mismatches[mu] = int((got != want).sum())
    # ps_matmul's tf32 split (integer rounding) against cvt.rna.tf32.f32,
    # and its flag: raised on NaN, Inf and a hi rounded past FLT_MAX
    from repro_torch.kernels.ps_matmul import tf32_split_device
    split = tf32_split_device(x.to(DEVICE)).cpu()
    fin = torch.isfinite(x)
    hi_cvt = split[:, 2].contiguous().view(torch.float32)
    flag = ~fin | ~torch.isfinite(hi_cvt)
    split_mismatches = int((split[fin, :2] != split[fin, 2:4]).sum()) + \
        int((split[:, 4].bool() != flag).sum())
    emit("round", n=int(x.numel()), mismatches=mismatches,
         tf32_split_mismatches=split_mismatches)
    require(not any(mismatches.values()), f"round_to_mantissa differs: {mismatches}")
    require(split_mismatches == 0, f"tf32 split differs: {split_mismatches}")


SITES = {
    "off": dict(enabled=False),
    "none": dict(rule="none", mu=5, granularity=0),
    "relaxed-g0": dict(rule="relaxed", mu=7, tau=0.05, granularity=0),
    "relaxed-g1": dict(rule="relaxed", mu=7, tau=0.1, granularity=1),
    "strict-g1": dict(rule="strict", mu=7, tau=0.1, granularity=1),
    "ln-g1": dict(rule="relaxed_ln", mu=7, tau=0.2, granularity=1, n_ref=64),
}
# Count slack per (row, query) of the kernel against the plain version. The
# strict rule thresholds on the softmax normalizer, summed blockwise by the
# kernel and in one pass by the plain version: 1. At granularity 0 the FP32
# dot before the PS(mu) rounding is summed in another order by the kernel
# (a sequential fma chain) than by cuBLAS: 1. Everything else is exact.
COUNT_SLACK = {"strict-g1": 1, "relaxed-g0": 1}


def make_case(seed, starts, qlens, W, n_max, Hkv=H):
    g = torch.Generator().manual_seed(seed)
    B = len(starts)
    n_blocks = 1 + B * n_max
    k = torch.randn(n_blocks, BS, Hkv, HD, generator=g) * 1.5
    v = torch.randn(n_blocks, BS, Hkv, HD, generator=g)
    perm = torch.randperm(n_blocks - 1, generator=g) + 1
    bt = torch.zeros(B, n_max, dtype=torch.int32)
    for r in range(B):
        nb = -(-(starts[r] + qlens[r]) // BS)
        bt[r, :nb] = perm[r * n_max:r * n_max + nb].int()
    q = torch.randn(B, H, W, HD, generator=g) * 1.5
    return [q, k, v, bt, torch.tensor(starts, dtype=torch.int32),
            torch.tensor(qlens, dtype=torch.int32)]


def compare(out, nsel, ref, nref, qlens, slack):
    """Max abs error and count difference over live query positions;
    raises if outside the tolerances."""
    W = out.shape[2]
    live = torch.arange(W, device=out.device)[None, :] < qlens[:, None].long()
    lo = live[:, None, :].expand(-1, out.shape[1], -1)
    err = (out[lo] - ref[lo]).abs()
    bound = TOL["atol"] + TOL["rtol"] * ref[lo].abs()
    dcnt = (nsel[live] - nref[live]).abs().max().item() if live.any() else 0.0
    ok = bool((err <= bound).all()) and bool(torch.isfinite(out[lo]).all()) \
        and dcnt <= slack
    return err.max().item(), dcnt, ok


def phase_kernel():
    from repro_torch.core.policy import LampSite
    from repro_torch.kernels import paged_attention as PA
    starts, qlens, W, n_max = [0, 37, 250, 113], [128, 5, 1, 64], 128, 24
    args = [t.to(DEVICE) for t in make_case(1, starts, qlens, W, n_max)]
    results = {}
    for name, kw in SITES.items():
        site = LampSite(**kw)
        out, nsel = PA.paged_mixed_attention(*args, site)
        torch.cuda.synchronize()
        ref, nref = PA.paged_mixed_attention_plain(*args, site)
        err, dcnt, ok = compare(out, nsel, ref, nref, args[5],
                                COUNT_SLACK.get(name, 0))
        results[name] = {"max_abs_err": err, "max_count_diff": dcnt,
                         "selected": float(nsel.sum()), "ok": ok}
    # dead table entries point at a NaN-poisoned block: it must never be read
    q, k, v, bt, st, ql = make_case(2, starts, qlens, W, n_max)
    # one extra block, in no row's live span: dead table entries point at it
    poison = k.shape[0]
    k = torch.cat([k, torch.zeros_like(k[:1])])
    v = torch.cat([v, torch.zeros_like(v[:1])])
    for r in range(len(starts)):
        bt[r, -(-(starts[r] + qlens[r]) // BS):] = poison
    k_bad, v_bad = k.clone(), v.clone()
    k_bad[poison] = float("nan")
    v_bad[poison] = float("nan")
    site = LampSite(**SITES["relaxed-g1"])
    c = [t.to(DEVICE) for t in (q, k_bad, v_bad, bt, st, ql)]
    out, nsel = PA.paged_mixed_attention(*c, site)
    torch.cuda.synchronize()
    ref, nref = PA.paged_mixed_attention_plain(
        *[t.to(DEVICE) for t in (q, k, v, bt, st, ql)], site)
    err, dcnt, ok = compare(out, nsel, ref, nref, c[5], 0)
    results["nan-dead-blocks"] = {"max_abs_err": err, "max_count_diff": dcnt,
                                  "ok": ok}
    emit("kernel", shapes={"B": 4, "H": H, "W": W, "hd": HD, "bs": BS,
                           "n_max": n_max, "starts": starts, "qlens": qlens},
         tolerance={**TOL, "count_slack": COUNT_SLACK}, results=results)
    require(all(r["ok"] for r in results.values()),
            f"kernel disagrees with its plain version: {results}")


def make_decode_case(seed, lengths, n_max, Hkv=H):
    """Random arena and shuffled block tables for decode rows of effective
    `lengths`; the last row is padding (length 1, null table)."""
    g = torch.Generator().manual_seed(seed)
    R = len(lengths)
    n_blocks = 1 + R * n_max
    k = torch.randn(n_blocks, BS, Hkv, HD, generator=g) * 1.5
    v = torch.randn(n_blocks, BS, Hkv, HD, generator=g)
    perm = torch.randperm(n_blocks - 1, generator=g) + 1
    bt = torch.zeros(R, n_max, dtype=torch.int32)
    for r in range(R - 1):
        nb = -(-lengths[r] // BS)
        bt[r, :nb] = perm[r * n_max:r * n_max + nb].int()
    q = torch.randn(R, H, 1, HD, generator=g) * 1.5
    return [q, k, v, bt, torch.tensor(lengths, dtype=torch.int32)]


def compare_rows(out, nsel, ref, nref, slack):
    """Max abs error, count difference and whether both are within the
    tolerances, over every row (decode rows have no padding queries)."""
    err = (out - ref).abs()
    bound = TOL["atol"] + TOL["rtol"] * ref.abs()
    dcnt = (nsel - nref).abs().max().item()
    ok = bool((err <= bound).all()) and bool(torch.isfinite(out).all()) \
        and dcnt <= slack
    return err.max().item(), dcnt, ok


# ragged effective lengths: 1, a block edge, mid-block, long; a window of
# 40 cuts rows 100 and 191 mid-block; the last row is a pad row
DEC_LENGTHS = [1, 16, 37, 100, 191, 300, 1]
DEC_NMAX = 20
DEC_WINDOW = 40


def phase_decode_kernel():
    from repro_torch.core.policy import LampSite
    from repro_torch.kernels import paged_attention as PA
    results = {}
    for hkv, window in ((H, None), (H, DEC_WINDOW), (4, None)):
        args = [t.to(DEVICE) for t in make_decode_case(
            11, DEC_LENGTHS, DEC_NMAX, Hkv=hkv)]
        for name, kw in SITES.items():
            site = LampSite(**kw)
            out, nsel = PA.paged_decode_attention(*args, site, window=window)
            torch.cuda.synchronize()
            ref, nref = PA.paged_decode_attention_plain(*args, site,
                                                        window=window)
            err, dcnt, ok = compare_rows(out, nsel, ref, nref,
                                         COUNT_SLACK.get(name, 0))
            results[f"{name}/hkv{hkv}/window{window}"] = {
                "max_abs_err": err, "max_count_diff": dcnt,
                "selected": float(nsel.sum()), "ok": ok}
    # every dead table entry (past the length, before the window) points at
    # one NaN-poisoned block, which must never be read
    q, k, v, bt, lengths = make_decode_case(12, DEC_LENGTHS, DEC_NMAX)
    poison = k.shape[0]
    k = torch.cat([k, torch.zeros_like(k[:1])])
    v = torch.cat([v, torch.zeros_like(v[:1])])
    for window in (None, DEC_WINDOW):
        btw = bt.clone()
        for r in range(len(DEC_LENGTHS) - 1):
            L = DEC_LENGTHS[r]
            btw[r, -(-L // BS):] = poison
            if window is not None:
                btw[r, :max(L - window, 0) // BS] = poison
        k_bad, v_bad = k.clone(), v.clone()
        k_bad[poison] = float("nan")
        v_bad[poison] = float("nan")
        for name in ("relaxed-g1", "strict-g1"):
            site = LampSite(**SITES[name])
            c = [t.to(DEVICE) for t in (q, k_bad, v_bad, btw, lengths)]
            out, nsel = PA.paged_decode_attention(*c, site, window=window)
            torch.cuda.synchronize()
            ref, nref = PA.paged_decode_attention_plain(
                *[t.to(DEVICE) for t in (q, k, v, btw, lengths)], site,
                window=window)
            err, dcnt, ok = compare_rows(out, nsel, ref, nref,
                                         COUNT_SLACK.get(name, 0))
            results[f"nan-dead-blocks/{name}/window{window}"] = {
                "max_abs_err": err, "max_count_diff": dcnt, "ok": ok}
    emit("decode_kernel", shapes={"R": len(DEC_LENGTHS), "H": H, "hd": HD,
                                  "bs": BS, "n_max": DEC_NMAX,
                                  "lengths": DEC_LENGTHS, "window": DEC_WINDOW,
                                  "gqa_kv_heads": 4},
         tolerance={**TOL, "count_slack": COUNT_SLACK}, results=results)
    require(all(r["ok"] for r in results.values()),
            f"decode kernel disagrees with its plain version: {results}")


# the micro kernels: wrapper name -> (source, the TPU kernel it replaces,
# the micro run's full-width row); each runs twice in the micro run (its
# micro row and its full-width row), flash_decode with two passes a call
MICRO_KERNELS = {
    "lamp_flash_attention": ("src/repro_torch/kernels/csrc/lamp_attention.cu",
                             "src/repro/kernels/lamp_attention.py:106", 0),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:109", 1),
    "ps_matmul": ("src/repro_torch/kernels/csrc/ps_matmul.cu",
                  "src/repro/kernels/ps_matmul.py:46", 2),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:25", 3),
}
MICRO_LAUNCHES = {"lamp_flash_attention": 2, "flash_decode": 4,
                  "paged_decode_attention": 2, "ps_matmul": 2, "rmsnorm": 2}


def phase_micro():
    """The port's kernel micro-benchmark, full width included, as its main
    path: every wrapper's count set to 0 just before and read just after."""
    from repro_torch.launch import kernels_micro as KM
    for w in KM.WRAPPERS.values():
        w.launches = 0
    rows = KM.run(DEVICE, full_width=True)
    launches = {n: w.launches for n, w in KM.WRAPPERS.items()}
    for r in rows:
        emit("micro", **r)
    emit("micro_launches", launches=launches, expected=MICRO_LAUNCHES)
    require(all(r["ok"] for r in rows),
            "a micro kernel disagrees with its plain version: "
            f"{[r['name'] for r in rows if not r['ok']]}")
    require(launches == MICRO_LAUNCHES, f"micro launches {launches}")
    out = []
    for name, (source, replaces, i) in MICRO_KERNELS.items():
        r = next(r for r in rows if r["name"] == KM.FULL_WIDTH_NAMES[i])
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": r["max_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    return out


def gpt2_small():
    from repro_torch.configs import get_config
    return get_config("gpt2-small")


def with_plain_attention(fn):
    """Run `fn` with the model's paged attention swapped for the plain
    version (the comparison arm; the port itself never does this)."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import transformer as TT
    kernel = TT.PA.paged_mixed_attention
    TT.PA.paged_mixed_attention = PA.paged_mixed_attention_plain
    try:
        return fn()
    finally:
        TT.PA.paged_mixed_attention = kernel


# One full-width step, kernel against plain. Under the strict rule a
# selection may flip between the two (one per query row, the kernel's count
# slack); a flip moves one attention logit between its PS(7) and FP32
# values, a change of up to 2^-8 relative, and the 12 layers carry such
# changes into the hidden states, the K/V written by later layers, the
# later layers' selections and the logits. Tolerances for that: logits and
# arena 1e-2 absolute with equal argmax per row; per (layer, row) counts
# within qlens[b] plus 2% of the count; valid counts exact.
STEP_ATOL = 1e-2
STEP_COUNT_REL = 0.02


def phase_step(params, cfg):
    from repro_torch.models import transformer as TT
    starts = [0, 100, 37, 250, 0]
    qlens = [128, 64, 1, 1, 1]                # last row: padding
    W, n_max = 128, 20
    B = len(starts)
    g = torch.Generator().manual_seed(3)
    n_blocks = 1 + B * n_max
    shape = (cfg.n_layers, n_blocks, BS, cfg.n_kv_heads, cfg.hd)
    ak, av = torch.randn(shape, generator=g), torch.randn(shape, generator=g)
    perm = torch.randperm(n_blocks - 1, generator=g) + 1
    bt = torch.zeros(B, n_max, dtype=torch.int32)
    for r in range(B - 1):
        nb = -(-(starts[r] + qlens[r]) // BS)
        bt[r, :nb] = perm[r * n_max:r * n_max + nb].int()
    tokens = torch.randint(0, cfg.vocab, (B, W), generator=g, dtype=torch.int32)
    dev = torch.device(DEVICE)
    idx = [t.to(dev) for t in (tokens, bt, torch.tensor(starts, dtype=torch.int32),
                               torch.tensor(qlens, dtype=torch.int32))]

    def run():
        arena = {"k": ak.to(dev), "v": av.to(dev)}
        with torch.no_grad():
            logits, arena, (nsel, nval) = TT.paged_mixed_step(
                cfg, params, idx[0], arena, idx[1], idx[2], idx[3],
                per_layer=True)
        torch.cuda.synchronize()
        return logits[:B - 1], arena, nsel[:, :B - 1], nval[:, :B - 1]

    lk, arena_k, sk, vk = run()
    lp, arena_p, sp, vp = with_plain_attention(run)
    logit_err = (lk - lp).abs().max().item()
    # block 0 is the null block: padding tokens all write it, in no fixed
    # order on the card, and nothing live reads it
    arena_err = max((arena_k[n][:, 1:] - arena_p[n][:, 1:]).abs().max().item()
                    for n in "kv")
    count_diff = (sk - sp).abs()
    slack = torch.tensor(qlens[:B - 1], device=dev,
                         dtype=torch.float32)[None, :] + STEP_COUNT_REL * sp
    checks = {
        "logits_finite": bool(torch.isfinite(lk).all()),
        "logits_close": logit_err <= STEP_ATOL,
        "argmax_equal": bool(torch.equal(lk.argmax(-1), lp.argmax(-1))),
        "arena_close": arena_err <= STEP_ATOL,
        "counts_close": bool((count_diff <= slack).all()),
        "valid_equal": bool(torch.equal(vk, vp)),
    }
    ok = all(checks.values())
    emit("step", rows=B, window=W, starts=starts, qlens=qlens,
         logits_shape=list(lk.shape), max_abs_logit=lp.abs().max().item(),
         max_abs_logit_err=logit_err, max_arena_err=arena_err, atol=STEP_ATOL,
         max_count_diff_per_layer_row=count_diff.max().item(),
         count_slack=f"qlens[b] + {STEP_COUNT_REL} x count per (layer, row)",
         selected_kernel=float(sk.sum()), selected_plain=float(sp.sum()),
         valid=float(vk.sum()), checks=checks, ok=ok)
    require(ok, "full-width step: kernel and plain version disagree")


def engine_requests(cfg):
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, size=64).tolist()
    lens = [256, 40, 180, 96, 32, 220, 128, 60]
    reqs = []
    for i, n in enumerate(lens):
        body = rng.integers(0, cfg.vocab, size=n).tolist()
        prompt = (shared + body)[:n] if i % 3 == 0 else body
        reqs.append(prompt)
    return reqs


def run_engine(params, cfg, **options):
    """Serve the stream; returns (engine, outputs, wall seconds). Each
    step's wall time is kept on `engine.step_ms` under its kind: whether it
    ran a speculative round ("spec") or not ("plain"), with prefill rows
    ("+prefill") or without."""
    from repro_torch.serving import EngineConfig, LampEngine, SamplingParams
    eng = LampEngine(cfg, params, EngineConfig(
        block_size=BS, max_model_len=320, n_blocks=8 * 20 + 1,
        max_prefill_tokens=128, device=DEVICE, **options))
    for i, prompt in enumerate(engine_requests(cfg)):
        eng.add_request(prompt, SamplingParams(max_new_tokens=32, seed=i))
    eng.step_ms = collections.defaultdict(list)
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.has_unfinished():
        s0 = time.perf_counter()
        rounds, prefills = eng.spec_rounds, eng.prefill_steps
        outs.extend(eng.step())
        torch.cuda.synchronize()
        kind = ("spec" if eng.spec_rounds > rounds else "plain") + \
            ("+prefill" if eng.prefill_steps > prefills else "")
        eng.step_ms[kind].append(1e3 * (time.perf_counter() - s0))
    torch.cuda.synchronize()
    return eng, outs, time.perf_counter() - t0


def step_breakdown(eng):
    return {k: {"steps": len(v), "mean_ms": statistics.mean(v),
                "median_ms": statistics.median(v)}
            for k, v in sorted(eng.step_ms.items())}


class Recorder:
    """Wraps both paged wrappers for the engine runs: counts calls per run
    and bucket, and keeps a copy of the inputs of each bucket's first call
    (for timing the kernels at every bucket the engine ran). Mixed buckets
    are (rows, window), decode buckets (rows, rule)."""

    def __init__(self):
        self.calls = collections.defaultdict(collections.Counter)
        self.captured = {}
        self.run = None

    def __enter__(self):
        from repro_torch.kernels import paged_attention as PA
        self.mixed, self.decode = PA.paged_mixed_attention, PA.paged_decode_attention

        def mixed(q, ak, av, bt, starts, qlens, site, *, tau=None, window=None):
            self.note(("mixed", q.shape[0], q.shape[2]),
                      (q, ak, av, bt, starts, qlens), site, tau, window)
            return self.mixed(q, ak, av, bt, starts, qlens, site, tau=tau,
                              window=window)

        def decode(q, ak, av, bt, lengths, site, *, tau=None, window=None):
            self.note(("decode", q.shape[0], site.rule if site.enabled else "off"),
                      (q, ak, av, bt, lengths), site, tau, window)
            return self.decode(q, ak, av, bt, lengths, site, tau=tau,
                               window=window)

        PA.paged_mixed_attention, PA.paged_decode_attention = mixed, decode
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import paged_attention as PA
        PA.paged_mixed_attention, PA.paged_decode_attention = self.mixed, self.decode

    def note(self, key, tensors, site, tau, window):
        self.calls[key][self.run] += 1
        if key not in self.captured:
            self.captured[key] = ([t.clone() for t in tensors], site,
                                  None if tau is None else tau.clone(), window)

    def buckets(self, kind, run):
        return {f"{a}x{b}": c[run] for (k, a, b), c in sorted(
            self.calls.items(), key=lambda kv: str(kv[0])) if k == kind and c[run]}


def phase_engine(params, cfg, rec):
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import transformer as TT

    rec.run = "engine"
    with rec:
        PA._wrapper.launches = 0          # count the main path's launches only
        eng, outs, wall = run_engine(params, cfg)
        launches = PA._wrapper.launches
    s = eng.stats()
    site = TT._kq_site(cfg, True)
    expected = eng.mixed_steps * cfg.n_layers * PA.passes(site)
    gen_ok = all(len(o.tokens) == 32 and all(0 <= t < cfg.vocab for t in o.tokens)
                 for o in outs)
    # the same stream through the plain version on the card
    peng, pouts, pwall = with_plain_attention(lambda: run_engine(params, cfg))
    kt = {o.req_id: o.tokens for o in outs}
    pt = {o.req_id: o.tokens for o in pouts}
    first_same = all(kt[r][0] == pt[r][0] for r in kt)
    same = sum(a == b for r in kt for a, b in zip(kt[r], pt[r]))
    ok = (len(outs) == 8 and gen_ok and launches == expected and launches > 0
          and first_same and peng.mixed_steps > 0
          and s["prefill_chunks"] > 0 and s["cached_tokens"] > 0)
    emit("engine", requests=len(outs), steps=eng.mixed_steps,
         wall_s=wall, ms_per_step=1e3 * wall / eng.mixed_steps,
         generated_tokens=eng.generated_tokens,
         tokens_per_s=eng.generated_tokens / wall,
         lamp_recompute_rate=s["lamp_recompute_rate"],
         prefix_hit_rate=s["cache_hit_rate"], cached_tokens=s["cached_tokens"],
         prefill_chunks=s["prefill_chunks"], preemptions=s["preemptions"],
         kernel_launches=launches, expected_launches=expected,
         buckets=rec.buckets("mixed", "engine"),
         step_ms=step_breakdown(eng),
         plain_wall_s=pwall, plain_ms_per_step=1e3 * pwall / peng.mixed_steps,
         first_tokens_equal_plain=first_same,
         tokens_equal_plain=f"{same}/{sum(len(t) for t in kt.values())}",
         note="timed with a recording wrapper that copies the inputs of "
              "each bucket's first call", ok=ok)
    require(ok, "engine run failed its checks")
    return launches, kt


def top2_gap(params, cfg, prompt, toks, pos):
    """The gap between the two largest logits after prompt + toks[:pos],
    from one prefill window on a fresh arena: how close the reference's
    greedy choice at that position was to a tie."""
    from repro_torch.models import transformer as TT
    seq = list(prompt) + list(toks[:pos])
    n = len(seq)
    nb = -(-n // BS)
    arena = TT.init_paged_cache(cfg, nb + 1, BS, device=DEVICE)
    dev = torch.device(DEVICE)
    with torch.no_grad():
        logits, _, _ = TT.paged_prefill_window(
            cfg, params, torch.tensor([seq], dtype=torch.int32, device=dev),
            arena, torch.arange(1, nb + 1, dtype=torch.int32, device=dev)[None],
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.tensor([n], dtype=torch.int32, device=dev))
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


def first_difference(got, want):
    for rid in sorted(want):
        for pos, (a, b) in enumerate(zip(got.get(rid, []), want[rid])):
            if a != b:
                return rid, pos
        if len(got.get(rid, [])) != len(want[rid]):
            return rid, min(len(got.get(rid, [])), len(want[rid]))
    return None


SPEC_DRAFT_LEN = 4


def phase_spec(params, cfg, ref_tokens, rec):
    """Speculative decoding on the engine's stream, fused then split."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import transformer as TT
    from repro_torch.serving.speculative import draft_model_config

    prompts = engine_requests(cfg)
    runs = {}
    with rec:
        for mode in ("fused", "split"):
            rec.run = f"spec_{mode}"
            PA._wrapper.launches = 0        # count this run's launches only
            PA._decode_wrapper.launches = 0
            eng, outs, wall = run_engine(params, cfg, speculative=True,
                                         draft_len=SPEC_DRAFT_LEN,
                                         mixed_exec=mode)
            runs[mode] = (eng, outs, wall, PA._decode_wrapper.launches,
                          PA._wrapper.launches)
    ok_all = True
    launches = {"decode": 0, "mixed": 0}
    for mode, (eng, outs, wall, dec_l, mix_l) in runs.items():
        L = cfg.n_layers
        lc = eng.launch_counts
        site = TT._kq_site(cfg, True)
        dsite = TT._kq_site(draft_model_config(cfg), True)
        exp_dec = (lc["draft"] * SPEC_DRAFT_LEN * L * PA.passes(dsite)
                   + lc["decode"] * L * PA.passes(site))
        exp_mix = (lc["mixed"] + lc["prefill"] + lc["verify"]) * L * PA.passes(site)
        toks = {o.req_id: o.tokens for o in outs}
        want = ref_tokens if mode == "fused" else \
            {o.req_id: o.tokens for o in runs["fused"][1]}
        diff = first_difference(toks, want)
        where = None
        if diff is not None:
            rid, pos = diff
            where = {"request": rid, "position": pos,
                     "got": toks[rid][pos:pos + 4], "want": want[rid][pos:pos + 4],
                     "reference_top2_logit_gap": top2_gap(
                         params, cfg, prompts[rid], want[rid], pos)}
        st = eng.stats()
        ok = (len(outs) == 8 and diff is None and dec_l == exp_dec > 0
              and mix_l == exp_mix > 0 and st["spec_rounds"] > 0)
        ok_all = ok_all and ok
        launches["decode"] += dec_l
        launches["mixed"] += mix_l
        emit("spec", mixed_exec=mode, draft_len=SPEC_DRAFT_LEN,
             requests=len(outs), steps=eng.mixed_steps,
             spec_rounds=st["spec_rounds"],
             acceptance_rate=st["spec_acceptance_rate"],
             tokens_per_round=st["spec_tokens_per_round"],
             verify_recompute_rate=st["verify_recompute_rate"],
             lamp_recompute_rate=st["lamp_recompute_rate"],
             wall_s=wall, ms_per_step=1e3 * wall / eng.mixed_steps,
             step_ms=step_breakdown(eng),
             generated_tokens=eng.generated_tokens,
             tokens_per_s=eng.generated_tokens / wall,
             launches_by_fn=st["launches_by_fn"],
             decode_kernel_launches=dec_l, expected_decode_launches=exp_dec,
             mixed_kernel_launches=mix_l, expected_mixed_launches=exp_mix,
             tokens_equal=("spec-off fused run" if mode == "fused"
                           else "fused spec run") if diff is None else False,
             first_difference=where, ok=ok)
    emit("spec_buckets", **{
        f"{kind}_{run}": rec.buckets(kind, run) for kind in ("mixed", "decode")
        for run in ("spec_fused", "spec_split")})
    require(ok_all, "speculative engine runs failed their checks")
    return launches, runs["fused"][2]


def phase_profile(params, cfg, unprofiled_wall):
    """The fused speculative run once more under torch.profiler: the
    kernels' summed device time against the run's wall time (device busy
    and idle share), and the kernels that take most of it. The profiler
    slows the host, so the idle share is given against both the profiled
    wall time and the unprofiled run's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import paged_attention as PA
    saved = PA._wrapper.launches, PA._decode_wrapper.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng, _, wall = run_engine(params, cfg, speculative=True,
                                  draft_len=SPEC_DRAFT_LEN)
    PA._wrapper.launches, PA._decode_wrapper.launches = saved
    rows = []
    for e in prof.key_averages():
        # device events only: a host op (aten::mm) may also carry the time
        # of the kernels it launched, which would count them twice
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    measured = busy > 0
    emit("profile", run="spec fused", steps=eng.mixed_steps,
         wall_ms=1e3 * wall, unprofiled_wall_ms=1e3 * unprofiled_wall,
         device_busy_ms=busy if measured else "not measured",
         idle_share=1 - busy / (1e3 * wall) if measured else "not measured",
         idle_share_unprofiled=(1 - busy / (1e3 * unprofiled_wall)
                                if measured else "not measured"),
         top=[{"name": k[:96], "device_ms": t, "calls": c}
              for k, t, c in rows[:12]])


def time_device(launch, reps=50, front=True):
    """Device time of `launch` (the kernel's passes, arguments bound once),
    enqueued back to back behind a sleeping kernel, so the host's per-call
    work stays out of the timing (``kernel_variants.back_to_back_ms``).
    front=False leaves the sleeping kernel out: the launches then run as
    fast as the host enqueues them."""
    from repro_torch.launch.kernel_variants import back_to_back_ms
    return back_to_back_ms(launch, reps, front)


def time_call(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def live_kv_positions(bt, spans, bs):
    """Distinct arena positions (block id, offset) that the key spans read:
    spans[r] = (first, last) key position of row r, inclusive. A block
    counts only its live positions, and a block shared by rows once."""
    seen = set()
    for r, (first, last) in enumerate(spans):
        for pos in range(first, last + 1):
            seen.add((int(bt[r, pos // bs]), pos % bs))
    return len(seen)


def bound_at(args, site, out, nsel, window):
    """Least time the card could take for this call's work: the larger of
    the bytes it must move (live q read, each live K/V position read once,
    the live output and the counts written) over the HBM rate, and the FP32
    operations these inputs need (y_low and P.V for every causal query-key
    pair, plus the FP32 recompute of the selected ones) over the FP32 rate."""
    q, ak, av, bt, starts, qlens = args
    B, Hq, W, hd = q.shape
    _, bs, Hkv, _ = ak.shape
    bt, starts, qlens = bt.cpu(), starts.cpu(), qlens.cpu()
    spans, pairs = [], 0
    for b in range(B):
        s, n = int(starts[b]), int(qlens[b])
        first = 0 if window is None else max(s - window + 1, 0)
        spans.append((first, s + n - 1))
        for w in range(n):
            pos = s + w
            pairs += pos + 1 if window is None else min(pos + 1, window)
    live_q = int(qlens.sum())
    nbytes = (live_q * Hq * hd * 4 * 2                       # q in, out
              + live_kv_positions(bt, spans, bs) * Hkv * hd * 4 * 2  # K, V
              + bt.numel() * 4 + B * 8 + B * W * 4)          # tables, counts
    selected = float(nsel.sum())
    flops = pairs * Hq * 4 * hd + selected * 2 * hd if site.enabled else \
        pairs * Hq * 4 * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), \
        nbytes, flops


def decode_bound_at(args, site, nsel, window):
    """`bound_at` for the decode kernel: the live q read, each valid K/V
    position [max(L - window, 0), L) read once, the output and counts
    written, over the HBM rate; y_low and P.V for every valid key of every
    row and head, plus the FP32 recompute of the selected ones, over the
    FP32 rate."""
    q, ak, av, bt, lengths = args
    R, Hq, _, hd = q.shape
    _, bs, Hkv, _ = ak.shape
    bt, lengths = bt.cpu(), lengths.cpu()
    spans, pairs = [], 0
    for r in range(R):
        L = int(lengths[r])
        spans.append((0 if window is None else max(L - window, 0), L - 1))
        pairs += L if window is None else min(L, window)
    nbytes = (R * Hq * hd * 4 * 2                            # q in, out
              + live_kv_positions(bt, spans, bs) * Hkv * hd * 4 * 2  # K, V
              + bt.numel() * 4 + R * 4 + R * Hq * 4)         # tables, counts
    flops = pairs * Hq * 4 * hd + (float(nsel.sum()) * 2 * hd
                                   if site.enabled else 0.0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), \
        nbytes, flops


def measure(kernel, plain, launch, counter, plain_reps=20):
    """plain, kernel, kernel(, plain): one card, one call, in turns. The
    kernel's time is its device time (arguments bound once), each reading
    followed by one without the sleeping kernel in front ("unfronted":
    the slower of device and host enqueueing); call_ms adds the wrapper's
    host work (checks, allocation, ctypes) around one call. With
    plain_reps < 20 the plain version (an oracle, not a yardstick) is
    timed once, with fewer repetitions. Timing launches are taken off the
    counter."""
    before = counter.launches
    p = [time_call(plain, plain_reps)]
    k, u = [], []
    for _ in range(2):
        k.append(time_device(launch))
        u.append(time_device(launch, front=False))
    if plain_reps >= 20:
        p.append(time_call(plain))
    c1 = time_call(kernel)
    counter.launches = before
    return {"kernel": k, "unfronted": u, "plain": p}, c1


PAGED_SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"


def time_bucket(key, captured, calls, headline):
    """One bucket of the engine runs: the kernel against its plain version
    on the bucket's first inputs (tolerances as in phases kernel and
    decode_kernel), its device time, its bound. Returns the phase line."""
    from repro_torch.kernels import paged_attention as PA
    kind, rows, w = key
    args, site, tau, window = captured
    slack = 1 if site.enabled and (site.rule == "strict" or
                                   site.granularity == 0) else 0
    if kind == "mixed":
        kernel = lambda: PA.paged_mixed_attention(*args, site, tau=tau,
                                                  window=window)
        plain = lambda: PA.paged_mixed_attention_plain(*args, site, tau=tau,
                                                       window=window)
        counter, prepare = PA._wrapper, PA.prepare_launch
    else:
        kernel = lambda: PA.paged_decode_attention(*args, site, tau=tau,
                                                   window=window)
        plain = lambda: PA.paged_decode_attention_plain(*args, site, tau=tau,
                                                        window=window)
        counter, prepare = PA._decode_wrapper, PA.prepare_decode_launch
    before = counter.launches
    out, nsel = kernel()
    ref, nref = plain()
    torch.cuda.synchronize()
    counter.launches = before
    if kind == "mixed":
        err, dcnt, ok = compare(out, nsel, ref, nref, args[5], slack)
        bound, bound_by, nbytes, flops = bound_at(args, site, out, nsel, window)
        shape = {"rows": rows, "window": w, "qlens": args[5].tolist(),
                 "starts": args[4].tolist()}
    else:
        err, dcnt, ok = compare_rows(out, nsel, ref, nref, slack)
        bound, bound_by, nbytes, flops = decode_bound_at(args, site, nsel, window)
        shape = {"rows": rows, "lengths": args[4].tolist()}
    launch, _, _ = prepare(*args, site, tau, window)
    runs, c1 = measure(kernel, plain, launch, counter,
                       plain_reps=20 if headline else 5)
    n_calls = sum(calls.values())
    line = {"kernel": f"paged_{kind}_attention", "bucket": shape,
            "rule": site.rule if site.enabled else "off",
            "passes": PA.passes(site), "calls": dict(calls),
            "launches": n_calls * PA.passes(site),
            "ms": statistics.median(runs["kernel"]), "ms_runs": runs["kernel"],
            "ms_unfronted": statistics.median(runs["unfronted"]),
            "ms_unfronted_runs": runs["unfronted"],
            "plain_ms": statistics.median(runs["plain"]), "call_ms": c1,
            "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
            "flops": flops, "max_abs_err": err, "max_count_diff": dcnt,
            "count_slack": slack, "headline": headline, "ok": ok}
    emit("kernels", **line)
    require(ok, f"{kind} kernel disagrees with its plain version at bucket "
                f"{key}")
    return line


def phase_kernels(rec, mixed_launches, decode_launches):
    """Both paged kernels at every bucket the engine runs called them at;
    the kernels line gives each at its most common bucket (the mixed
    kernel's over the three runs, the decode kernel's among the draft's)."""
    lines = {}
    top = {}
    for kind in ("mixed", "decode"):
        keys = [k for k in rec.captured if k[0] == kind]
        if kind == "decode":             # the draft runs rule none
            keys_top = [k for k in keys if k[2] == "none"] or keys
        else:
            keys_top = keys
        top[kind] = max(keys_top, key=lambda k: (sum(rec.calls[k].values()), k[1]))
        for key in sorted(keys, key=str):
            lines[key] = time_bucket(key, rec.captured[key], rec.calls[key],
                                     key == top[kind])
    rows = []
    for kind, launches, replaces in (
            ("mixed", mixed_launches, "src/repro/kernels/paged_attention.py:454"),
            ("decode", decode_launches, "src/repro/kernels/paged_attention.py:239")):
        line = lines[top[kind]]
        rows.append({"name": f"paged_{kind}_attention", "route": "cuda",
                     "source": PAGED_SOURCE, "replaces": replaces,
                     "launches": launches, "max_abs_err": line["max_abs_err"],
                     "ms": line["ms"], "plain_ms": line["plain_ms"],
                     "bound_ms": line["bound_ms"], "bound_by": line["bound_by"],
                     "library_ms": None})
    in_buckets = {k: sum(l["launches"] for key, l in lines.items()
                         if key[0] == k) for k in ("mixed", "decode")}
    launches = {"mixed": mixed_launches, "decode": decode_launches}
    emit("kernels_summary", buckets=len(lines), launches=launches,
         launches_in_buckets=in_buckets,
         library_note="no PyTorch call computes LAMP attention, so "
                      "library_ms is null")
    require(in_buckets == launches, "the buckets' calls x passes do not add "
                                    "up to the runs' launch counts")
    return rows


def main() -> int:
    t0 = time.perf_counter()
    phase_device()
    from repro_torch.models import transformer as TT
    phase_build()
    phase_round()
    phase_kernel()
    phase_decode_kernel()
    micro_rows = phase_micro()
    cfg = gpt2_small()
    params = TT.init_params(cfg, 0, device=DEVICE)
    phase_step(params, cfg)
    rec = Recorder()
    launches, ref_tokens = phase_engine(params, cfg, rec)
    spec_launches, spec_wall = phase_spec(params, cfg, ref_tokens, rec)
    phase_profile(params, cfg, spec_wall)
    rows = phase_kernels(rec, launches + spec_launches["mixed"],
                         spec_launches["decode"])
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": rows + micro_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
