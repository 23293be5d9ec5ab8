"""Kernel micro-benchmark of the port: the twin of
``benchmarks/kernels_micro.py``.

    PYTHONPATH=src python -m repro_torch.launch.kernels_micro [--device cpu] \
        [--full-width]

Drives every row of the JAX micro-benchmark, under its names, shapes and
arguments, through the port's wrappers: lamp_flash_attention, flash_decode,
the paged decode path twice (the gather path and the hand-written paged
decode kernel), ps_matmul and rmsnorm. Inputs are drawn with numpy from
fixed seeds. Each row's wrapper result is held against the kernel's plain
version on the same inputs (max_err, nsel against nsel_ref), and one JSON
line is printed per row. With ``--full-width`` each of the four kernels
also runs at the width of a model the repository has: a GPT-2 small
prefill (lamp attention), an 8-row GPT-2 small decode bucket
(flash_decode), GPT-2 small's MLP up-projection on a 1024-token prefill
(ps_matmul) and Gemma-7B's RMSNorm over 4096 rows (rmsnorm).

Runs on CUDA unless ``--device cpu`` (where the wrappers run their plain
versions, so kernel and plain agree by construction). On the card each row
also carries the device time of the kernel (CUDA events, L2 flushed before
each launch), of the plain version and of one PyTorch call computing the
same function where there is one (the yardstick; the port never calls it)
with the CUDA kernels that call ran (``library_kernel``, from
torch.profiler), the least time the card could take (bound_ms) and whether
bytes or operations set it. The kernels' inputs past a decode row's length
are NaN-poisoned on the card: they must never be read.

Tolerances, kernel against plain: attention outputs rtol 2e-5 / atol 2e-6
on every query row and counts exact (kernel and plain version sum y_low in
the same order, ``slab_sums``). The paged decode row at granularity 0: one
count per row (the FP32 dot before the rounding is summed in either
order). ps_matmul: one PS(mu) step (``ps_matmul_slack``: the tensor cores
sum a slab in their own order). rmsnorm (bfloat16): one bfloat16 step
(rtol 2e-2).
"""

from __future__ import annotations

import argparse
import json
import statistics
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.policy import LampSite
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import lamp_attention as LA
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import ps_matmul as PM
from repro_torch.kernels import rmsnorm as RN
from repro_torch.models.transformer import resolve_device

ROW_NAMES = ("kernel_lamp_attention_256", "kernel_flash_decode_2k",
             "kernel_paged_decode_gather", "kernel_paged_decode_fused",
             "kernel_ps_matmul_256", "kernel_rmsnorm_1024x512")
FULL_WIDTH_NAMES = ("kernel_lamp_attention_gpt2_prefill_1024",
                    "kernel_flash_decode_gpt2_decode_8x1024",
                    "kernel_ps_matmul_gpt2_mlp_1024x768x3072",
                    "kernel_rmsnorm_gemma7b_4096x3072")

# H100 SXM peaks (NVIDIA data sheet): HBM rate, FP32 outside the tensor
# cores, dense TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

TOL = dict(rtol=2e-5, atol=2e-6)
RMS_TOL = dict(rtol=2e-2, atol=1e-6)      # bfloat16: one bfloat16 step

# the wrappers whose launches a run counts
WRAPPERS = {"lamp_flash_attention": LA._wrapper, "flash_decode": FD._wrapper,
            "paged_decode_attention": PA._decode_wrapper,
            "ps_matmul": PM._wrapper, "rmsnorm": RN._wrapper}


class Timer:
    """Device times on the card, with the L2 cache (50 MB) flushed before
    each call, as a caller streaming other layers' weights would find it."""

    def __init__(self, device: torch.device):
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device=device)

    def ms(self, fn: Callable, reps: int = 20) -> float:
        for _ in range(2):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def bound(nbytes: float, flops: float, rate: float = FP32_FLOP_PER_S) -> Dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over their peak `rate` (FP32 on the CUDA
    cores unless given)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "bound_flops": int(flops)}


def counted(name: str, fn: Callable):
    """Run `fn` (one main-path call of a wrapper) and return its result and
    the launches it added to the wrapper's counter."""
    before = WRAPPERS[name].launches
    out = fn()
    return out, WRAPPERS[name].launches - before


def _rand(rng, shape, scale=1.0) -> np.ndarray:
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(x: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(x).to(dev)


def library_kernels(fn: Callable) -> List[str]:
    """The CUDA kernels one call of `fn` runs (torch.profiler), by name;
    empty where the profiler sees no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA})


def compare_rows(out, cnt, ref, cref) -> Dict:
    """Kernel (out, per-row counts) against the plain version's: every
    query row within TOL, every count exact. `apart_rows` counts the rows
    that are not."""
    D = out.shape[-1]
    out, ref = out.reshape(-1, D), ref.reshape(-1, D)
    cnt, cref = cnt.reshape(-1), cref.reshape(-1)
    err = (out - ref).abs()
    bad = (err > TOL["atol"] + TOL["rtol"] * ref.abs()).any(-1) | \
        ~torch.isfinite(out).all(-1) | (cnt != cref)
    return {"max_err": err.max().item(), "apart_rows": int(bad.sum()),
            "count_diff": int((cnt - cref).abs().sum()),
            "ok": not bool(bad.any())}


PS_SLACK = ("at mu < 23 at most max(2, 0.1% of M N) outputs differ, each "
            "within 2^(1-mu) (|A| @ |B|); at mu 23 every output within "
            "2e-6 (|A| @ |B|); NaN and Inf where the plain version has them")


def ps_matmul_slack(out, ref, a, b, mu: int) -> Dict:
    """The kernel's ps_matmul against ``slab_sums`` (PS_SLACK): the tensor
    cores sum a slab in another order, which tips an accumulator on a
    PS(mu) midpoint one step apart. Outputs where the plain version is not
    finite must be NaN where it is NaN and the same Inf where it is Inf;
    the slack is taken over the others."""
    fin = torch.isfinite(ref)
    inf = torch.isinf(ref)
    same_nonfinite = torch.equal(torch.isnan(out), torch.isnan(ref)) and \
        torch.equal(out[inf], ref[inf])
    mag = torch.matmul(a.float().abs(), b.float().abs())
    err = torch.where(fin, out - ref, 0.0).abs()
    over = err / torch.where(fin, mag, 1.0).clamp_min(torch.finfo(torch.float32).tiny)
    apart = int(((out != ref) & fin).sum())
    if mu < 23:
        ok = apart <= max(2, out.numel() // 1000) and \
            bool((over <= 2.0 ** (1 - mu)).all())
    else:
        ok = bool((over <= 2e-6).all())
    return {"max_err": err.max().item(), "apart": apart,
            "apart_share": apart / out.numel(),
            "max_err_over_mag": over.max().item(),
            "ok": ok and same_nonfinite}


# ------------------------------------------------------------------ rows

def lamp_attention_row(name, dev, timer, *, shape, seed=0, **kw) -> Dict:
    B, H, T, D = shape
    rng = np.random.default_rng(seed)
    q, k = _t(_rand(rng, shape, 1.5), dev), _t(_rand(rng, shape, 1.5), dev)
    v = _t(_rand(rng, shape), dev)
    (out, cnt), launches = counted(
        "lamp_flash_attention",
        lambda: LA.lamp_flash_attention(q, k, v, reduce=False, **kw))
    ref, cref = LA.lamp_flash_attention_plain(q, k, v, reduce=False, **kw)
    row = {"name": name, "device": dev.type, "shape": list(shape), "args": kw,
           "flops": 4 * B * H * T * T * D}
    row.update(compare_rows(out, cnt, ref, cref),
               nsel=int(cnt.sum()), nsel_ref=int(cref.sum()))
    if timer is None:
        return row
    bk = min(kw["block_k"], T)
    launch, _, _ = LA.prepare_launch(q, k, v, mu=kw["mu"], tau=kw["tau"],
                                     causal=kw["causal"], block_k=bk,
                                     k_subtile=kw["k_subtile"])
    launch23, _, _ = LA.prepare_launch(q, k, v, mu=23, tau=kw["tau"],
                                       causal=kw["causal"], block_k=bk,
                                       k_subtile=kw["k_subtile"])
    pairs = B * H * (T * (T + 1) // 2 if kw["causal"] else T * T)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=kw["causal"])
    row.update(launches=launches, ms=timer.ms(launch), ms_mu23=timer.ms(launch23),
               plain_ms=timer.ms(lambda: LA.lamp_flash_attention_plain(q, k, v, **kw),
                                 reps=5),
               library_ms=timer.ms(sdpa), library_kernel=library_kernels(sdpa),
               library="F.scaled_dot_product_attention(is_causal=True): exact "
                       "attention, which LAMP computes at mu 23",
               **bound(4 * (q.numel() * 2 + k.numel() + v.numel()) + 4,
                       pairs * 4 * D))
    return row


def flash_decode_row(name, dev, timer, *, B, H, D, S, lengths, seed=0,
                     **kw) -> Dict:
    rng = np.random.default_rng(seed)
    q = _t(_rand(rng, (B, H, 1, D), 1.5), dev)
    k = _t(_rand(rng, (B, H, S, D), 1.5), dev)
    v = _t(_rand(rng, (B, H, S, D)), dev)
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    ok = torch.arange(S, device=dev)[None, :] < length.long()[:, None]
    k_in, v_in = k, v
    if dev.type == "cuda":             # keys past the length: never read
        dead = ~ok[:, None, :, None]
        k_in = k.masked_fill(dead, float("nan"))
        v_in = v.masked_fill(dead, float("nan"))
    (out, cnt), launches = counted("flash_decode", lambda: FD.flash_decode(
        q, k_in, v_in, length, reduce=False, **kw))
    ref, cref = FD.flash_decode_plain(q, k, v, length, reduce=False, **kw)
    row = {"name": name, "device": dev.type, "shape": [B, H, S, D],
           "lengths": list(lengths), "args": kw,
           "nan_past_length": dev.type == "cuda"}
    row.update(compare_rows(out, cnt, ref, cref),
               nsel=int(cnt.sum()), nsel_ref=int(cref.sum()))
    if timer is None:
        return row
    launch, _, _ = FD.prepare_launch(q, k_in, v_in, length, mu=kw["mu"],
                                     tau=kw["tau"], k_subtile=kw["k_subtile"])
    launch23, _, _ = FD.prepare_launch(q, k_in, v_in, length, mu=23,
                                       tau=kw["tau"], k_subtile=kw["k_subtile"])
    valid = H * sum(min(max(n, 0), S) for n in lengths)
    mask = ok[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    row.update(launches=launches, ms=timer.ms(launch), ms_mu23=timer.ms(launch23),
               plain_ms=timer.ms(lambda: FD.flash_decode_plain(q, k, v, length, **kw)),
               library_ms=timer.ms(sdpa), library_kernel=library_kernels(sdpa),
               library="F.scaled_dot_product_attention with a length mask: "
                       "exact attention, which LAMP computes at mu 23",
               **bound(4 * (2 * B * H * D + 2 * valid * D) + 4 * B + 4,
                       valid * 4 * D + float(cnt.sum()) * 2 * D))
    return row


def paged_decode_rows(dev, timer, R=8, H=4, Hkv=2, hd=64, bs=16,
                      n_max=16) -> List[Dict]:
    """Gather path against the paged decode kernel over one block arena,
    with the JAX row's inputs (benchmarks/kernels_micro.py draws them with
    numpy too)."""
    rng = np.random.default_rng(0)
    n_blocks = 1 + R * n_max
    arena_k = (rng.normal(size=(n_blocks, bs, Hkv, hd)) * 1.5).astype(np.float32)
    arena_v = rng.normal(size=(n_blocks, bs, Hkv, hd)).astype(np.float32)
    lengths = rng.integers(1, n_max * bs, size=R).astype(np.int32)
    perm = rng.permutation(np.arange(1, n_blocks))
    bt = np.zeros((R, n_max), np.int32)
    for r in range(R):
        nb = -(-int(lengths[r]) // bs)
        bt[r, :nb] = perm[r * n_max:r * n_max + nb]
    q = (rng.normal(size=(R, H, 1, hd)) * 1.5).astype(np.float32)
    site = LampSite(enabled=True, rule="relaxed", mu=7, tau=0.05, granularity=0)
    args = [_t(a, dev) for a in (q, arena_k, arena_v, bt, lengths)]
    ref, nref = PA.paged_decode_attention_plain(*args, site)
    (out, nsel), launches = counted("paged_decode_attention",
                                    lambda: PA.paged_decode_attention(*args, site))
    b_gather, b_fused = PA.decode_kv_bytes(lengths, n_max=n_max, block_size=bs,
                                           bytes_per_token=Hkv * hd * 4, lamp=True)
    err = (out - ref).abs()
    dcnt = (nsel - nref).abs().max().item()
    ok = bool((err <= TOL["atol"] + TOL["rtol"] * ref.abs()).all()) and dcnt <= 1
    gather = {"name": ROW_NAMES[2], "device": dev.type, "bytes_kv": b_gather,
              "nsel": int(nref.sum()), "ok": True}
    fused = {"name": ROW_NAMES[3], "device": dev.type, "bytes_kv": b_fused,
             "nsel": int(nsel.sum()), "nsel_ref": int(nref.sum()),
             "max_err": err.max().item(), "count_diff": dcnt,
             "bytes_saved": 1.0 - b_fused / b_gather, "ok": ok}
    if timer is not None:
        launch, _, _ = PA.prepare_decode_launch(*args, site)
        gather["ms"] = timer.ms(lambda: PA.paged_decode_attention_plain(*args, site))
        fused.update(launches=launches, ms=timer.ms(launch), plain_ms=gather["ms"])
    return [gather, fused]


def ps_matmul_row(name, dev, timer, *, M, K, N, seed=0, **kw) -> Dict:
    rng = np.random.default_rng(seed)
    a, b = _t(_rand(rng, (M, K)), dev), _t(_rand(rng, (K, N)), dev)
    out, launches = counted("ps_matmul", lambda: PM.ps_matmul(a, b, **kw))
    ref = PM.ps_matmul_plain(a, b, **kw)
    row = {"name": name, "device": dev.type, "shape": [M, K, N], "args": kw,
           "flops": 2 * M * N * K, "tolerance": PS_SLACK,
           **ps_matmul_slack(out, ref, a, b, kw["mu"])}
    if timer is None:
        return row
    launch, _ = PM.prepare_launch(a, b, mu=kw["mu"], block_k=kw["block_k"])
    launch23, _ = PM.prepare_launch(a, b, mu=23, block_k=kw["block_k"])
    mm = lambda: torch.matmul(a, b)
    # 3xTF32: three tensor-core products per multiply-add
    row.update(launches=launches, ms=timer.ms(launch), ms_mu23=timer.ms(launch23),
               plain_ms=timer.ms(lambda: PM.ps_matmul_plain(a, b, **kw), reps=5),
               library_ms=timer.ms(mm), library_kernel=library_kernels(mm),
               library="torch.matmul, TF32 off: the same function at mu 23",
               **bound(4 * (M * K + K * N + M * N), 3 * 2 * M * N * K,
                       TF32_FLOP_PER_S))
    return row


def rmsnorm_row(name, dev, timer, *, rows, d, seed=0, eps=1e-6) -> Dict:
    rng = np.random.default_rng(seed)
    x = _t(_rand(rng, (rows, d)), dev).to(torch.bfloat16)
    w = _t(_rand(rng, (d,), 0.1), dev)
    out, launches = counted("rmsnorm", lambda: RN.rmsnorm(x, w, eps=eps))
    ref = RN.rmsnorm_plain(x, w, eps=eps)
    err = (out.float() - ref.float()).abs()
    row = {"name": name, "device": dev.type, "shape": [rows, d],
           "dtype": "bfloat16", "max_err": err.max().item(),
           "ok": bool((err <= RMS_TOL["atol"]
                       + RMS_TOL["rtol"] * ref.float().abs()).all())}
    if timer is None:
        return row
    launch, _ = RN.prepare_launch(x, w, eps=eps)
    w1 = (1.0 + w).to(x.dtype)
    norm = lambda: F.rms_norm(x, (d,), w1, eps)
    row.update(launches=launches, ms=timer.ms(launch),
               plain_ms=timer.ms(lambda: RN.rmsnorm_plain(x, w, eps=eps)),
               library_ms=timer.ms(norm), library_kernel=library_kernels(norm),
               library="F.rms_norm(x, (d,), 1 + w, eps)",
               **bound(rows * d * 2 * 2 + d * 4, rows * d * 4))
    return row


ATTN = dict(mu=7, tau=0.05, k_subtile=32)


def run(device="cuda", full_width: bool = False) -> List[Dict]:
    """Every row (and with `full_width` the four full-width rows), in the
    JAX micro-benchmark's order; on a CUDA device with the device times and
    bounds."""
    dev = resolve_device(device)
    timer = Timer(dev) if dev.type == "cuda" else None
    rows = [
        lamp_attention_row(ROW_NAMES[0], dev, timer, shape=(1, 4, 256, 64),
                           causal=True, block_q=64, block_k=64, **ATTN),
        flash_decode_row(ROW_NAMES[1], dev, timer, B=2, H=4, D=64, S=2048,
                         lengths=[2048, 1948], seed=1, block_k=256, **ATTN),
        *paged_decode_rows(dev, timer),
        ps_matmul_row(ROW_NAMES[4], dev, timer, M=256, K=256, N=256, seed=2,
                      mu=7, block_m=128, block_n=128, block_k=128),
        rmsnorm_row(ROW_NAMES[5], dev, timer, rows=1024, d=512, seed=3),
    ]
    if full_width:
        rows += [
            lamp_attention_row(FULL_WIDTH_NAMES[0], dev, timer,
                               shape=(1, 12, 1024, 64), seed=4, causal=True,
                               block_q=128, block_k=128, **ATTN),
            flash_decode_row(FULL_WIDTH_NAMES[1], dev, timer, B=8, H=12, D=64,
                             S=1024, seed=5,
                             lengths=np.linspace(1, 1024, 8).round().astype(int).tolist(),
                             block_k=512, **ATTN),
            ps_matmul_row(FULL_WIDTH_NAMES[2], dev, timer, M=1024, K=768,
                          N=3072, seed=6, mu=7, block_m=128, block_n=128,
                          block_k=128),
            rmsnorm_row(FULL_WIDTH_NAMES[3], dev, timer, rows=4096, d=3072,
                        seed=7),
        ]
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-width", action="store_true",
                    help="also run each kernel at a model's full width")
    args = ap.parse_args(argv)
    rows = run(args.device, full_width=args.full_width)
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
