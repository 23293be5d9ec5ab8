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
           through the plain versions (EngineConfig.kernel="gather", which
           launches no kernel) must give the same first tokens
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
  obs      phase engine's stream once more with ObsConfig(trace=True), from
           cold step keys: tokens equal to phase engine's, per-layer LAMP
           counters summing to the totals, phase histograms for schedule,
           mixed, sync and emit, compile events keyed by exactly the
           buckets the mixed kernel was called at, the kernel's launches
           grown, a Chrome trace written and read back; the mean us of each
           phase (mixed: the host's enqueueing; sync: the wait for the
           device), then trace on and off alternated, twice each, tokens/s,
           and the phases' means in a fused speculative run (not gated)
  gather   EngineConfig.kernel "cuda" against "gather" on the same requests:
           GPT-2 small (the gather arm is phase engine's) and glm4-9b (the
           dense family) at its published widths cut to 2 layers, bfloat16
           weights, its deployment policy (relaxed rule, granularity 0). In
           the cuda arm every kernel call is held to the plain version on
           the same inputs (outputs within tolerance, counts exact but for
           the strict rule's one a query row); the kernels' launch counters
           grow in the cuda arm and not in the gather arm; every request's
           first token is identical across the arms, and on GPT-2 all its
           greedy tokens; tokens and per-request counts are compared end
           to end and the differences printed; glm4-9b-2l once more with
           its weights cast to FP32 (the same checks)
  faults   the recovery half on GPT-2 small, phase engine's stream: chaos
           with speculation on (fused, draft_len 4, paranoid, all five
           fault sites) must finish every request with phase engine's
           greedy tokens, each site fired, recoveries by action equal to
           the trace's recover:* instants, and the paged kernels' launches
           what the engine's counters predict (the one-row retries
           included); ladder exhaustion (health_max_abs 1e-9, max_retries
           2: on the card GPT-2's ladder is the retry rung alone) fails
           every request alone and recovers none; a 500-step stall is
           cleared by the watchdog; max_queue 2 rejects the third request;
           defrag() every 5 steps; the guard on and off alternated twice
           (tokens gated, tokens/s and the mixed / sync means printed)
  kv_dtype the arena in bfloat16 (EngineConfig.kv_dtype): GPT-2 small's
           stream spec off and on, and glm4-9b-2l (bfloat16 weights,
           relaxed, g 0), every kernel call held to the plain version on
           the same bfloat16 arena (Shadow) and both kernels launched;
           arena bytes and max_memory_allocated of the stream at float32
           and bfloat16, alternated twice (the bytes must halve); both
           kernels at every bucket of phases engine and spec on float32
           and bfloat16 arenas, alternated in turns, the bfloat16 call held
           to its plain version; float16 once a kernel at its most common
           bucket, and bfloat16 with y_low recomputed in pass 2
           (YLOW_KEEP_MAX_BYTES 0), against the plain version
  sampled  threefry on the card: row uniforms at 8 rows x 50257 for each
           salt bit-equal to the CPU's, each of the Gumbel noise's two logs
           within 2 ulp of the CPU's and the noise within the bound that
           carries the inner log's 2 ulp through the outer; the noise's
           time for one sampled step; GPT-2 small's stream sampled
           (temperature 0.8, top-k 50), spec off and on, each run twice
           with identical tokens
  policy   the adaptive policy loop (target rate 0.002, so tau moves) on
           GPT-2 small's stream, then in a 41-block pool that preempts, so
           SHED drops the rule tier strict -> relaxed: every kernel call
           held to the plain version with the layer's live tau (Shadow),
           the relaxed rule served by the kernel, tau moved, every request
           finished
  audit    the shadow audit on GPT-2 small, phase engine's stream: with
           speculation on (fused) and every step audited, tokens must equal
           phase engine's (the audit changes none), every step be audited,
           the kernels' launches be what the counters predict, and the
           lamp_audit_* registry obey the JAX rules (rows <= max_rows x
           steps, flips <= rows, one histogram sample a row, one a
           request), every value finite. The same with fused_step=False:
           tokens, every step audited, the registry rules, and the audited
           logit error and flip rate printed beside the fused run's (the
           JAX burn-in's comparison). One captured audit batch (the
           widest of at most 16 positions) runs through
           transformer.paged_audit_window on the card and on the CPU with
           the same weights and arena: each error metric within its own
           AUDIT_BOUND, flips and top-k overlaps equal but on a row whose
           reference logits hold a near-tie (below FLIP_GAP) at the
           boundary the metric reads. The stream at tau 1e-4 and 0.5: the
           audited logit error must be lower at 1e-4 (printed beside the
           recompute rates: the accuracy-for-recompute trade). With the policy on,
           calibrations > 0 and the policy holding the audit's targets. The
           audit's cost: rates 0, 1 and 0.05 twice in turn, ms per step and
           the audit span's mean (tokens gated at every rate)
  phased   fused_step=False (the phase-segregated plans) against the fused
           step, speculation off and on, under Shadow: greedy tokens equal
           phase engine's, every kernel call held to the plain version, the
           launches what the counters predict (prefill and verify windows
           through the mixed kernel, decode and draft through the decode
           kernel), no mixed step; launches by kind and ms per step printed
           beside the fused run's (nothing claimed)
  moe      the MoE family: qwen3-moe-30b-a3b at its published widths (128
           experts, top 8, bfloat16, router strict g 0) cut to 2 layers.
           Layer 0's moe_apply on the card and on the CPU at an 8 x 128
           and an 8 x 1 bucket: routing, slots and keep mask equal,
           outputs within MOE_REL_L2 / MOE_MAX_ABS_OF_MAX, kept_frac
           printed (the 8 x 1 bucket drops); the engine's stream with
           kernel "cuda" under Shadow against kernel "gather", in bfloat16
           and with the weights cast to FP32: every call held, launches in
           the cuda arm only, the first step's layer-0 MoE inputs (every
           token, padding included) within MOE_INPUT_REL of the gather
           arm's, first tokens equal in FP32 (in bfloat16 the held outputs
           round apart in a few elements and capacity routing passes that
           on: printed with the first steps' routing entries apart, not
           gated), all tokens compared and printed; speculation on (fused,
           draft_len 4) under Shadow: both
           kernels launched as the counters predict, every request
           finished, tokens equal to the spec-off run printed (capacity
           routing depends on the bucket, so not gated); the audit at
           rate 1 on two requests of 4 new tokens: tokens unchanged,
           layer_router_err finite and > 0 in both layers; init seconds,
           parameter bytes, max_memory_allocated and the phase's seconds
  paper    the paper's evaluation path (transformer.forward; plain
           PyTorch, no kernel): stochastic rounding at mu 4 and 7 and
           uniforms, 4 M values each, bit-equal to the CPU's; gpt2-small
           at its published widths (12 layers, d 768, vocab 50257), 2 x
           1024 Markov tokens, seed 0, QK_GAIN 2 on wq / wk: the FP32
           reference, uniform PS(4), LAMP (strict, mu 4, tau 0.1, g 1) and
           the random control, each with KL, flip rate, recompute rate,
           perplexity, ms a forward and max_memory_allocated; gated on
           finite values, uniform's rate 0, 0 < rate < 1 for LAMP and the
           control, LAMP's KL below uniform's, and the control's counts a
           (row, query) equal to the strict rule's on every layer's
           inputs. Cut to 2 layers at 256 tokens, card against CPU: FP32
           logits within PAPER_FP32_REL, LAMP logits within
           PAPER_LOGIT_REL (of the largest) and every PAPER_CONTROLS arm
           beyond it, and on the card's own q, k, v per layer: strict
           counts within 1 a (row, query), relaxed exact, attention_lamp's
           outputs within PAPER_FP32_REL on rows whose counts agree,
           chunked_attention_lamp's two-pass count equal to
           attention_lamp's relaxed one and its one-pass count at least it
  static   the static KV-cache serving loop (runtime.serve_loop.generate
           -> models.api -> each family's prefill / decode_step; plain
           PyTorch, no kernel) at published widths: gpt2-small (12
           layers), llava-next-mistral-7b (2 of 32 layers, 576 image rows),
           hymba-1.5b (2 of 32; window 1024, 128 meta tokens, SSM state
           16), rwkv6-7b (2 of 32) and whisper-medium (2 + 2 of 24 + 24,
           1500 frames), each in its config's dtype and policy, LAMP off
           and on, 4 prompts of 32 tokens and 24 sampled tokens
           (examples/serve_lamp.py's settings): prefill ms, decode tokens/s
           and max_memory_allocated of a run that counts nothing, the
           recompute rate of a second run (counts summed on the card, read
           after it), and prefill + 3 decode steps under torch.profiler
           (device busy, idle share, kernels) printed; gated on
           the tokens' shape and range, finite logits, rates (0 with LAMP
           off and for rwkv6, in (0, 1) for the attention families) and
           the KL of LAMP against off below 0.5. Card against CPU in FP32
           (LAMP off, the same seeded weights): prefill and 4 decode steps
           within STATIC_FP32_REL of the largest logit, a control reading
           above it (the config's bfloat16, or LAMP on for gpt2), the
           card's greedy stream equal to the CPU's but at a near-tie, and
           prefill(S - 1) + decode(1) equal to the forward; hymba once more
           with a 1040-token prompt (the ring full, slot W - 1 written),
           rwkv6 with a 100-token prompt (a padded 64-token chunk); and
           lamp_logits_softmax's mask and rate on the card equal to the
           CPU's and above 0, on that prompt's FP32 forward logits over
           rwkv6's 65,536-word vocabulary, x 4
  train    training (launch.steps.make_train_step: autograd through the
           family's loss with every layer rematerialized, AdamW; plain
           PyTorch, no kernel: every wrapper's launch count must stay
           still). (a) gpt2-small at its published widths and depth, FP32,
           TF32 off: one step on the card against the same step on the
           CPU (same seeded weights, 2 x 128 synthetic tokens): loss,
           grad_norm, the params' update and the gradient of every leaf
           and of every layer's slice (nonzero) within TRAIN_LOSS_RTOL,
           TRAIN_GNORM_RTOL, TRAIN_UPDATE_REL and TRAIN_GRAD_REL; then
           runtime.train_loop.train on the card, 8 x 1024 SyntheticDataset
           tokens for 30 steps with a checkpoint every 10 into a temporary
           directory, resumed to 40: every loss finite, the last 5 steps'
           mean below the first step's by TRAIN_LOSS_DROP, the resumed run
           exactly 10 steps, step 29's checkpoint restored bit for bit; ms
           a step and tokens/s of TRAIN_TIMED_STEPS synchronized steps of
           the step the loop runs (make_sharded_train_step on the one-rank
           mesh, DTensor state), each beside a step of make_train_step on
           whole tensors from the same state and batch (bit for bit the
           same), and max_memory_allocated; the learning gate: LEARN_STEPS steps on a
           64-word Markov stream end below LEARN_LOSS_MAX, and the same
           run with the blocks' gradients dropped (the control) above it.
           (b) qwen3-moe-30b-a3b at its published widths, 2 of 48 layers,
           bfloat16 (router FP32), 2 x 64 tokens, 3 steps: every leaf's
           gradient finite, the router's nonzero on each layer, the step-1
           loss within MOE_TRAIN_LOSS_RTOL and the forward's logits within
           MOE_TRAIN_LOGIT_REL of the FP32 forward of the same weights,
           with the MoE output dropped (controls) beyond them, params
           finite in their dtypes
  distributed
           distribution over torch.distributed (plain PyTorch, no
           kernel: every wrapper's launch count must stay still). (a) A
           one-rank NCCL mesh of this process (launch.mesh.make_host_mesh):
           3 steps of runtime.train_loop.train on gpt2-small at full width
           and depth, 2 x 128 tokens, bit for bit 3 steps of
           make_train_step on the same seed (losses, grad norms, params and
           AdamW state); sp_decode_attention at glm4-9b's published
           attention widths (32 heads on 2 KV heads, hd 128, a bfloat16
           cache of 32,768 positions, 8 rows), LAMP off and on (relaxed,
           mu 7, tau 0.05), card against CPU within DIST_SP_ATOL, the keys
           selected counted on both, ms; moe_apply_ep with all 128 experts
           against moe_apply (dropless) and quantized_psum of a
           gpt2-small-sized tree within half a quantization step. (b)
           DIST_RANKS processes sharing the card over gloo (NCCL refuses
           two ranks on one device), a (1, 4) mesh: sp_decode_attention
           with model 4 (8192 positions a rank) against (a) within
           DIST_SP_SHARD_REL x sum_i p_i |v_i| / l, entry by entry, and
           against the same 4 ranks on the CPU within DIST_SP_ATOL; two
           controls in the same run fail that bound: each rank's slice at
           the next rank's positions (a wrong pos offset), and the last
           rank's slice dropped from the combine; moe_apply_ep at
           qwen3-moe-30b-a3b's widths (128 experts, 32 a rank, top 8,
           bfloat16, router FP32, 8 x 128 tokens) against moe_apply and
           against the same 4 ranks on the CPU within MOE_REL_L2 /
           MOE_MAX_ABS_OF_MAX; quantized_psum of a gpt2-small-sized tree a
           rank, card bit for bit the CPU's. These run all-reduces (SUM,
           MAX) of CUDA tensors, which gloo takes, staging them through the
           host; an exception in any rank fails the phase. Times of (b)
           are host wall times through gloo, not NVLink figures
  dryrun   the dry run (launch.dryrun; a host tool: fake tensors, a fake
           process group, nothing allocated on a card). (a) A subprocess
           (no card visible, started before phase moe so that its host
           work overlaps the card phases) runs run_cell on DRYRUN_CELLS,
           one cell of each kind on the fake (32, 8) / (2, 32, 8) meshes
           of 256 / 512 ranks: each must be ok, and its roofline line is
           printed. (b) DRYRUN_CUT, olmoe-1b-7b at its published widths
           cut to 2 layers at decode_32k's per-rank shape: the subprocess
           counts its serve step on a one-rank fake mesh, and this process
           runs the same step on the card on a one-rank NCCL mesh (random
           bfloat16 weights, half-full cache). Gates: the flops equal
           FlopCounterMode's on the card exactly; peak_bytes_est over
           max_memory_allocated above the baseline before the step's
           arguments were placed inside DRYRUN_MEM_BAND, the estimate
           with the arguments left out outside it; the median of
           DRYRUN_TIMED warm steps (CUDA events) no shorter than the floor
           max(flops over the peak of their type, the multiplied
           arguments' bytes over HBM_BW); the kernels' launch counters
           unchanged. Printed: the step over its floor and over the
           roofline's largest term
  tp       the tensor-parallel steps of the transformer families
           (launch.steps.make_sharded_*_step: FSDP over data x tensor
           parallelism over model; plain PyTorch, no kernel: every
           wrapper's launch count must stay still) on TP_RANKS processes
           sharing the card over gloo, mesh TP_MESH (data 2, model 2),
           glm4-9b at its published widths cut to TP_LAYERS layers (its
           heads and vocabulary split whole; its gated MLP's gate and up
           columns lie in different ranks' shards, so wi is gathered over
           model a layer at a time). (a) FP32, against the plain steps of
           this process on the same seeded weights: one train step's loss
           and grad_norm within TP_LOSS_RTOL; each leaf's clipped
           gradient (AdamW's first m over 1 - b1) within TP_GRAD_REL in
           relative L2, the control (the one-rank step on half the
           batch, one data rank's rows) outside it for every leaf; the new
           params within TP_PARAM_ATOL of the one-rank step's once each
           side's own gradient is taken through AdamW's first step, and
           all within TP_PARAM_MAX_LR x lr (those beyond TP_PARAM_ATOL
           printed with the |g| they have); prefill and TP_NEW greedy
           decode steps, tokens equal (logits printed). (b) bfloat16: each rank's
           max_memory_allocated over one train step, above its baseline
           before the arguments, within TP_MEM_BAND of op_cost's
           peak_bytes_est for the same step on a fake TP_MESH group
           (counted by phase dryrun's worker), and below the
           data-parallel step's floor (the same arguments plus the whole
           model's params and gradients, printed). (c) The 4-rank step's
           time and the one-rank step's: gloo stages its collectives
           through the host, so these are not NVLink times. An exception
           in any rank fails the phase

The loud rule holds for every engine run of every phase but the ladder
exhaustion run: no recovery through the gather or FP32 rung (they run the
plain versions instead of the kernels; the "cuda" path's ladder on the
card has neither, a "gather" path engine's has the FP32 rung) and no
failed request, so a kernel that returns non-finite logits fails this
script instead of being recovered. Last comes the line {"ok": true, "device": {...}}. Weights are
random, drawn from a seed.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
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
# kernel and in one pass by the plain version: 1. Everything else is exact:
# the plain version sums y_low and the FP32 logits in the kernel's order.
COUNT_SLACK = {"strict-g1": 1}


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
    kernel = PA.paged_mixed_attention
    PA.paged_mixed_attention = PA.paged_mixed_attention_plain
    try:
        return fn()
    finally:
        PA.paged_mixed_attention = kernel


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


def recoveries_by_action(eng):
    fam = eng.obs.registry.get("engine_recoveries_total")
    return {key[0]: int(c.value) for key, c in fam.items() if c.value}


def check_loud(eng, what):
    """The loud rule: a recovery through a rung that runs the plain
    versions in place of the kernels (gather, FP32), or a request that
    failed alone, would hide a kernel fault: it fails the run."""
    by_action = recoveries_by_action(eng)
    hidden = {a: by_action.get(a, 0) for a in ("gather", "fp32")}
    failed = eng.stats()["failed_requests"]
    require(not any(hidden.values()) and failed == 0,
            f"{what}: recoveries through the plain versions {hidden}, "
            f"failed requests {failed}")


def make_engine(params, cfg, requests=True, **options):
    """The engine of every run (phase engine's settings), with its 8 greedy
    requests added unless `requests` is False."""
    from repro_torch.serving import EngineConfig, LampEngine, SamplingParams
    settings = dict(block_size=BS, max_model_len=320, n_blocks=8 * 20 + 1,
                    max_prefill_tokens=128, device=DEVICE)
    eng = LampEngine(cfg, params, EngineConfig(**{**settings, **options}))
    if requests:
        for i, prompt in enumerate(engine_requests(cfg)):
            eng.add_request(prompt, SamplingParams(max_new_tokens=32, seed=i))
    return eng


def run_engine(params, cfg, loud=True, setup=None, **options):
    """Serve the stream; returns (engine, outputs, wall seconds). Each
    step's wall time is kept on `engine.step_ms` under its kind: whether it
    ran a speculative round ("spec") or not ("plain"), with prefill rows
    ("+prefill") or without. `setup(engine)` runs before the first step.
    Applies the loud rule unless `loud` is False (the ladder exhaustion run
    only)."""
    eng = make_engine(params, cfg, **options)
    if setup is not None:
        setup(eng)
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
    wall = time.perf_counter() - t0
    if loud:
        check_loud(eng, f"engine run {options}")
    return eng, outs, wall


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
    # the same stream through the plain versions on the card (the knob)
    PA._wrapper.launches = PA._decode_wrapper.launches = 0
    peng, pouts, pwall = run_engine(params, cfg, kernel="gather")
    gather_launches = PA._wrapper.launches + PA._decode_wrapper.launches
    kt = {o.req_id: o.tokens for o in outs}
    pt = {o.req_id: o.tokens for o in pouts}
    first_same = all(kt[r][0] == pt[r][0] for r in kt)
    same = sum(a == b for r in kt for a, b in zip(kt[r], pt[r]))
    ok = (len(outs) == 8 and gen_ok and launches == expected and launches > 0
          and first_same and peng.mixed_steps > 0 and gather_launches == 0
          and s["prefill_chunks"] > 0 and s["cached_tokens"] > 0)
    emit("engine", requests=len(outs), steps=eng.mixed_steps,
         wall_s=wall, ms_per_step=1e3 * wall / eng.mixed_steps,
         generated_tokens=eng.generated_tokens,
         tokens_per_s=eng.generated_tokens / wall,
         lamp_recompute_rate=s["lamp_recompute_rate"],
         prefix_hit_rate=s["cache_hit_rate"], cached_tokens=s["cached_tokens"],
         prefill_chunks=s["prefill_chunks"], preemptions=s["preemptions"],
         kernel_launches=launches, expected_launches=expected,
         gather_arm_kernel_launches=gather_launches,
         buckets=rec.buckets("mixed", "engine"),
         step_ms=step_breakdown(eng),
         plain_wall_s=pwall, plain_ms_per_step=1e3 * pwall / peng.mixed_steps,
         first_tokens_equal_plain=first_same,
         tokens_equal_plain=f"{same}/{sum(len(t) for t in kt.values())}",
         note="timed with a recording wrapper that copies the inputs of "
              "each bucket's first call", ok=ok)
    require(ok, "engine run failed its checks")
    return launches, kt, (peng, pouts, {"any": gather_launches})


def top2_gap(params, cfg, prompt, toks, pos, k=1):
    """The gap between the k-th and (k+1)-th largest logits (k=1: the top
    two) after prompt + toks[:pos], from one prefill window on a fresh
    arena: how close the reference's greedy choice (its top-k set) at that
    position was to a tie."""
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
    top = torch.topk(logits[0, -1], k + 1).values
    return float(top[k - 1] - top[k])


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


def device_rows(prof):
    """(kernel name, device ms, calls) of a torch.profiler run, the
    longest first."""
    from torch.autograd import DeviceType
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
    return rows


def phase_profile(params, cfg, unprofiled_wall):
    """The fused speculative run once more under torch.profiler: the
    kernels' summed device time against the run's wall time (device busy
    and idle share), and the kernels that take most of it. The profiler
    slows the host, so the idle share is given against both the profiled
    wall time and the unprofiled run's."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import paged_attention as PA
    saved = PA._wrapper.launches, PA._decode_wrapper.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng, _, wall = run_engine(params, cfg, speculative=True,
                                  draft_len=SPEC_DRAFT_LEN)
    PA._wrapper.launches, PA._decode_wrapper.launches = saved
    rows = device_rows(prof)
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
    kv = ak.element_size()                  # the arena's bytes an element
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
              + live_kv_positions(bt, spans, bs) * Hkv * hd * kv * 2  # K, V
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
    kv = ak.element_size()
    bt, lengths = bt.cpu(), lengths.cpu()
    spans, pairs = [], 0
    for r in range(R):
        L = int(lengths[r])
        spans.append((0 if window is None else max(L - window, 0), L - 1))
        pairs += L if window is None else min(L, window)
    nbytes = (R * Hq * hd * 4 * 2                            # q in, out
              + live_kv_positions(bt, spans, bs) * Hkv * hd * kv * 2  # K, V
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
    slack = 1 if site.enabled and site.rule == "strict" else 0
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


def phase_obs(params, cfg, ref_tokens):
    """Phase engine's stream with tracing on, from cold step keys (so every
    bucket logs its compile event); then trace on and off alternated."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import transformer as TT
    from repro_torch.obs import ObsConfig
    from repro_torch.serving.engine import reset_step_caches

    reset_step_caches()
    rec = Recorder()
    rec.run = "obs"
    with rec:
        PA._wrapper.launches = 0
        eng, outs, wall = run_engine(params, cfg, obs=ObsConfig(trace=True))
        launches = PA._wrapper.launches
    L = cfg.n_layers
    s = eng.stats()
    toks = {o.req_id: o.tokens for o in outs}
    fam = eng.obs.registry.get("lamp_kq_products_total")
    by_layer = [(fam.labels(str(l), "selected").value,
                 fam.labels(str(l), "valid").value) for l in range(L)]
    sums_ok = (all(sum(o.lamp_layer_selected) == o.lamp_selected and
                   sum(o.lamp_layer_valid) == o.lamp_valid for o in outs)
               and [b[0] for b in by_layer] == list(eng._layer_sel)
               and [b[1] for b in by_layer] == list(eng._layer_val)
               and sum(b[0] for b in by_layer) == eng.agg_lamp_selected > 0)
    phases = {n: eng.obs.phase_hist(n).count
              for n in ("schedule", "alloc", "mixed", "sync", "emit")}
    compiled = [(e["kind"], tuple(e["shape"])) for e in eng.compile_events]
    called = {(a, b) for (k, a, b), c in rec.calls.items()
              if k == "mixed" and c["obs"]}
    site = TT._kq_site(cfg, True)
    expected = eng.mixed_steps * L * PA.passes(site)
    with tempfile.TemporaryDirectory() as d:
        doc = json.load(open(eng.write_trace(os.path.join(d, "trace.json"))))
    spans = collections.Counter(e["name"] for e in doc["traceEvents"]
                                if e["ph"] == "X")
    # the tracer's cost: trace on and off alternated, each run's tokens/s
    alternated = []
    for _ in range(2):
        for trace in (True, False):
            e2, o2, w2 = run_engine(params, cfg, obs=ObsConfig(trace=trace))
            alternated.append({"trace": trace,
                               "tokens_per_s": e2.generated_tokens / w2,
                               "tokens_equal": {o.req_id: o.tokens for o in o2}
                               == ref_tokens})
    # where a speculative round's time goes, by the same spans
    e3, _, w3 = run_engine(params, cfg, speculative=True,
                           draft_len=SPEC_DRAFT_LEN)
    spec_phases = {n: {"mean_us": p["mean_us"], "count": p["count"]}
                   for n, p in e3.stats()["phase"].items()}
    checks = {
        "tokens_equal_phase_engine": toks == ref_tokens,
        "layer_counters_sum_to_totals": sums_ok,
        "phase_histograms": (min(phases[n] for n in ("schedule", "mixed",
                                                     "sync", "emit")) > 0
                             and phases["mixed"] == phases["sync"]
                             == eng.mixed_steps),
        "compile_keys_equal_buckets": (len(set(compiled)) == len(compiled)
                                       and {k for k, _ in compiled} == {"mixed"}
                                       and {b for _, b in compiled} == called),
        "kernel_launches": launches == expected > 0,
        "trace_written": spans["mixed"] == eng.mixed_steps and spans["sync"] > 0,
        "alternated_tokens_equal": all(a["tokens_equal"] for a in alternated),
    }
    mean_us = {n: round(p["mean_us"], 1) for n, p in s["phase"].items()}
    print("obs phase mean us (mixed: host enqueue; sync: device wait): "
          + " ".join(f"{n}={mean_us[n]}" for n in sorted(mean_us)), flush=True)
    emit("obs", steps=eng.mixed_steps, wall_s=wall,
         tokens_per_s=eng.generated_tokens / wall, phases=s["phase"],
         compiles=s["compiles"], compile_time_s=s["compile_time_s"],
         compile_events=[{"kind": k, "shape": list(b), "wall_ms": 1e3 * e["wall_s"]}
                         for (k, b), e in zip(compiled, eng.compile_events)],
         recorder_buckets=sorted(f"{a}x{b}" for a, b in called),
         kernel_launches=launches, expected_launches=expected,
         trace_events=len(doc["traceEvents"]), trace_spans=dict(spans),
         trace_on_off_tokens_per_s=alternated,
         spec_fused_phases=spec_phases, spec_fused_steps=e3.mixed_steps,
         spec_fused_tokens_per_s=e3.generated_tokens / w3, checks=checks,
         ok=all(checks.values()))
    require(all(checks.values()), f"obs phase failed its checks: {checks}")


def dense_2_layers():
    """glm4-9b at its published widths (d 4096, 32 heads on 2 KV heads, hd
    128, FFN 13696, vocab 151552, bfloat16, the deployment policy) with its
    40 layers cut to 2."""
    from repro_torch.configs import get_config
    return get_config("glm4-9b").replace(n_layers=2, name="glm4-9b-2l")


class Shadow:
    """Wraps both paged wrappers for an engine run: every kernel call is
    followed by the plain version on the same inputs (the arena is not
    written between the two), held to the kernel's tolerances: outputs
    within TOL on live queries, counts exact but for the strict rule's one
    a query row. The plain calls launch no kernel."""

    def __init__(self):
        self.calls = self.apart = self.slack_used = 0
        self.max_err = self.max_count_diff = 0.0
        self.rules = collections.Counter()      # calls by the site's rule

    def __enter__(self):
        from repro_torch.kernels import paged_attention as PA
        self.mixed, self.decode = PA.paged_mixed_attention, PA.paged_decode_attention

        def mixed(q, ak, av, bt, starts, qlens, site, *, tau=None, window=None):
            out, nsel = self.mixed(q, ak, av, bt, starts, qlens, site, tau=tau,
                                   window=window)
            ref, nref = PA.paged_mixed_attention_plain(
                q, ak, av, bt, starts, qlens, site, tau=tau, window=window)
            self.note(compare(out, nsel, ref, nref, qlens, self.slack(site)))
            self.rules[site.rule if site.enabled else "off"] += 1
            return out, nsel

        def decode(q, ak, av, bt, lengths, site, *, tau=None, window=None):
            out, nsel = self.decode(q, ak, av, bt, lengths, site, tau=tau,
                                    window=window)
            ref, nref = PA.paged_decode_attention_plain(
                q, ak, av, bt, lengths, site, tau=tau, window=window)
            self.note(compare_rows(out, nsel, ref, nref, self.slack(site)))
            self.rules[site.rule if site.enabled else "off"] += 1
            return out, nsel

        PA.paged_mixed_attention, PA.paged_decode_attention = mixed, decode
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import paged_attention as PA
        PA.paged_mixed_attention, PA.paged_decode_attention = self.mixed, self.decode

    @staticmethod
    def slack(site) -> int:
        return 1 if site.enabled and site.rule == "strict" else 0

    def note(self, result):
        err, dcnt, ok = result
        self.calls += 1
        self.apart += not ok
        self.slack_used += dcnt > 0
        self.max_err = max(self.max_err, err)
        self.max_count_diff = max(self.max_count_diff, dcnt)


def phase_gather(params, cfg, gather_arm):
    """kernel="cuda" against kernel="gather" on the engine's stream: GPT-2
    small (its gather arm is phase engine's), then the dense family at
    published widths, 2 layers. The cuda arm runs under `Shadow`: every
    kernel call against the plain version on the same inputs (the exact
    check). End to end the arms' inputs drift apart: the attention outputs
    agree to rtol 2e-5, not in every bit, and later layers carry that into
    other PS(mu) roundings (and, in bfloat16, other bfloat16 roundings),
    so all tokens are held identical on GPT-2 only, every request's first
    token everywhere, and the per-request count differences are measured;
    glm4-9b-2l runs again with its weights in FP32, to tell the bfloat16
    drift apart."""
    from repro_torch.core import tree as T
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import transformer as TT
    ok_all = True
    dcfg = dense_2_layers()
    t0 = time.perf_counter()
    dparams = TT.init_params(dcfg, 0, device=DEVICE)
    init_s = time.perf_counter() - t0
    # the same weights in FP32: whether the bfloat16 run's drift is the
    # bfloat16 rounding of the hidden state (printed, not gated)
    fcfg = dcfg.replace(dtype="float32", name="glm4-9b-2l-fp32")
    fparams = T.map(lambda t: t.float(), dparams)
    for c, p, gather in ((cfg, params, gather_arm), (dcfg, dparams, None),
                         (fcfg, fparams, None)):
        shadow = Shadow()
        with shadow:
            PA._wrapper.launches = PA._decode_wrapper.launches = 0
            eng, outs, wall = run_engine(p, c)
            cl = {"mixed": PA._wrapper.launches,
                  "decode": PA._decode_wrapper.launches}
        if gather is None:
            PA._wrapper.launches = PA._decode_wrapper.launches = 0
            geng, gouts, gwall = run_engine(p, c, kernel="gather")
            gather = (geng, gouts, {"mixed": PA._wrapper.launches,
                                    "decode": PA._decode_wrapper.launches})
        geng, gouts, gl = gather
        co = {o.req_id: o for o in outs}
        go = {o.req_id: o for o in gouts}
        site = TT._kq_site(c, True)
        same = sum(a == b for r in co for a, b in zip(co[r].tokens,
                                                      go.get(r, co[r]).tokens))
        diff = [abs(co[r].lamp_selected - go[r].lamp_selected) / co[r].lamp_valid
                for r in co if r in go]
        checks = {
            "requests": len(co) == len(go) == 8,
            "every_call_held_to_plain": shadow.apart == 0 and shadow.calls
            == sum(cl.values()) // PA.passes(site) > 0,
            "cuda_arm_launches": cl["mixed"] == eng.mixed_steps * c.n_layers
            * PA.passes(site) > 0,
            "gather_arm_no_launches": sum(gl.values()) == 0,
        }
        checks["first_tokens_identical"] = all(
            co[r].tokens[:1] == go[r].tokens[:1] for r in co if r in go)
        if c is cfg:
            checks["tokens_identical"] = same == sum(len(o.tokens) for o in outs)
        ok_all = ok_all and all(checks.values())
        emit("gather", config=c.name, n_layers=c.n_layers, d_model=c.d_model,
             n_heads=c.n_heads, n_kv_heads=c.n_kv_heads, hd=c.hd, vocab=c.vocab,
             dtype=c.dtype, rule=site.rule, granularity=site.granularity,
             mu=site.mu, steps=eng.mixed_steps,
             shadow={"calls": shadow.calls, "apart": shadow.apart,
                     "max_abs_err": shadow.max_err,
                     "max_count_diff": shadow.max_count_diff,
                     "calls_using_slack": shadow.slack_used,
                     "count_slack": Shadow.slack(site)},
             tokens_equal=f"{same}/{sum(len(o.tokens) for o in outs)}",
             max_request_count_diff_share=max(diff) if diff else None,
             selected_cuda=sum(o.lamp_selected for o in outs),
             selected_gather=sum(o.lamp_selected for o in gouts),
             valid=sum(o.lamp_valid for o in outs),
             cuda_launches=cl, gather_launches=gl, cuda_wall_s=wall,
             params_init_s=init_s if c is dcfg else None,
             checks=checks, ok=all(checks.values()))
    require(ok_all, "kernel and gather engine runs disagree")
    return dcfg, dparams


# chaos on the speculative fused run: every site at a rate that fires in
# its first 14 steps for this salt (fault_hash is a pure function of (step,
# site, salt)); draft faults need drafting rows, which come once the
# prompts are in (steps 8-13: draft fires at 10, 12, 13)
CHAOS = dict(enabled=True, salt=6, nan_rate=0.3, draft_rate=0.3,
             step_rate=0.2, alloc_rate=0.1, stall_rate=0.05, stall_steps=2,
             stall_s=0.0)


def phase_faults(params, cfg, ref_tokens):
    """The recovery half on GPT-2 small (module docstring)."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import transformer as TT
    from repro_torch.obs import ObsConfig
    from repro_torch.serving import FaultConfig, QueueFullError, SamplingParams
    from repro_torch.serving.faults import FAULT_SITES
    from repro_torch.serving.speculative import draft_model_config
    t0 = time.perf_counter()
    checks = {}
    L = cfg.n_layers

    def tokens(outs):
        return {o.req_id: o.tokens for o in outs}

    # chaos, speculation on, fused
    PA._wrapper.launches = PA._decode_wrapper.launches = 0
    eng, outs, wall = run_engine(
        params, cfg, speculative=True, draft_len=SPEC_DRAFT_LEN,
        paranoid=True, faults=FaultConfig(**CHAOS), stall_patience=8,
        obs=ObsConfig(trace=True))
    mix_l, dec_l = PA._wrapper.launches, PA._decode_wrapper.launches
    lc = eng.launch_counts
    site, dsite = TT._kq_site(cfg, True), TT._kq_site(draft_model_config(cfg), True)
    exp_dec = (lc["draft"] * SPEC_DRAFT_LEN * L * PA.passes(dsite)
               + lc["decode"] * L * PA.passes(site))
    exp_mix = (lc["mixed"] + lc["prefill"] + lc["verify"]) * L * PA.passes(site)
    st = eng.stats()
    by_site = st["faults"]["by_site"]
    by_action = recoveries_by_action(eng)
    instants = collections.Counter(
        name.split(":", 1)[1] for _, name, *_ in eng.obs.tracer.events()
        if name.startswith("recover:"))
    eng.pool.check_invariants(eng._seqs.values())
    checks["chaos_finished_clean"] = (len(outs) == 8 and all(
        o.error is None for o in outs))
    checks["chaos_tokens_equal_phase_engine"] = tokens(outs) == ref_tokens
    checks["chaos_every_site_fired"] = all(by_site[s] > 0 for s in FAULT_SITES)
    checks["chaos_recoveries_equal_trace"] = by_action == dict(instants)
    checks["chaos_launches_predicted"] = (mix_l == exp_mix > 0
                                          and dec_l == exp_dec > 0)
    chaos = {"steps": eng.mixed_steps, "launches_by_fn": lc,
             "mixed_kernel_launches": mix_l, "expected_mixed": exp_mix,
             "decode_kernel_launches": dec_l, "expected_decode": exp_dec,
             "by_site": by_site, "recoveries": by_action,
             "failed_requests": st["failed_requests"],
             "tokens_per_s": eng.generated_tokens / wall}

    # ladder exhaustion: every rung unhealthy under the 1e-9 bound, every
    # request fails alone; on the card the "cuda" path's ladder ends
    # before the plain-version rungs (GPT-2's site is strict: retry alone)
    eng, outs, _ = run_engine(params, cfg, loud=False, health_max_abs=1e-9,
                              max_retries=2)
    eng.pool.check_invariants(eng._seqs.values())
    ladder = "/".join(a for a, *_ in eng._retry_ladder())
    checks["exhaustion_ladder_on_the_kernels"] = all(
        r[3] == "cuda" for r in eng._retry_ladder())
    checks["exhaustion_fails_alone"] = (
        len(outs) == 8 and not eng.has_unfinished()
        and all(o.finish_reason == "unhealthy" and f"[{ladder}]" in o.error
                for o in outs)
        and eng.stats()["failed_requests"] == 8 and not recoveries_by_action(eng))
    exhaustion = {"ladder": ladder, "failed": eng.stats()["failed_requests"],
                  "retry_launches": eng.launch_counts["prefill"]}

    # the watchdog clears a 500-step stall
    eng = make_engine(params, cfg, stall_patience=4, faults=FaultConfig(
        enabled=True, salt=1, stall_rate=1.0, max_faults=1, stall_steps=500,
        stall_s=0.0))
    outs = eng.run_to_completion()
    check_loud(eng, "watchdog run")
    checks["watchdog_clears_stall"] = (
        tokens(outs) == ref_tokens
        and recoveries_by_action(eng) == {"stall_clear": 1}
        and eng.stats()["faults"]["by_site"]["stall"] == 1)

    # admission bound
    eng = make_engine(params, cfg, requests=False, max_queue=2)
    prompts = engine_requests(cfg)
    for i in range(2):
        eng.add_request(prompts[i], SamplingParams(max_new_tokens=32, seed=i))
    try:
        eng.add_request(prompts[2], SamplingParams(max_new_tokens=32, seed=2))
        rejected = False
    except QueueFullError:
        rejected = True
    outs = eng.run_to_completion()
    check_loud(eng, "admission run")
    checks["admission_rejects_third"] = (
        rejected and tokens(outs) == {i: ref_tokens[i] for i in range(2)})

    # defrag every 5 steps
    eng = make_engine(params, cfg)
    outs, n, moved = [], 0, 0
    while eng.has_unfinished():
        outs.extend(eng.step())
        n += 1
        if n % 5 == 0:
            before = [list(q.block_ids) for q in eng.scheduler.running]
            eng.defrag()
            moved += sum(a != list(q.block_ids) for a, q in
                         zip(before, eng.scheduler.running))
    check_loud(eng, "defrag run")
    eng.pool.check_invariants(eng._seqs.values())
    checks["defrag_tokens_unchanged"] = tokens(outs) == ref_tokens

    # the guard's cost, on and off alternated twice (tokens gated)
    guard = []
    for _ in range(2):
        for on in (True, False):
            e2, o2, w2 = run_engine(params, cfg, health_guard=on)
            ph = e2.stats()["phase"]
            guard.append({"health_guard": on,
                          "tokens_per_s": e2.generated_tokens / w2,
                          "mixed_mean_us": ph["mixed"]["mean_us"],
                          "sync_mean_us": ph["sync"]["mean_us"],
                          "tokens_equal": tokens(o2) == ref_tokens})
    checks["guard_on_off_tokens_equal"] = all(g["tokens_equal"] for g in guard)
    seconds = time.perf_counter() - t0
    print("faults by_site " + json.dumps(by_site) + " recoveries "
          + json.dumps(chaos["recoveries"])
          + f" failed_requests {chaos['failed_requests']}"
          + f" (exhaustion run: {exhaustion['failed']}) seconds {seconds:.2f}",
          flush=True)
    emit("faults", chaos=chaos, exhaustion=exhaustion,
         defrag={"calls": n // 5, "tables_moved": moved},
         guard_on_off=guard, seconds=seconds, checks=checks,
         ok=all(checks.values()))
    require(all(checks.values()), f"faults phase failed its checks: {checks}")


def shadow_run(params, cfg, **options):
    """run_engine under `Shadow` with both launch counters set to 0 just
    before: (engine, outputs, wall, shadow, {"mixed": n, "decode": n})."""
    from repro_torch.kernels import paged_attention as PA
    shadow = Shadow()
    with shadow:
        PA._wrapper.launches = PA._decode_wrapper.launches = 0
        eng, outs, wall = run_engine(params, cfg, **options)
        launches = {"mixed": PA._wrapper.launches,
                    "decode": PA._decode_wrapper.launches}
    return eng, outs, wall, shadow, launches


def shadow_line(shadow):
    return {"calls": shadow.calls, "apart": shadow.apart,
            "max_abs_err": shadow.max_err,
            "max_count_diff": shadow.max_count_diff,
            "calls_using_slack": shadow.slack_used,
            "rules": dict(shadow.rules)}


def arena_bytes(eng):
    return 2 * eng.pool.k.nelement() * eng.pool.k.element_size()


def peak_memory(params, cfg, **options):
    """max_memory_allocated over one engine run (the weights included),
    after the caching allocator let go of what earlier runs left."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng, _, wall = run_engine(params, cfg, **options)
    return {"kv_dtype": options.get("kv_dtype", "float32"),
            "arena_bytes": arena_bytes(eng),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "tokens_per_s": eng.generated_tokens / wall}


def narrow(args, dtype):
    """A bucket's captured inputs with its arena (K, V) cast to `dtype`."""
    return [args[0], args[1].to(dtype), args[2].to(dtype)] + list(args[3:])


def phase_kv_dtype(params, cfg, ref_tokens, rec, dense):
    """The bfloat16 arena on the main path (module docstring)."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import transformer as TT
    t0 = time.perf_counter()
    checks = {}
    runs = {}
    for name, c, p, opts in (
            ("gpt2_spec_off", cfg, params, {}),
            ("gpt2_spec_on", cfg, params,
             dict(speculative=True, draft_len=SPEC_DRAFT_LEN)),
            ("glm4-9b-2l", dense[0], dense[1], {})):
        eng, outs, wall, shadow, cl = shadow_run(p, c, kv_dtype="bfloat16",
                                                 **opts)
        site = TT._kq_site(c, True)
        toks = {o.req_id: o.tokens for o in outs}
        line = {"config": c.name, "rule": site.rule,
                "granularity": site.granularity,
                "arena_dtype": str(eng.pool.k.dtype),
                "arena_bytes": arena_bytes(eng), "steps": eng.mixed_steps,
                "launches": cl, "shadow": shadow_line(shadow),
                "tokens_per_s": eng.generated_tokens / wall,
                "lamp_recompute_rate": eng.stats()["lamp_recompute_rate"]}
        if c is cfg:
            line["tokens_equal_float32_arena"] = (
                f"{sum(a == b for r in toks for a, b in zip(toks[r], ref_tokens[r]))}"
                f"/{sum(len(t) for t in toks.values())}")
        runs[name] = line
        checks[f"{name}_every_call_held"] = (
            shadow.apart == 0 and shadow.calls > 0 and len(outs) == 8
            and shadow.calls == sum(cl.values()) // PA.passes(site)
            if not opts else shadow.apart == 0 and shadow.calls > 0
            and len(outs) == 8)
        checks[f"{name}_launched"] = cl["mixed"] > 0 and (
            cl["decode"] > 0 if opts else True)
        checks[f"{name}_arena_bfloat16"] = eng.pool.k.dtype == torch.bfloat16
    # the arena's bytes and the run's peak memory, float32 against bfloat16
    memory = [peak_memory(params, cfg, kv_dtype=d)
              for d in ("float32", "bfloat16", "float32", "bfloat16")]
    checks["arena_bytes_halve"] = all(
        2 * m["arena_bytes"] == memory[0]["arena_bytes"] for m in memory[1::2])
    # both kernels at every bucket of the engine runs, float32 and bfloat16
    # arenas alternated; each bfloat16 call held to its plain version
    buckets = []
    for key in sorted(rec.captured, key=str):
        kind, rows, w = key
        args, site, tau, window = rec.captured[key]
        slack = 1 if site.enabled and site.rule == "strict" else 0
        prepare = PA.prepare_launch if kind == "mixed" else PA.prepare_decode_launch
        plain = (PA.paged_mixed_attention_plain if kind == "mixed"
                 else PA.paged_decode_attention_plain)
        counter = PA._wrapper if kind == "mixed" else PA._decode_wrapper
        before = counter.launches
        nargs = narrow(args, torch.bfloat16)
        launch16, out, nsel = prepare(*nargs, site, tau, window)
        launch16()
        ref, nref = plain(*nargs, site, tau=tau, window=window)
        torch.cuda.synchronize()
        if kind == "mixed":
            err, dcnt, ok = compare(out, nsel.sum(dim=1), ref, nref, args[5], slack)
            b32 = bound_at(args, site, None, nref, window)
            b16 = bound_at(nargs, site, None, nref, window)
        else:
            err, dcnt, ok = compare_rows(out, nsel.sum(dim=1), ref, nref, slack)
            b32 = decode_bound_at(args, site, nref, window)
            b16 = decode_bound_at(nargs, site, nref, window)
        launch32, _, _ = prepare(*args, site, tau, window)
        ms = {"float32": [], "bfloat16": []}
        for _ in range(2):
            ms["float32"].append(time_device(launch32))
            ms["bfloat16"].append(time_device(launch16))
        counter.launches = before
        line = {"kernel": f"paged_{kind}_attention", "bucket": f"{rows}x{w}",
                "rule": site.rule if site.enabled else "off",
                "calls": sum(rec.calls[key].values()),
                "ms_float32": statistics.median(ms["float32"]),
                "ms_bfloat16": statistics.median(ms["bfloat16"]),
                "ms_runs": ms, "bound_ms_float32": b32[0],
                "bound_ms_bfloat16": b16[0], "bytes_float32": b32[2],
                "bytes_bfloat16": b16[2], "bfloat16_max_abs_err": err,
                "bfloat16_max_count_diff": dcnt, "ok": ok}
        buckets.append(line)
        emit("kv_dtype_bucket", **line)
    checks["buckets_bfloat16_held"] = all(b["ok"] for b in buckets) and \
        len(buckets) == len(rec.captured)
    # float16 once a kernel at the most common bucket of each, and
    # bfloat16 through pass 2's recompute of y_low (nothing kept)
    f16 = {}
    keep = PA.YLOW_KEEP_MAX_BYTES
    for kind, dtype, keep_max in (("mixed", torch.float16, keep),
                                  ("decode", torch.float16, keep),
                                  ("mixed", torch.bfloat16, 0)):
        PA.YLOW_KEEP_MAX_BYTES = keep_max
        key = max((k for k in rec.captured if k[0] == kind),
                  key=lambda k: sum(rec.calls[k].values()))
        args, site, tau, window = rec.captured[key]
        nargs = narrow(args, dtype)
        counter = PA._wrapper if kind == "mixed" else PA._decode_wrapper
        before = counter.launches
        slack = 1 if site.enabled and site.rule == "strict" else 0
        if kind == "mixed":
            out, nsel = PA.paged_mixed_attention(*nargs, site, tau=tau,
                                                 window=window)
            ref, nref = PA.paged_mixed_attention_plain(*nargs, site, tau=tau,
                                                       window=window)
            res = compare(out, nsel, ref, nref, args[5], slack)
        else:
            out, nsel = PA.paged_decode_attention(*nargs, site, tau=tau,
                                                  window=window)
            ref, nref = PA.paged_decode_attention_plain(*nargs, site, tau=tau,
                                                        window=window)
            res = compare_rows(out, nsel, ref, nref, slack)
        f16[f"{kind} {dtype} keep<={keep_max}"] = {
            "bucket": f"{key[1]}x{key[2]}", "launches":
            counter.launches - before, "max_abs_err": res[0],
            "max_count_diff": res[1], "ok": res[2]}
        counter.launches = before
    PA.YLOW_KEEP_MAX_BYTES = keep
    checks["float16_and_recompute_held"] = all(
        v["ok"] and v["launches"] > 0 for v in f16.values())
    calls = lambda b: b["calls"]
    summed = {d: sum(calls(b) * b[f"ms_{d}"] for b in buckets)
              for d in ("float32", "bfloat16")}
    seconds = time.perf_counter() - t0
    print("kv_dtype calls x ms over the engine buckets: float32 "
          f"{summed['float32']:.3f} bfloat16 {summed['bfloat16']:.3f}; arena "
          f"bytes {memory[0]['arena_bytes']} -> {memory[1]['arena_bytes']}; "
          f"peak memory {memory[0]['max_memory_allocated']} -> "
          f"{memory[1]['max_memory_allocated']}", flush=True)
    emit("kv_dtype", runs=runs, memory=memory, float16=f16,
         calls_x_ms=summed, seconds=seconds, checks=checks,
         ok=all(checks.values()))
    require(all(checks.values()), f"kv_dtype phase failed its checks: {checks}")


SAMPLED = dict(temperature=0.8, top_k=50)


def phase_sampled(params, cfg):
    """Threefry noise on the card against the CPU's, and sampled streams
    (module docstring)."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.serving import SamplingParams
    from repro_torch.serving import sampling as SM
    checks = {}
    tiny = float(np.finfo(np.float32).tiny)
    seeds = np.arange(8) * 977 - 3
    counts = np.arange(8) * 13 + 5
    V = cfg.vocab
    noise = {}
    for salt in (SM.SALT_SAMPLE, SM.SALT_DRAFT, SM.SALT_ACCEPT, SM.SALT_RESIDUAL):
        u = {d: SM.row_uniform(seeds, counts, salt, (V,), d, minval=tiny).cpu()
             for d in ("cuda", "cpu")}
        uniform_equal = torch.equal(u["cuda"].view(torch.int32),
                                    u["cpu"].view(torch.int32))
        a = {d: -torch.log(u["cpu"].to(d)).cpu() for d in ("cuda", "cpu")}
        outer = {d: -torch.log(a["cpu"].to(d)).cpu() for d in ("cuda", "cpu")}
        ulp = lambda x, y: (x.view(torch.int32).long()
                            - y.view(torch.int32).long()).abs().max().item()
        g = {d: SM.row_gumbel(seeds, counts, salt, (V,), d).cpu()
             for d in ("cuda", "cpu")}
        an = a["cpu"].numpy()
        gn = g["cpu"].numpy()
        bound = 2 * np.spacing(np.abs(gn)) + 2 * np.spacing(an) / an
        ratio = float((np.abs(g["cuda"].numpy() - gn) / bound).max())
        noise[salt] = {"uniform_bit_equal": uniform_equal,
                       "inner_log_max_ulp": ulp(a["cuda"], a["cpu"]),
                       "outer_log_max_ulp": ulp(outer["cuda"], outer["cpu"]),
                       "gumbel_max_abs": (g["cuda"] - g["cpu"]).abs().max().item(),
                       "gumbel_max_over_bound": ratio}
        checks[f"salt{salt}_uniforms_bit_equal"] = uniform_equal
        checks[f"salt{salt}_gumbel_within_2ulp_a_log"] = (
            noise[salt]["inner_log_max_ulp"] <= 2
            and noise[salt]["outer_log_max_ulp"] <= 2 and ratio <= 1.0)
    # the noise's time for one sampled step at the engine's 8 rows
    logits = torch.randn(8, V, device=DEVICE)
    temps = np.full(8, SAMPLED["temperature"], np.float32)
    top = np.full(8, SAMPLED["top_k"])
    gumbel_ms = time_call(lambda: SM.row_gumbel(seeds, counts, 0, (V,), DEVICE))
    sample_ms = time_call(lambda: SM.sample_rows(logits, seeds, counts, temps, top))
    greedy_ms = time_call(lambda: SM.sample_rows(logits, seeds, counts,
                                                 np.zeros(8, np.float32)))
    t0 = time.perf_counter()
    SM.row_gumbel(seeds, counts, 0, (V,), DEVICE)
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    # sampled streams, spec off and on, each run twice
    streams = {}
    for name, opts in (("spec_off", {}),
                       ("spec_on", dict(speculative=True,
                                        draft_len=SPEC_DRAFT_LEN))):
        toks = []
        for _ in range(2):
            eng = make_engine(params, cfg, requests=False, **opts)
            for i, prompt in enumerate(engine_requests(cfg)):
                eng.add_request(prompt, SamplingParams(max_new_tokens=32,
                                                       seed=i, **SAMPLED))
            PA._wrapper.launches = PA._decode_wrapper.launches = 0
            outs = eng.run_to_completion()
            launches = {"mixed": PA._wrapper.launches,
                        "decode": PA._decode_wrapper.launches}
            check_loud(eng, f"sampled {name}")
            toks.append({o.req_id: o.tokens for o in outs})
        streams[name] = {"requests": len(toks[0]), "launches": launches,
                         "tokens": sum(len(t) for t in toks[0].values()),
                         "identical_twice": toks[0] == toks[1]}
        checks[f"{name}_identical_twice"] = toks[0] == toks[1] and \
            len(toks[0]) == 8
        checks[f"{name}_launched"] = launches["mixed"] > 0 and (
            launches["decode"] > 0 if opts else True)
    emit("sampled", noise={str(k): v for k, v in noise.items()},
         noise_ms={"row_gumbel_8x50257": gumbel_ms,
                   "sample_rows_8_sampled": sample_ms,
                   "sample_rows_8_greedy": greedy_ms,
                   "row_gumbel_host_enqueue": host_ms},
         streams=streams, checks=checks, ok=all(checks.values()))
    require(all(checks.values()), f"sampled phase failed its checks: {checks}")


def phase_policy(params, cfg):
    """The adaptive policy loop through the kernels (module docstring)."""
    from repro_torch.serving import PolicyConfig
    checks = {}
    runs = {}
    tau0 = float(cfg.lamp.kq.tau)
    for name, opts in (
            ("tracking", dict(policy=PolicyConfig(enabled=True,
                                                  target_rate=0.002))),
            ("tight_pool", dict(n_blocks=41, policy=PolicyConfig(
                enabled=True, target_rate=0.002)))):
        eng, outs, wall, shadow, cl = shadow_run(params, cfg, **opts)
        p = eng.stats()["policy"]
        taus = eng.taus.cpu().tolist()
        runs[name] = {"steps": eng.mixed_steps, "launches": cl,
                      "shadow": shadow_line(shadow), "policy": p,
                      "taus": taus, "preemptions": eng.num_preemptions,
                      "requests": len(outs), "tokens_per_s":
                      eng.generated_tokens / wall}
        checks[f"{name}_every_call_held"] = (
            shadow.apart == 0 and shadow.calls > 0 and cl["mixed"] > 0)
        checks[f"{name}_all_finished"] = len(outs) == 8 and all(
            o.error is None for o in outs)
        checks[f"{name}_tau_moved"] = p["actuations"] > 0 and any(
            t != np.float32(tau0) for t in taus)
    tight = runs["tight_pool"]
    checks["tight_pool_shed_dropped_rule"] = (
        tight["preemptions"] > 0 and tight["policy"]["mode_transitions"] > 0
        and tight["shadow"]["rules"].get("relaxed", 0) > 0)
    emit("policy", runs=runs, checks=checks, ok=all(checks.values()))
    require(all(checks.values()), f"policy phase failed its checks: {checks}")


# The audit's card-against-CPU check. Both runs are the same PyTorch code
# (the gather path, core.attention in the "dot_ps" order) on the same
# weights and arena, but cuBLAS and the CPU's BLAS sum the FP32 matmuls in
# other orders: the q, k and v of each layer differ in their last bits, and
# under the strict rule a logit on the threshold can be selected on one
# device and not the other, which moves that logit between its PS(7) and
# FP32 values (up to 2^-8 of it). Twelve layers carry both. Each metric has
# its own absolute bound, from its readings on the captured batch (H100
# 80GB HBM3, 700 W; bit-equal in three runs): kq_err 6.1e-7, cum_err 2.9e-6,
# logit_rel 1.4e-5 and logit_max_abs 2.1e-4, on values of 4.5e-4 to 5.2e-3,
# 2.0e-3 to 5.1e-3, 1.5e-3 to 2.9e-3 and 3.5e-3 to 7.0e-3; router_err is 0
# on a dense model. The bounds leave 2.4-16x room above those readings and
# stay below a seventh of the smallest value each metric takes there (below
# a thirtieth but for logit_max_abs), so a card result off by that much
# fails. Flips and top-k overlaps are equal except on a row whose reference
# logits hold a near-tie at the boundary they read (the top two for the
# flip, the k-th and (k+1)-th for top-k) of less than FLIP_GAP logit units.
AUDIT_BOUND = {"kq_err": 1e-5, "router_err": 0.0, "cum_err": 3e-5,
               "logit_rel": 5e-5, "logit_max_abs": 5e-4}
FLIP_GAP = 1e-2
AUDIT_METRICS = (*AUDIT_BOUND, "flip", "topk")


def finite_tree(x) -> bool:
    if isinstance(x, dict):
        return all(finite_tree(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(finite_tree(v) for v in x)
    if isinstance(x, float):
        return bool(np.isfinite(x))
    return True


def audit_registry_checks(eng, outs, max_rows):
    """The JAX rules of the lamp_audit_* registry, for a run at rate 1."""
    a = eng.stats()["audit"]
    snap = eng.metrics_snapshot()
    rows, steps = a["audited_rows"], a["audited_steps"]
    layer_err = snap["lamp_audit_layer_err_total"]
    return {
        "steps_counter": snap["lamp_audit_steps_total"] == steps,
        "rows_counter": snap["lamp_audit_rows_total"] == rows,
        "rows_bounded": steps <= rows <= max_rows * steps,
        "flips_bounded": 0 <= snap["lamp_audit_flips_total"] <= rows,
        "row_histograms": all(snap[n]["count"] == rows for n in (
            "lamp_audit_logit_rel_err", "lamp_audit_logit_max_abs_err",
            "lamp_audit_topk_overlap")),
        "request_histogram": snap["lamp_audit_request_cum_err"]["count"]
        == len(outs),
        "layer_err_children": len(layer_err) == 3 * eng.cfg.n_layers,
        "per_request": sum(o.audit_samples for o in outs) == rows
        and all(o.audit_samples > 0 for o in outs),
        "finite": finite_tree(a) and finite_tree(snap),
    }


def phase_audit(params, cfg, ref_tokens):
    """The shadow audit on the card (module docstring)."""
    from repro_torch.core import tree as T
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import transformer as TT
    from repro_torch.serving import AuditConfig, PolicyConfig
    from repro_torch.serving.speculative import draft_model_config

    L = cfg.n_layers
    checks = {}
    # 1. the engine's stream, speculation on, fused, every step audited;
    # keep one audit batch, with the arena it ran against, for step 2: the
    # one with the most rows among those at most 16 positions wide (the
    # CPU re-runs it at full width)
    kept = []

    def keep(eng):
        inner = eng._run_audit

        def run_audit(batch):
            Bb, Wb = batch["bucket"]
            score = (Wb <= 16, Bb, Wb)
            if not kept or score > kept[0]:
                full = [(s.prompt + s.generated)[:int(st) + int(ln)]
                        for s, st, ln in zip(batch["seqs"], batch["starts"],
                                             batch["lengths"])]
                kept[:] = [score, {k: v for k, v in batch.items()
                                   if k != "seqs"},
                           eng.pool.k.cpu(), eng.pool.v.cpu(),
                           eng.taus.cpu(), eng._serving_cfg(), full]
            return inner(batch)
        eng._run_audit = run_audit

    audit_all = AuditConfig(rate=1.0)
    PA._wrapper.launches = PA._decode_wrapper.launches = 0
    eng, outs, wall = run_engine(params, cfg, setup=keep, speculative=True,
                                 draft_len=SPEC_DRAFT_LEN, audit=audit_all)
    mix_l, dec_l = PA._wrapper.launches, PA._decode_wrapper.launches
    a = eng.stats()["audit"]
    lc = eng.launch_counts
    site = TT._kq_site(cfg, True)
    dsite = TT._kq_site(draft_model_config(cfg), True)
    exp_mix = (lc["mixed"] + lc["prefill"] + lc["verify"]) * L * PA.passes(site)
    exp_dec = lc["draft"] * SPEC_DRAFT_LEN * L * PA.passes(dsite)
    toks = {o.req_id: o.tokens for o in outs}
    checks["tokens_equal_phase_engine"] = toks == ref_tokens
    checks["every_step_audited"] = (a["audited_steps"] == eng.total_steps
                                    == lc["audit"] > 0)
    checks["kernels_launched"] = mix_l == exp_mix > 0 and dec_l == exp_dec > 0
    reg = audit_registry_checks(eng, outs, audit_all.max_rows)
    checks.update({f"registry_{k}": v for k, v in reg.items()})
    phase = eng.stats()["phase"]
    stream = {"steps": eng.total_steps, "audited_rows": a["audited_rows"],
              "flip_rate": a["flip_rate"], "logit_rel_err": a["logit_rel_err"],
              "layer_kq_err": a["layer_kq_err"],
              "layer_cum_err": a["layer_cum_err"],
              "lamp_recompute_rate": eng.stats()["lamp_recompute_rate"],
              "ms_per_step": 1e3 * wall / eng.total_steps,
              "audit_span_mean_ms": phase["audit"]["mean_us"] / 1e3,
              "mixed_kernel_launches": mix_l, "decode_kernel_launches": dec_l,
              "launches_by_fn": lc}

    # 1b. the same stream with the phase-segregated plans: the audited
    # error fused against phased, the JAX burn-in's comparison
    e, o, w = run_engine(params, cfg, speculative=True,
                         draft_len=SPEC_DRAFT_LEN, audit=audit_all,
                         fused_step=False)
    pa = e.stats()["audit"]
    checks["phased_tokens_equal_phase_engine"] = {
        x.req_id: x.tokens for x in o} == ref_tokens
    checks["phased_every_step_audited"] = (
        pa["audited_steps"] == e.total_steps == e.launch_counts["audit"] > 0
        and e.mixed_steps == 0)
    reg = audit_registry_checks(e, o, audit_all.max_rows)
    checks.update({f"phased_registry_{k}": v for k, v in reg.items()})
    fused_phased = {
        name: {"steps": x.total_steps, "audited_rows": y["audited_rows"],
               "logit_rel_err": y["logit_rel_err"], "flip_rate": y["flip_rate"],
               "layer_cum_err": y["layer_cum_err"],
               "request_err_sum": {r.req_id: r.audit_err_sum for r in z},
               "request_samples": {r.req_id: r.audit_samples for r in z}}
        for name, x, y, z in (("fused", eng, a, outs), ("phased", e, pa, o))}
    print("audit fused vs phased (logit rel err, flip rate, rows): " +
          "  ".join(f"{k}: {v['logit_rel_err']:.4e}, {v['flip_rate']:.4f}, "
                    f"{v['audited_rows']}" for k, v in fused_phased.items()),
          flush=True)

    # 2. one captured batch through the shadow forward on the card and on
    # the CPU, on the same weights and arena
    _, b, hk, hv, htaus, scfg, full = kept
    dev = torch.device(DEVICE)
    args = [torch.from_numpy(b[n]) for n in ("tokens", "bt", "starts",
                                             "lengths", "row_mask")]
    with torch.no_grad():
        card = TT.paged_audit_window(
            scfg, params, args[0].to(dev), {"k": hk.to(dev), "v": hv.to(dev)},
            *[t.to(dev) for t in args[1:]], taus=htaus.to(dev),
            top_k=audit_all.top_k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cpu_params = T.map(lambda t: t.cpu(), params)
        host = TT.paged_audit_window(scfg, cpu_params, args[0],
                                     {"k": hk, "v": hv}, *args[1:],
                                     taus=htaus, top_k=audit_all.top_k)
        cpu_s = time.perf_counter() - t0
    del cpu_params
    live = int(b["row_mask"].sum())
    diffs, values, apart = {}, {}, []
    ok = True
    for name in AUDIT_METRICS:
        c, h = card[name].cpu().numpy(), host[name].numpy()
        if c.shape[0] != L:
            c, h = c[:live], h[:live]
        ok = ok and bool(np.all(np.isfinite(c)))
        d = np.abs(c - h)
        diffs[name] = float(d.max())
        values[name] = [float(np.abs(h).min()), float(np.abs(h).max())]
        if name in AUDIT_BOUND:
            ok = ok and bool(np.all(d <= AUDIT_BOUND[name]))
            continue
        k = 1 if name == "flip" else audit_all.top_k
        for r in np.nonzero(c != h)[0]:
            gap = top2_gap(params, cfg, full[r][:-1], full[r][-1:], 1, k=k)
            apart.append({"metric": name, "row": int(r), "gap": gap})
            ok = ok and gap < FLIP_GAP
    checks["card_equals_cpu"] = ok
    card_cpu = {"bucket": list(b["bucket"]), "rows": live,
                "max_abs_diff": diffs, "cpu_value_range": values,
                "rows_apart": apart,
                "bounds": AUDIT_BOUND, "flip_gap": FLIP_GAP, "cpu_s": cpu_s}

    # 3. the accuracy-for-recompute trade: the stream at tau 1e-4 and 0.5
    sweep = {}
    for tau in (1e-4, 0.5):
        kq = cfg.lamp.kq.replace(tau=tau)
        tcfg = cfg.replace(lamp=cfg.lamp.replace(kq=kq))
        e, o, w = run_engine(params, tcfg, audit=audit_all)
        sa = e.stats()
        sweep[str(tau)] = {"logit_rel_err": sa["audit"]["logit_rel_err"],
                           "flip_rate": sa["audit"]["flip_rate"],
                           "layer_kq_err": sa["audit"]["layer_kq_err"],
                           "lamp_recompute_rate": sa["lamp_recompute_rate"],
                           "audited_steps": sa["audit"]["audited_steps"]}
        checks[f"tau_{tau}_finite"] = finite_tree(sa["audit"])
    checks["error_lower_at_small_tau"] = (
        sweep["0.0001"]["logit_rel_err"] < sweep["0.5"]["logit_rel_err"])
    print("audit trade (tau: logit rel err at recompute rate): " + "  ".join(
        f"{t}: {s['logit_rel_err']:.3e} at {s['lamp_recompute_rate']:.4f}"
        for t, s in sweep.items()), flush=True)

    # 4. calibration into a live policy
    e, o, w = run_engine(params, cfg, audit=audit_all, policy=PolicyConfig(
        enabled=True, target_rate=0.05))
    pa, pp = e.stats()["audit"], e.stats()["policy"]
    checks["calibrated"] = pa["calibrations"] > 0
    checks["policy_holds_audit_targets"] = (
        pp["targets"] == pa.get("targets")
        and pp["target_updates"] == pa["calibrations"])
    calib = {"calibrations": pa["calibrations"], "targets": pa.get("targets"),
             "relax_ok": pa.get("relax_ok"), "policy_targets": pp["targets"],
             "policy_mode": pp["mode"], "tau_mean": pp["tau_mean"]}

    # 5. what the audit costs: the stream at rates 0, 1 and 0.05, twice in
    # turn; the audit span's mean beside the step's
    cost = []
    for _ in range(2):
        for rate in (0.0, 1.0, 0.05):
            e, o, w = run_engine(params, cfg, audit=AuditConfig(rate=rate))
            ph = e.stats()["phase"]
            cost.append({"rate": rate, "steps": e.total_steps,
                         "audited_steps": (e.stats()["audit"]["audited_steps"]
                                           if rate else 0),
                         "ms_per_step": 1e3 * w / e.total_steps,
                         "audit_span_mean_ms": (ph["audit"]["mean_us"] / 1e3
                                                if "audit" in ph else 0.0),
                         "tokens_equal": {x.req_id: x.tokens for x in o}
                         == ref_tokens})
            checks[f"rate_{rate}_tokens_equal"] = cost[-1]["tokens_equal"]
    print("audit cost (rate: ms/step, audit span ms): " + "  ".join(
        f"{c['rate']}: {c['ms_per_step']:.2f}, {c['audit_span_mean_ms']:.2f}"
        for c in cost), flush=True)
    emit("audit", stream=stream, fused_vs_phased=fused_phased,
         card_vs_cpu=card_cpu, tau_sweep=sweep,
         calibration=calib, cost=cost, checks=checks,
         ok=all(checks.values()))
    require(all(checks.values()), f"audit phase failed its checks: {checks}")


def phase_phased(params, cfg, ref_tokens):
    """fused_step=False against the fused step (module docstring)."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import transformer as TT
    from repro_torch.serving.speculative import draft_model_config

    L = cfg.n_layers
    site = TT._kq_site(cfg, True)
    dsite = TT._kq_site(draft_model_config(cfg), True)
    checks, runs = {}, {}
    for spec in (False, True):
        opts = dict(speculative=spec, draft_len=SPEC_DRAFT_LEN) if spec else {}
        for fused in (True, False):
            name = f"{'spec' if spec else 'plain'}_{'fused' if fused else 'phased'}"
            eng, outs, wall, shadow, cl = shadow_run(params, cfg,
                                                     fused_step=fused, **opts)
            lc = eng.launch_counts
            exp_mix = ((lc["mixed"] + lc["prefill"] + lc["verify"]) * L
                       * PA.passes(site))
            exp_dec = (lc["draft"] * SPEC_DRAFT_LEN * L * PA.passes(dsite)
                       + lc["decode"] * L * PA.passes(site))
            s = eng.stats()
            runs[name] = {"steps": eng.total_steps,
                          "prefill_steps": s["prefill_steps"],
                          "decode_steps": s["decode_steps"],
                          "spec_rounds": s["spec_rounds"],
                          "launches_by_fn": lc, "kernel_launches": cl,
                          "expected": {"mixed": exp_mix, "decode": exp_dec},
                          "shadow": shadow_line(shadow)}
            checks[f"{name}_tokens"] = {o.req_id: o.tokens
                                        for o in outs} == ref_tokens
            checks[f"{name}_launches"] = (cl["mixed"] == exp_mix > 0
                                          and cl["decode"] == exp_dec)
            checks[f"{name}_every_call_held"] = (shadow.apart == 0
                                                 and shadow.calls > 0)
            if not fused:
                checks[f"{name}_segregated"] = (
                    eng.mixed_steps == 0 and lc["prefill"] > 0
                    and (lc["verify"] if spec else lc["decode"]) > 0
                    and cl["decode"] > 0)
    # time both plans without the Shadow's plain re-runs, in turns
    # (fused, phased, phased, fused), spec off and on
    timing = collections.defaultdict(list)
    for spec in (False, True):
        opts = dict(speculative=spec, draft_len=SPEC_DRAFT_LEN) if spec else {}
        for fused in (True, False, False, True):
            name = f"{'spec' if spec else 'plain'}_{'fused' if fused else 'phased'}"
            eng, outs, wall = run_engine(params, cfg, fused_step=fused, **opts)
            timing[name].append({
                "steps": eng.total_steps, "wall_s": wall,
                "ms_per_step": 1e3 * wall / eng.total_steps,
                "tokens_per_s": eng.generated_tokens / wall,
                "step_ms": step_breakdown(eng)})
            checks[f"{name}_timed_tokens"] = checks.get(
                f"{name}_timed_tokens", True) and {
                    o.req_id: o.tokens for o in outs} == ref_tokens
    med = {k: statistics.median(t["ms_per_step"] for t in v)
           for k, v in timing.items()}
    print("phased (median ms/step fused -> phased): " + "  ".join(
        f"{k}: {med[k + '_fused']:.2f} -> {med[k + '_phased']:.2f}"
        for k in ("plain", "spec")), flush=True)
    emit("phased", runs=runs, timing=timing, checks=checks,
         ok=all(checks.values()))
    require(all(checks.values()), f"phased phase failed its checks: {checks}")


def moe_2_layers():
    """qwen3-moe-30b-a3b at its published widths (d 2048, 32 heads on 4 KV
    heads, hd 128, qk-norm, RoPE theta 1e6, 128 experts, top 8, expert FFN
    768, vocab 151936, bfloat16, the deployment policy: KQ relaxed g 0,
    router strict g 0, mu 7, tau 0.05) with its 48 layers cut to 2."""
    from repro_torch.configs import get_config
    return get_config("qwen3-moe-30b-a3b").replace(
        n_layers=2, name="qwen3-moe-30b-a3b-2l")


# one MoE layer in bfloat16, card against CPU on the same inputs: the
# expert matmuls sum in other orders, so each bfloat16 rounding of h, of
# the activation's product, of the expert outputs, of the gate products
# and of the eight combine additions may land one step apart (2^-8
# relative each); six such roundings in a chain give the bound
MOE_REL_L2 = 1e-2
MOE_MAX_ABS_OF_MAX = 2e-2
# the first engine step's layer-0 MoE inputs, kernel arm against gather
# arm, each token's relative L2: the attention outputs agree to rtol 2e-5,
# so in bfloat16 a few elements of a token round one step (2^-8 relative)
# apart and the output projection, residual add and norm round once more
# each; a wrong kernel (a padded query, the null block) moves whole tokens
MOE_INPUT_REL = 1e-2


def moe_layer_card_vs_cpu(cfg, params):
    """`moe_apply` of layer 0 on the card and on the CPU at an 8 x 128 and
    an 8 x 1 bucket of seeded hidden states: routing (top-k experts), the
    slots and the keep mask equal, outputs within MOE_REL_L2 /
    MOE_MAX_ABS_OF_MAX; the kept share printed (the 8 x 1 bucket's
    capacity is 2 entries an expert). The router's low arms are compared
    too: a y_low that rounds apart (the FP32 products summed in another
    order, a value on a PS(7) boundary) is printed, not gated."""
    from repro_torch.core.mixed_matmul import dot_ps
    from repro_torch.models import moe as TM
    from repro_torch.models import transformer as TT
    p_card = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    p_cpu = {k: v.cpu() for k, v in p_card.items()}
    site = TT._router_site(cfg, True)
    gen = torch.Generator().manual_seed(7)
    # a component every token shares (as hidden states do) skews the
    # routing, so the 8 x 1 bucket's capacity of 2 binds
    shared = torch.randn((1, 1, cfg.d_model), generator=gen)
    out, ok = [], True
    for B, T in ((8, 128), (8, 1)):
        x = (0.7 * torch.randn((B, T, cfg.d_model), generator=gen)
             + shared).to(torch.bfloat16)
        got = {}
        for dev, p in ((DEVICE, p_card), ("cpu", p_cpu)):
            xd = x.to(dev)
            y, m = TM.moe_apply(cfg, p, xd, lamp_site=site)
            _, _, top_e, _ = TM.route(cfg, p["router"],
                                      xd.reshape(-1, cfg.d_model), site)
            pos = TM.slots(top_e.reshape(-1), cfg.n_experts)
            cap = TM.capacity(cfg, B * T, T, False)
            y_low = dot_ps(xd.reshape(-1, cfg.d_model).float(), p["router"],
                           site.mu, granularity=site.granularity)
            got[dev] = dict(y=y.float().cpu(), top_e=top_e.cpu(),
                            pos=pos.cpu(), keep=(pos < cap).cpu(), cap=cap,
                            kept=float(m["kept_frac"]),
                            rate=float(m["router_lamp_rate"]),
                            y_low=y_low.cpu())
        c, h = got[DEVICE], got["cpu"]
        err = c["y"] - h["y"]
        rel_l2 = float(err.norm() / h["y"].norm())
        max_abs = float(err.abs().max())
        of_max = max_abs / float(h["y"].abs().max())
        ms = time_call(lambda: TM.moe_apply(cfg, p_card, x.to(DEVICE),
                                            lamp_site=site))
        checks = {"routing_equal": torch.equal(c["top_e"], h["top_e"]),
                  "slots_equal": torch.equal(c["pos"], h["pos"]),
                  "keep_equal": torch.equal(c["keep"], h["keep"]),
                  "kept_frac_equal": c["kept"] == h["kept"],
                  "outputs": rel_l2 <= MOE_REL_L2
                  and of_max <= MOE_MAX_ABS_OF_MAX,
                  "drops_at_decode": T > 1 or c["kept"] < 1.0}
        ok = ok and all(checks.values())
        out.append({"bucket": [B, T], "capacity": c["cap"],
                    "kept_frac": c["kept"], "kept_frac_cpu": h["kept"],
                    "router_lamp_rate": c["rate"],
                    "router_lamp_rate_cpu": h["rate"],
                    "y_low_apart": int((c["y_low"] != h["y_low"]).sum()),
                    "rel_l2": rel_l2, "max_abs_err": max_abs,
                    "max_abs_of_max": of_max, "card_ms": ms,
                    "checks": checks})
    return out, ok


def serve_few(params, cfg, n, new, **options):
    """The first `n` prompts of the engine's stream, `new` greedy tokens
    each: (engine, {req_id: tokens})."""
    from repro_torch.serving import SamplingParams
    eng = make_engine(params, cfg, requests=False, **options)
    for i, prompt in enumerate(engine_requests(cfg)[:n]):
        eng.add_request(prompt, SamplingParams(max_new_tokens=new, seed=i))
    outs = eng.run_to_completion()
    check_loud(eng, f"serve_few {options}")
    return eng, {o.req_id: o.tokens for o in outs}


class RoutingRecorder:
    """Wraps `moe.moe_apply` for one engine run: the top-k experts of its
    first `n` calls (the first steps' layers), to count the routing
    entries two arms send to other experts, and the input of its first
    call (the first step's layer 0)."""

    def __init__(self, n=2 * 2):
        self.n, self.top_e, self.x0 = n, [], None

    def __enter__(self):
        from repro_torch.models import moe as TM
        self.inner = TM.moe_apply

        def recording(cfg, p, x, **kw):
            if self.x0 is None:
                self.x0 = x.float().cpu()
            if len(self.top_e) < self.n:
                _, _, te, _ = TM.route(cfg, p["router"],
                                       x.reshape(-1, x.shape[-1]),
                                       kw["lamp_site"])
                self.top_e.append(te.cpu())
            return self.inner(cfg, p, x, **kw)
        TM.moe_apply = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as TM
        TM.moe_apply = self.inner


def moe_arms(params, cfg, checks, tag):
    """The engine's stream with kernel "cuda" under `Shadow` and with
    kernel "gather" (module docstring, phase moe): fills `checks` (each
    name prefixed with `tag`), returns (the line's fields, the cuda arm's
    tokens by request). First tokens are gated in FP32 only: in bfloat16
    the attention outputs, which agree to rtol 2e-5, round to bfloat16
    apart in a few elements, a router logit then moves, and capacity
    passes the move on to other tokens (the first steps' routing entries
    apart are printed). In both dtypes the first step's layer-0 MoE
    inputs, which only layer 0's attention separates, are gated token by
    token (MOE_INPUT_REL)."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import transformer as TT
    site = TT._kq_site(cfg, True)
    with RoutingRecorder() as crec:
        eng, outs, wall, shadow, cl = shadow_run(params, cfg)
    PA._wrapper.launches = PA._decode_wrapper.launches = 0
    with RoutingRecorder() as grec:
        geng, gouts, gwall = run_engine(params, cfg, kernel="gather")
    gl = {"mixed": PA._wrapper.launches, "decode": PA._decode_wrapper.launches}
    co = {o.req_id: o.tokens for o in outs}
    go = {o.req_id: o.tokens for o in gouts}
    n_tok = sum(len(t) for t in co.values())
    same = sum(a == b for r in co for a, b in zip(co[r], go.get(r, [])))
    first = sum(co[r][:1] == go[r][:1] for r in co if r in go)
    a0 = crec.x0.reshape(-1, crec.x0.shape[-1])
    b0 = grec.x0.reshape(-1, a0.shape[-1])
    in_rel = float(((a0 - b0).norm(dim=-1)
                    / b0.norm(dim=-1).clamp(min=1e-30)).max())
    checks[f"{tag}first_moe_inputs_within_rounding"] = (
        a0.shape == b0.shape and in_rel <= MOE_INPUT_REL)
    checks[f"{tag}arms_served_every_request"] = len(co) == len(go) == 8
    checks[f"{tag}cuda_arm_launches"] = cl["mixed"] == eng.mixed_steps * \
        cfg.n_layers * PA.passes(site) > 0
    checks[f"{tag}cuda_arm_every_call_held"] = (shadow.apart == 0
                                                and shadow.calls > 0)
    checks[f"{tag}gather_arm_no_launches"] = sum(gl.values()) == 0
    if cfg.dtype == "float32":
        checks[f"{tag}first_tokens_equal"] = first == len(co)
    return {"dtype": cfg.dtype,
            "cuda": {"steps": eng.total_steps, "wall_s": wall,
                     "tokens_per_s": eng.generated_tokens / wall,
                     "launches": cl, "shadow": shadow_line(shadow)},
            "gather": {"steps": geng.total_steps, "wall_s": gwall,
                       "tokens_per_s": geng.generated_tokens / gwall,
                       "launches": gl},
            "first_moe_inputs": {
                "tokens": a0.shape[0], "max_token_rel_l2": in_rel,
                "max_abs_err": float((a0 - b0).abs().max()),
                "elements_apart": int((a0 != b0).sum())},
            "first_tokens_equal": f"{first}/{len(co)}",
            "tokens_equal": f"{same}/{n_tok}",
            "first_calls_routing_entries_apart": [
                int((a != b).sum()) for a, b in zip(crec.top_e, grec.top_e)]
            }, co


def phase_moe():
    """The MoE family on the card (module docstring)."""
    import gc
    from repro_torch.core import tree as T
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models import transformer as TT
    from repro_torch.serving import AuditConfig
    from repro_torch.serving.speculative import draft_model_config
    t0 = time.perf_counter()
    cfg = moe_2_layers()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = TT.init_params(cfg, 0, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size() for t in T.leaves(params))
    L = cfg.n_layers
    site = TT._kq_site(cfg, True)
    dsite = TT._kq_site(draft_model_config(cfg), True)
    checks = {}
    # 1. one MoE layer, card against CPU
    layer, checks["layer_card_vs_cpu"] = moe_layer_card_vs_cpu(cfg, params)
    # 2. kernel arm (every call held to the plain version) against gather,
    # in bfloat16 and with the same weights cast to FP32
    arms, co = moe_arms(params, cfg, checks, "")
    n_tok = sum(len(t) for t in co.values())
    peak_bf16 = torch.cuda.max_memory_allocated()
    fcfg = cfg.replace(dtype="float32", name=cfg.name + "-fp32")
    fparams = T.map(lambda t: t.float(), params)
    arms_fp32, _ = moe_arms(fparams, fcfg, checks, "fp32_")
    del fparams
    # 3. speculation on (fused, draft_len 4), under Shadow
    seng, souts, swall, sshadow, scl = shadow_run(
        params, cfg, speculative=True, draft_len=SPEC_DRAFT_LEN)
    lc = seng.launch_counts
    exp_mix = (lc["mixed"] + lc["prefill"] + lc["verify"]) * L * \
        PA.passes(site)
    exp_dec = lc["draft"] * SPEC_DRAFT_LEN * L * PA.passes(dsite)
    so = {o.req_id: o.tokens for o in souts}
    checks["spec_every_request_finished"] = (
        len(so) == 8 and all(o.finish_reason for o in souts))
    checks["spec_launches"] = scl["mixed"] == exp_mix > 0 and \
        scl["decode"] == exp_dec > 0
    checks["spec_every_call_held"] = sshadow.apart == 0 and sshadow.calls > 0
    spec_same = sum(a == b for r in co for a, b in zip(co[r], so.get(r, [])))
    spec = {"steps": seng.total_steps, "spec_rounds": seng.spec_rounds,
            "acceptance": seng.stats()["spec_acceptance_rate"],
            "wall_s": swall, "launches": scl,
            "expected": {"mixed": exp_mix, "decode": exp_dec},
            "shadow": shadow_line(sshadow),
            "tokens_equal_spec_off": f"{spec_same}/{n_tok}"}
    # 4. the audit at rate 1 on two requests of 4 new tokens
    _, plain_toks = serve_few(params, cfg, 2, 4)
    aeng, audit_toks = serve_few(params, cfg, 2, 4,
                                 audit=AuditConfig(rate=1.0))
    a = aeng.stats()["audit"]
    rerr = a["layer_router_err"]
    checks["audit_tokens_unchanged"] = audit_toks == plain_toks
    checks["audit_every_step"] = a["audited_steps"] == aeng.total_steps > 0
    checks["router_err_finite_positive"] = (
        len(rerr) == L and all(np.isfinite(e) and e > 0 for e in rerr))
    audit = {"steps": aeng.total_steps, "audited_rows": a["audited_rows"],
             "layer_router_err": rerr, "layer_kq_err": a["layer_kq_err"],
             "layer_cum_err": a["layer_cum_err"],
             "logit_rel_err": a["logit_rel_err"], "flip_rate": a["flip_rate"]}
    print(f"moe: kept_frac {[r['kept_frac'] for r in layer]} at buckets "
          f"{[r['bucket'] for r in layer]}; cuda/gather first-step layer-0 "
          f"MoE input rel {arms['first_moe_inputs']['max_token_rel_l2']:.3g}"
          f" (FP32 {arms_fp32['first_moe_inputs']['max_token_rel_l2']:.3g}),"
          f" first tokens "
          f"{arms['first_tokens_equal']}, tokens {arms['tokens_equal']} "
          f"(FP32: {arms_fp32['first_tokens_equal']}, "
          f"{arms_fp32['tokens_equal']}), spec=off "
          f"{spec['tokens_equal_spec_off']};"
          f" router_err {rerr}", flush=True)
    emit("moe", config=cfg.name, n_layers=L, d_model=cfg.d_model,
         n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, hd=cfg.hd,
         n_experts=cfg.n_experts, top_k=cfg.top_k, d_ff=cfg.d_ff,
         vocab=cfg.vocab, dtype=cfg.dtype, kq_rule=site.rule,
         router_rule=cfg.lamp.router.rule, params_init_s=init_s,
         param_bytes=param_bytes, max_memory_allocated_bf16=peak_bf16,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         layer=layer, arms=arms, arms_fp32=arms_fp32, spec=spec, audit=audit,
         seconds=time.perf_counter() - t0, checks=checks,
         ok=all(checks.values()))
    require(all(checks.values()), f"moe phase failed its checks: {checks}")


# The paper's evaluation path (phase paper). LAMP as in the paper's figure
# 1: the strict rule at mu 4, tau 0.1, granularity 1; uniform PS(4) is the
# strict rule at a tau that selects nothing; the random control takes the
# strict rule's counts a row at random positions.
PAPER_SITE = dict(mu=4, tau=0.1, granularity=1)
PAPER_CPU_LAYERS, PAPER_CPU_SEQ = 2, 256
# card against CPU, logits of the 2-layer model, the largest difference
# over the largest logit. FP32 arm: each device sums the FP32 matmuls in its
# own order (about 1e-6 relative a layer). LAMP arm: q and k then differ in
# their last bits, so a strict selection near tau can fall the other way in
# one device's forward, which moves that product by up to half a PS(4) step
# (2^-5 of it) and the logits by up to about 1e-2 of the largest (4.3e-3
# on an H100: one layer-0 selection of 48,526 apart)
PAPER_FP32_REL = 1e-4
PAPER_LOGIT_REL = 1e-2
# control readings of that gate, each held above it: what a wrong card path
# scores against the CPU's LAMP logits (the FP32 arm or uniform PS(4) in
# LAMP's place, or LAMP at PS(5) in place of PS(4); 6.28e-2, 0.566 and
# 6.34e-2 on an H100)
PAPER_CONTROLS = {"fp32": None, "uniform_ps4": ("strict", 4, None),
                  "lamp_ps5": ("strict", 5, 0.1)}
# the online rule's KV block at seq 256: 8 blocks, q-tiled (256 / 8 >= 32)
PAPER_BLOCK = 32


class AttentionCapture:
    """Records the inputs of every ``core.attention.attention_lamp`` call
    that ``layers.attention_sublayer`` makes (it looks the function up on
    the module)."""

    def __init__(self):
        from repro_torch.core import attention as CA
        self.CA, self.orig = CA, CA.attention_lamp
        self.calls, self.selected = [], []

    def __enter__(self):
        def wrapped(q, k, v, site, **kw):
            self.calls.append((q, k, v, site, kw))
            out = self.orig(q, k, v, site, **kw)
            self.selected.append(float(out[1].n_selected.sum()))
            return out
        self.CA.attention_lamp = wrapped
        return self

    def __exit__(self, *exc):
        self.CA.attention_lamp = self.orig


def paper_forward(cfg, params, tokens, policy):
    """(logits, aux, ms) of one forward under `policy` (None: FP32)."""
    from repro_torch.core.policy import LampPolicy
    from repro_torch.models import transformer as TT
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if policy is None:
        logits, aux = TT.forward(cfg.replace(lamp=LampPolicy.disabled()),
                                 params, tokens, use_lamp=False)
    else:
        logits, aux = TT.forward(cfg.replace(lamp=policy), params, tokens,
                                 use_lamp=True)
    torch.cuda.synchronize()
    return logits, aux, 1e3 * (time.perf_counter() - t0)


def paper_card_vs_cpu(cfg, params, tokens, checks):
    """gpt2-small cut to 2 layers at seq 256, card against CPU: logits of
    the strict arm, beside the control readings of ``PAPER_CONTROLS``; per
    layer, on the card's own q, k, v, attention_lamp on the card and on the
    CPU: per-(row, query) counts (strict: 1 apart at most, the normalizer's
    order; relaxed: exact) and outputs within ``PAPER_FP32_REL`` of the
    largest on the rows whose counts agree; and on the card
    chunked_attention_lamp's two-pass count equal to attention_lamp's
    relaxed count and its one-pass count at least that."""
    from repro_torch.core import attention as CA
    from repro_torch.core import tree as T
    from repro_torch.core.policy import LampPolicy, LampSite
    from repro_torch.launch import paper_figs as PF
    from repro_torch.models import transformer as TT
    L, S = PAPER_CPU_LAYERS, PAPER_CPU_SEQ
    cfg2 = cfg.replace(n_layers=L)
    p2 = dict(params, blocks=T.map(lambda t: t[:L], params["blocks"]))
    toks = tokens[:, :S]
    strict = LampPolicy.paper_default(rule="strict", **PAPER_SITE)
    cpu_params = T.map(lambda t: t.cpu(), p2)

    def rel(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())

    card_fp32 = paper_forward(cfg2, p2, toks, None)[0].cpu()
    fp32_rel = rel(card_fp32, TT.forward(cfg2, cpu_params, toks.cpu())[0])
    with AttentionCapture() as cap:
        card, _, _ = paper_forward(cfg2, p2, toks, strict)
    with AttentionCapture() as cpu_cap:
        cpu, _ = TT.forward(cfg2.replace(lamp=strict), cpu_params,
                            toks.cpu(), use_lamp=True)
    card = card.cpu()
    logit_rel = rel(card, cpu)
    controls = {}
    for name, arm in PAPER_CONTROLS.items():
        if arm is None:
            got = card_fp32
        else:
            rule, mu, tau = arm
            pol = LampPolicy.paper_default(
                rule=rule, mu=mu, granularity=PAPER_SITE["granularity"],
                tau=PF._UNIFORM_TAU if tau is None else tau)
            got = paper_forward(cfg2, p2, toks, pol)[0]
        controls[name] = rel(got, cpu)
    layers = []
    for q, k, v, _, kw in cap.calls:
        row = {}
        for rule in ("strict", "relaxed"):
            site = LampSite(rule=rule, **PAPER_SITE)
            (oc, ac), (oh, ah) = [
                CA.attention_lamp(*(t.to(d) for t in (q, k, v)), site,
                                  reduce=False, window=kw.get("window"))
                for d in (DEVICE, "cpu")]
            n = [ac.n_selected.cpu(), ah.n_selected]
            agree = (n[0] == n[1])[:, None, :, None]     # (B, 1, Tq, 1)
            apart = ((oc.cpu() - oh).abs() * agree).max() / oh.abs().max()
            row[rule] = {"selected": float(n[0].sum()),
                         "max_apart": float((n[0] - n[1]).abs().max()),
                         "rows_apart": int((n[0] != n[1]).sum()),
                         "out_max_abs_over_max": float(apart)}
        relaxed = LampSite(rule="relaxed", **PAPER_SITE)
        _, full = CA.attention_lamp(q, k, v, relaxed)
        _, two = CA.chunked_attention_lamp(q, k, v, relaxed, block=PAPER_BLOCK)
        _, one = CA.chunked_attention_lamp(q, k, v, relaxed, block=PAPER_BLOCK,
                                           onepass=True)
        row["relaxed_selected"] = float(full.n_selected)
        row["twopass_selected"] = float(two.n_selected)
        row["onepass_selected"] = float(one.n_selected)
        layers.append(row)
    checks["cpu_layers_captured"] = len(layers) == L
    checks["cpu_fp32_logits_within_tol"] = fp32_rel <= PAPER_FP32_REL
    checks["cpu_logits_within_tol"] = (
        bool(torch.isfinite(card).all()) and logit_rel <= PAPER_LOGIT_REL)
    checks["logit_gate_below_every_control"] = all(
        c > PAPER_LOGIT_REL for c in controls.values())
    checks["cpu_strict_counts_within_1"] = all(
        r["strict"]["max_apart"] <= 1 for r in layers)
    checks["cpu_relaxed_counts_exact"] = all(
        r["relaxed"]["max_apart"] == 0 for r in layers)
    checks["cpu_attention_outputs_within_fp32_tol"] = all(
        r[rule]["out_max_abs_over_max"] <= PAPER_FP32_REL
        for r in layers for rule in ("strict", "relaxed"))
    checks["twopass_counts_equal_relaxed"] = all(
        r["twopass_selected"] == r["relaxed_selected"] > 0 for r in layers)
    checks["onepass_counts_at_least_twopass"] = all(
        r["onepass_selected"] >= r["twopass_selected"] for r in layers)
    return {"n_layers": L, "seq": S, "fp32_logit_max_abs_over_max": fp32_rel,
            "logit_max_abs_over_max": logit_rel,
            "logit_gate": PAPER_LOGIT_REL, "controls_against_cpu_lamp": controls,
            "own_forward_selected": {"card": cap.selected,
                                     "cpu": cpu_cap.selected},
            "layers": layers}


def phase_paper():
    """The paper's evaluation path on the card (module docstring)."""
    import gc
    from repro_torch.core import attention as CA
    from repro_torch.core import numerics as CN
    from repro_torch.core import prng
    from repro_torch.core.policy import LampPolicy
    from repro_torch.launch import paper_figs as PF
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    checks = {}
    # 1. stochastic rounding and uniform, card against CPU, bit for bit
    gen = torch.Generator().manual_seed(0)
    n = 1 << 22
    x = torch.randn(n, generator=gen) * torch.pow(
        10.0, torch.randint(-30, 30, (n,), generator=gen).float())
    x[:4] = torch.tensor([float("inf"), float("-inf"), float("nan"), 0.0])
    bits = {}
    for mu in (4, 7):
        want = CN.round_to_mantissa_stochastic(x, mu, prng.PRNGKey(mu))
        got = CN.round_to_mantissa_stochastic(x.to(DEVICE), mu,
                                              prng.PRNGKey(mu, DEVICE)).cpu()
        bits[f"sr_mu{mu}_apart"] = int(
            (got.view(torch.int32) != want.view(torch.int32)).sum())
    u = [prng.uniform(prng.PRNGKey(1, d), (4, n // 4)).cpu()
         for d in (DEVICE, "cpu")]
    bits["uniform_apart"] = int(
        (u[0].view(torch.int32) != u[1].view(torch.int32)).sum())
    checks["sr_and_uniform_bit_equal"] = not any(bits.values())
    # 2. gpt2-small at published widths: FP32, uniform PS(4), LAMP, random
    sc = PF.SCALES["full"]
    cfg, params = PF.build_model(sc.small, seed=0, device=DEVICE)
    tokens = PF.make_batches(cfg, sc, n_batches=1, device=DEVICE)[0]["tokens"]
    paper_forward(cfg, params, tokens, None)          # warm-up (cuBLAS)
    torch.cuda.reset_peak_memory_stats()
    ref, _, ref_ms = paper_forward(cfg, params, tokens, None)
    arms = {}
    for name, rule, tau in (("uniform", "strict", PF._UNIFORM_TAU),
                            ("lamp", "strict", PAPER_SITE["tau"]),
                            ("random", "random", PAPER_SITE["tau"])):
        pol = LampPolicy.paper_default(rule=rule, **dict(PAPER_SITE, tau=tau))
        torch.cuda.reset_peak_memory_stats()
        with AttentionCapture() as cap:
            logits, aux, ms = paper_forward(cfg, params, tokens, pol)
        kl, flip, nll = PF.logit_metrics(ref, logits, tokens)
        arms[name] = {"kl": kl, "flip_rate": flip,
                      "recompute_rate": float(aux["attn_lamp_rate"]),
                      "perplexity": float(np.exp(nll)), "ms_per_forward": ms,
                      "max_memory_allocated": torch.cuda.max_memory_allocated(),
                      "finite": bool(torch.isfinite(logits).all())}
        del logits
    # the control's counts a (row, query), over heads, against the strict
    # rule's on each layer's inputs of the random arm's forward
    apart = []
    for q, k, v, site, kw in cap.calls:
        plain = {k2: v2 for k2, v2 in kw.items() if k2 != "random_key"}
        _, r = CA.attention_lamp(q, k, v, site, **dict(kw, reduce=False))
        _, s_ = CA.attention_lamp(q, k, v, site, **dict(plain, reduce=False))
        apart.append(int((r.n_selected != s_.n_selected).sum()))
    checks["random_arm_keyed"] = all(
        kw.get("random_key") is not None for *_, kw in cap.calls)
    del cap
    checks["every_value_finite"] = all(
        a["finite"] and all(np.isfinite(v) for k, v in a.items()
                            if k != "finite") for a in arms.values()) and \
        bool(torch.isfinite(ref).all())
    checks["uniform_selects_nothing"] = arms["uniform"]["recompute_rate"] == 0
    checks["lamp_and_random_rates_in_0_1"] = all(
        0 < arms[a]["recompute_rate"] < 1 for a in ("lamp", "random"))
    checks["kl_lamp_below_uniform"] = arms["lamp"]["kl"] < arms["uniform"]["kl"]
    checks["random_counts_equal_lamp_per_row"] = (
        len(apart) == cfg.n_layers and not any(apart))
    del ref
    # 3. card against CPU, 2 layers at seq 256
    cpu = paper_card_vs_cpu(cfg, params, tokens, checks)
    print(f"paper: {cfg.name} {cfg.n_layers} layers x {sc.batch} x {sc.seq}"
          f", mu 4 tau 0.1: KL "
          f"uniform {arms['uniform']['kl']:.3e}, LAMP {arms['lamp']['kl']:.3e}"
          f", random {arms['random']['kl']:.3e}; rate LAMP "
          f"{arms['lamp']['recompute_rate']:.4f}; ms a forward FP32 "
          f"{ref_ms:.1f}, LAMP {arms['lamp']['ms_per_forward']:.1f}; card vs "
          f"CPU logits {cpu['logit_max_abs_over_max']:.3g} (gate "
          f"{PAPER_LOGIT_REL:g}; controls "
          + ", ".join(f"{k} {v:.3g}" for k, v in
                      cpu["controls_against_cpu_lamp"].items()) + ")",
          flush=True)
    emit("paper", config=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         n_heads=cfg.n_heads, d_ff=cfg.d_ff, vocab=cfg.vocab, seq=sc.seq,
         batch=sc.batch, qk_gain=PF.QK_GAIN, site=PAPER_SITE,
         ref_ms_per_forward=ref_ms, arms=arms, bits=bits,
         random_rows_apart=apart, card_vs_cpu=cpu,
         seconds=time.perf_counter() - t0, checks=checks,
         ok=all(checks.values()))
    require(all(checks.values()), f"paper phase failed its checks: {checks}")


# The static KV-cache serving loop (phase static): runtime.serve_loop ->
# models.api -> each family's prefill / decode_step, plain PyTorch (the JAX
# path reaches no Pallas kernel). Each family at its published widths, the
# depth cut as printed; examples/serve_lamp.py's settings (4 prompts of 32
# tokens, 24 new, temperature 0.7, seed 7), LAMP off and on.
STATIC_MODELS = (
    ("gpt2-small", {}, "all 12 layers"),
    ("llava-next-mistral-7b", dict(n_layers=2), "2 of 32 layers"),
    ("hymba-1.5b", dict(n_layers=2), "2 of 32 layers"),
    ("rwkv6-7b", dict(n_layers=2), "2 of 32 layers"),
    ("whisper-medium", dict(n_layers=2, n_enc_layers=2),
     "2 of 24 encoder and 2 of 24 decoder layers"),
)
STATIC_BATCH, STATIC_PROMPT, STATIC_NEW, STATIC_SEED = 4, 32, 24, 7
# card against CPU in FP32 (LAMP off): phase paper's FP32 arm tolerance,
# of the largest logit (each device sums its FP32 products in its own order)
STATIC_FP32_REL = PAPER_FP32_REL
# the FP32 check: 2 prompts, prefill and 4 decode steps; rwkv6's prompt is
# 100 tokens (its chunked prefill then pads its second 64-token chunk)
STATIC_CHECK_BATCH, STATIC_CHECK_STEPS = 2, 4
STATIC_RWKV_PROMPT = 100
# hymba's full ring: one prompt of at least the window, so M + S > W and
# every decode step writes slot W - 1 (the reference's shift-free ring)
STATIC_RING_PROMPT, STATIC_RING_STEPS = 1040, 3
STATIC_KL_MAX = 0.5                 # tests/test_models_smoke.py:106
# the logits site's inputs are the FP32 forward's logits scaled as the JAX
# benchmark's logits-site job scales its own (benchmarks/paper_figs.py:168):
# a seeded model's logits spread ~1 wide, and unscaled no position's
# softmax is peaked enough for the strict rule (8) to select a logit
STATIC_SITE_SCALE = 4.0
# the profiled run: prefill and 3 decode steps
STATIC_PROFILE_NEW = 4


class LampCounter:
    """Wraps ``core.attention``'s three LAMP evaluators (the layers look
    them up on the module when called) and sums their selected and valid
    counts on the device: the recompute rate of whatever runs inside, read
    once, after it (a read per call would wait on the card each time)."""

    NAMES = ("attention_lamp", "chunked_attention_lamp",
             "decode_attention_lamp")

    def __enter__(self):
        from repro_torch.core import attention as CA
        self.CA, self.orig = CA, {n: getattr(CA, n) for n in self.NAMES}
        self.selected = self.valid = 0.0

        def counting(fn):
            def wrapped(*a, **kw):
                out, aux = fn(*a, **kw)
                self.selected = self.selected + aux.n_selected.sum()
                self.valid = self.valid + aux.n_valid.sum()
                return out, aux
            return wrapped
        for n, fn in self.orig.items():
            setattr(CA, n, counting(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.CA, n, fn)

    @property
    def rate(self) -> float:
        return float(self.selected) / max(float(self.valid), 1.0)


def static_greedy(cfg, params, batch, steps, tokens=None):
    """prefill + `steps` decode steps, LAMP off, on the batch's device:
    (logits of each call on the CPU (B, V), the tokens fed). Greedy on its
    own logits, or teacher-forced with `tokens` (B, steps)."""
    from repro_torch.models import api
    B = batch["tokens"].shape[0]
    dev = batch["tokens"].device
    cache = api.init_cache(
        cfg, B, batch["tokens"].shape[1] + steps + cfg.n_patches + 8,
        torch.float32, device=dev)
    with torch.no_grad():
        logits, cache = api.prefill(cfg, params, batch, cache, use_lamp=False)
        out, fed = [logits[:, -1].cpu()], []
        for i in range(steps):
            tok = (torch.argmax(out[-1], -1) if tokens is None
                   else tokens[:, i]).to(dev)[:, None]
            fed.append(tok.cpu())
            logits, cache = api.decode_step(cfg, params, cache, tok,
                                            use_lamp=False)
            out.append(logits[:, -1].cpu())
    return out, torch.cat(fed, dim=1)


def static_rel(card, cpu):
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(card, cpu))


def static_card_vs_cpu(cfg, seed, checks, tag):
    """The family in FP32 on the card and on the CPU (the same seeded
    weights), LAMP off: prefill and STATIC_CHECK_STEPS decode steps
    teacher-forced with the CPU's greedy tokens, logits within
    STATIC_FP32_REL of the largest; the card's own greedy stream through
    ``generate`` against the CPU's, a difference allowed only at a step
    whose CPU top-2 gap is below the gate; prefill(S - 1) + decode(1)
    against the card's teacher-forced forward. Returns the readings, the
    check batch and the CPU's prefill logits."""
    from repro_torch.core import tree as T
    from repro_torch.launch.serve_lamp import make_batch
    from repro_torch.models import api
    from repro_torch.runtime.serve_loop import ServeConfig, generate
    cfg32 = cfg.replace(dtype="float32")
    cpu_params = api.init_params(cfg32, seed, "cpu")
    params = T.map(lambda t: t.to(DEVICE), cpu_params)
    S = STATIC_RWKV_PROMPT if cfg.family == "rwkv6" else STATIC_PROMPT
    cpu_batch = make_batch(cfg, STATIC_CHECK_BATCH, S, "cpu", seed=seed + 1)
    batch = {k: v.to(DEVICE) for k, v in cpu_batch.items()}
    steps = STATIC_CHECK_STEPS
    want, fed = static_greedy(cfg32, cpu_params, cpu_batch, steps)
    got, _ = static_greedy(cfg32, params, batch, steps, tokens=fed)
    rel = static_rel(got, want)
    cpu_tokens = torch.cat([fed, torch.argmax(want[-1], -1)[:, None]], dim=1)
    with torch.no_grad():
        card_tokens = generate(cfg32, params, batch, ServeConfig(
            max_new_tokens=steps + 1, temperature=0.0, use_lamp=False,
            cache_len=S + steps + cfg.n_patches + cfg.n_meta_tokens + 8,
            seed=seed))["tokens"].cpu()
    greedy = {"equal": bool(torch.equal(card_tokens, cpu_tokens))}
    if not greedy["equal"]:
        apart = (card_tokens != cpu_tokens).any(dim=0).nonzero()
        step = int(apart[0])
        top = torch.topk(want[step], 2, dim=-1).values
        gap = float((top[:, 0] - top[:, 1]).min())
        greedy.update(first_step_apart=step, top2_gap=gap,
                      gate=STATIC_FP32_REL * float(want[step].abs().max()))
    checks[f"{tag}_fp32_logits_within_tol"] = rel <= STATIC_FP32_REL
    checks[f"{tag}_greedy_equal_or_near_tie"] = greedy["equal"] or \
        greedy["top2_gap"] < greedy["gate"]
    # prefill(S - 1) + decode(1) against the forward, on the card
    with torch.no_grad():
        full = api.forward_logits(cfg32, params, batch)
        pos = S - 1 + cfg.n_patches
        cache = api.init_cache(cfg32, STATIC_CHECK_BATCH,
                               S + cfg.n_patches + 8, torch.float32,
                               device=DEVICE)
        _, cache = api.prefill(cfg32, params,
                               dict(batch, tokens=batch["tokens"][:, :S - 1]),
                               cache, use_lamp=False)
        ld, _ = api.decode_step(cfg32, params, cache,
                                batch["tokens"][:, S - 1:], use_lamp=False)
    consistent = bool(torch.allclose(ld[:, 0], full[:, pos], rtol=2e-3,
                                     atol=2e-4))
    checks[f"{tag}_prefill_decode_equals_forward"] = consistent
    readings = {"prompt": S, "steps": steps, "logit_max_abs_over_max": rel,
                "greedy": greedy, "prefill_decode_vs_forward_max_abs": float(
                    (ld[:, 0] - full[:, pos]).abs().max())}
    if cfg.family == "rwkv6":
        readings["logits_site"] = static_logits_site(full, checks, tag)
    del full
    if cfg.family == "hymba":
        readings["full_ring"] = static_hymba_ring(cfg32, params, cpu_params,
                                                  seed, checks, tag)
    del params
    return readings, cpu_batch, want[0], cpu_params


def static_hymba_ring(cfg, params, cpu_params, seed, checks, tag):
    """One hymba prompt of STATIC_RING_PROMPT tokens (at least the window):
    the ring of W = window + M slots holds the last W of M + S positions,
    and every decode step writes slot W - 1; card against CPU, FP32."""
    from repro_torch.launch.serve_lamp import make_batch
    cpu_batch = make_batch(cfg, 1, STATIC_RING_PROMPT, "cpu", seed=seed + 2)
    batch = {k: v.to(DEVICE) for k, v in cpu_batch.items()}
    W = cfg.window + cfg.n_meta_tokens
    T = cfg.n_meta_tokens + STATIC_RING_PROMPT
    want, fed = static_greedy(cfg, cpu_params, cpu_batch, STATIC_RING_STEPS)
    got, _ = static_greedy(cfg, params, batch, STATIC_RING_STEPS, tokens=fed)
    rel = static_rel(got, want)
    checks[f"{tag}_full_ring_within_tol"] = T > W and rel <= STATIC_FP32_REL
    return {"prompt": STATIC_RING_PROMPT, "ring_slots": W, "positions": T,
            "logit_max_abs_over_max": rel}


def static_logits_site(logits, checks, tag):
    """``lamp_logits_softmax`` on the card and on the CPU on the same
    logits: the card's FP32 teacher-forced forward of the published-width
    model (2 x STATIC_RWKV_PROMPT positions over the 65,536-word
    vocabulary) times STATIC_SITE_SCALE, for mu 4 and 6 at tau 0.05 (the
    JAX benchmark's logits-site job): the strict rule's masks equal and
    the rates equal and above 0."""
    from repro_torch.core import lamp as LC
    from repro_torch.core.numerics import round_to_mantissa
    from repro_torch.runtime.serve_loop import lamp_logits_softmax
    logits = logits * STATIC_SITE_SCALE
    host = logits.cpu()
    site = {"positions": int(host.numel() // host.shape[-1]),
            "vocab": int(host.shape[-1]), "scale": STATIC_SITE_SCALE,
            "logit_max_abs": float(host.abs().max())}
    for mu in (4, 6):
        masks, rates = [], []
        for lg in (logits, host):
            masks.append(LC.select_softmax_strict(
                round_to_mantissa(lg, mu), 0.05).cpu())
            rates.append(float(lamp_logits_softmax(lg, mu, 0.05)[1]))
        site[f"mu{mu}"] = {"rate": rates[0], "rate_cpu": rates[1],
                           "selected": int(masks[0].sum()),
                           "mask_apart": int((masks[0] != masks[1]).sum())}
    checks[f"{tag}_logits_site_equal"] = all(
        site[m]["mask_apart"] == 0 and site[m]["rate"] == site[m]["rate_cpu"] > 0
        for m in ("mu4", "mu6"))
    return site


def static_profile(cfg, params, batch, serve, timed):
    """``generate`` once more for STATIC_PROFILE_NEW tokens (prefill and
    STATIC_PROFILE_NEW - 1 decode steps) under torch.profiler (device
    activity only: its cost grows with the events, and gpt2's LAMP arm
    launches about 17k kernels a step): the kernels' summed device time
    against the timed run's wall time for the same work (its prefill_s
    and as many decode steps at its rate; device idle share), the
    kernels launched, and the three that take the most device time.
    Printed, not gated."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.serve_loop import generate
    short = dataclasses.replace(serve, max_new_tokens=STATIC_PROFILE_NEW)
    unprofiled = 1e3 * (timed["prefill_s"] + STATIC_BATCH *
                        (STATIC_PROFILE_NEW - 1) / timed["decode_tok_per_s"])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        generate(cfg, params, batch, short)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    busy = sum(r[1] for r in rows)
    if busy <= 0:
        return {"device_busy_ms": "not measured"}
    return {"new_tokens": STATIC_PROFILE_NEW, "unprofiled_wall_ms": unprofiled,
            "device_busy_ms": busy, "idle_share": 1 - busy / unprofiled,
            "kernels": sum(r[2] for r in rows),
            "top": [{"name": k[:80], "device_ms": t, "calls": c}
                    for k, t, c in rows[:3]]}


def static_family(arch, overrides, cut, seed=0):
    """One family through ``serve_loop.generate`` on the card (the phase's
    comment above STATIC_MODELS), and its checks."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch.serve_lamp import make_batch
    from repro_torch.models import api
    from repro_torch.runtime.serve_loop import ServeConfig, generate
    t0 = time.perf_counter()
    cfg = get_config(arch).replace(**overrides)
    tag = cfg.family
    print(f"static: {arch} at its published widths (d {cfg.d_model}, "
          f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}), "
          f"{cut}, {cfg.dtype}", flush=True)
    checks = {}
    # card against CPU in FP32 first, while the card is empty
    fp32, check_batch, cpu_prefill, cpu_params = static_card_vs_cpu(
        cfg, seed, checks, tag)
    # the control reading: what a wrong path scores against the CPU's FP32
    # logits -- the config's own dtype, or LAMP on for an FP32 config
    params = api.init_params(cfg, seed, DEVICE)
    lamp_arm = cfg.dtype == "float32"
    ctl_batch = {k: v.to(DEVICE) for k, v in check_batch.items()}
    with torch.no_grad():
        cache = api.init_cache(
            cfg, STATIC_CHECK_BATCH,
            ctl_batch["tokens"].shape[1] + cfg.n_patches + 8, torch.float32,
            device=DEVICE)
        ctl, _ = api.prefill(cfg, params, ctl_batch, cache, use_lamp=lamp_arm)
    control = float((ctl[:, -1].float().cpu() - cpu_prefill).abs().max()
                    / cpu_prefill.abs().max())
    fp32["control"] = {"arm": "lamp_on" if lamp_arm else cfg.dtype,
                       "logit_max_abs_over_max": control}
    checks[f"{tag}_control_above_gate"] = control > STATIC_FP32_REL
    del cpu_params
    gc.collect()
    # the serve loop in the config's dtype, LAMP off and on
    batch = make_batch(cfg, STATIC_BATCH, STATIC_PROMPT, DEVICE, seed=seed)
    cache_len = STATIC_PROMPT + STATIC_NEW + cfg.n_patches + \
        cfg.n_meta_tokens + 8
    with torch.no_grad():
        generate(cfg, params, batch, ServeConfig(max_new_tokens=2,
                                                 cache_len=cache_len))  # warm-up
        arms, last = {}, {}
        for use_lamp in (False, True):
            serve = ServeConfig(max_new_tokens=STATIC_NEW, temperature=0.7,
                                seed=STATIC_SEED, use_lamp=use_lamp,
                                cache_len=cache_len)
            # the timed run counts nothing; a second run counts the rate
            torch.cuda.reset_peak_memory_stats()
            out = generate(cfg, params, batch, serve)
            mem = torch.cuda.max_memory_allocated()
            with LampCounter() as count:
                counted = generate(cfg, params, batch, serve)["tokens"]
            toks = out["tokens"]
            arm = "lamp" if use_lamp else "fp32"
            arms[arm] = {
                "prefill_s": out["prefill_s"],
                "decode_tok_per_s": out["decode_tok_per_s"],
                "profile": static_profile(cfg, params, batch, serve, out),
                "max_memory_allocated": mem,
                "recompute_rate": count.rate,
                "counted_run_tokens_equal": bool(torch.equal(counted, toks)),
                "tokens_ok": toks.shape == (STATIC_BATCH, STATIC_NEW)
                and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
                "first_tokens": toks[0, :8].tolist()}
            cache = api.init_cache(cfg, STATIC_BATCH, cache_len,
                                   torch.float32, device=DEVICE)
            last[arm] = api.prefill(cfg, params, batch, cache,
                                    use_lamp=use_lamp)[0][:, -1].float()
    p, q = (torch.softmax(last[a], -1) for a in ("fp32", "lamp"))
    kl = float(torch.mean(torch.sum(
        p * (torch.log(p + 1e-20) - torch.log(q + 1e-20)), -1)))
    checks[f"{tag}_tokens_ok"] = all(a["tokens_ok"] for a in arms.values())
    checks[f"{tag}_logits_finite"] = all(
        bool(torch.isfinite(v).all()) for v in last.values())
    checks[f"{tag}_kl_below_{STATIC_KL_MAX}"] = bool(np.isfinite(kl)) and \
        kl < STATIC_KL_MAX
    checks[f"{tag}_lamp_off_rate_0"] = arms["fp32"]["recompute_rate"] == 0
    if cfg.family == "rwkv6":
        checks[f"{tag}_lamp_rate_0"] = arms["lamp"]["recompute_rate"] == 0
    else:
        checks[f"{tag}_lamp_rate_in_0_1"] = \
            0 < arms["lamp"]["recompute_rate"] < 1
    print(f"static: {arch}: prefill {arms['fp32']['prefill_s']*1e3:.1f} / "
          f"{arms['lamp']['prefill_s']*1e3:.1f} ms, decode "
          f"{arms['fp32']['decode_tok_per_s']:.1f} / "
          f"{arms['lamp']['decode_tok_per_s']:.1f} tok/s (FP32 / LAMP), "
          f"rate {arms['lamp']['recompute_rate']:.4f}, KL {kl:.3e}; FP32 "
          f"card vs CPU {fp32['logit_max_abs_over_max']:.3g} (gate "
          f"{STATIC_FP32_REL:g}, control {control:.3g})", flush=True)
    for a in ("fp32", "lamp"):
        pr = arms[a]["profile"]
        if isinstance(pr["device_busy_ms"], float):
            print(f"static: {arch}: {a} arm, prefill + "
                  f"{STATIC_PROFILE_NEW - 1} decode steps profiled: device "
                  f"busy {pr['device_busy_ms']:.1f} of "
                  f"{pr['unprofiled_wall_ms']:.1f} ms unprofiled (idle "
                  f"{pr['idle_share']:.3f}), {pr['kernels']} kernels",
                  flush=True)
    if "logits_site" in fp32:
        site = fp32["logits_site"]
        print(f"static: {arch}: logits site on {site['positions']} x "
              f"{site['vocab']} logits x {site['scale']:g}: rate mu 4 "
              f"{site['mu4']['rate']:.4g} (CPU {site['mu4']['rate_cpu']:.4g}), "
              f"mu 6 {site['mu6']['rate']:.4g} (CPU "
              f"{site['mu6']['rate_cpu']:.4g}), masks apart "
              f"{site['mu4']['mask_apart']} / {site['mu6']['mask_apart']}",
              flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": arch, "cut": cut, "n_layers": cfg.n_layers,
            "n_enc_layers": cfg.n_enc_layers, "dtype": cfg.dtype,
            "arms": arms, "kl_lamp_vs_fp32": kl, "fp32_card_vs_cpu": fp32,
            "seconds": time.perf_counter() - t0}, checks


def phase_static():
    """The static KV-cache serving loop on every family (the comment
    above STATIC_MODELS; module docstring)."""
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"static: on {smi}", flush=True)
    families, checks = [], {}
    for arch, overrides, cut in STATIC_MODELS:
        row, c = static_family(arch, overrides, cut)
        families.append(row)
        checks.update(c)
    emit("static", card=smi, settings=dict(
        batch=STATIC_BATCH, prompt=STATIC_PROMPT, new_tokens=STATIC_NEW,
        temperature=0.7, seed=STATIC_SEED), fp32_gate=STATIC_FP32_REL,
        families=families, seconds=time.perf_counter() - t0, checks=checks,
        ok=all(checks.values()))
    require(all(checks.values()), f"static phase failed its checks: "
            f"{ {k: v for k, v in checks.items() if not v} }")


# --------------------------------------------------------------- train

TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 128
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
TRAIN_STEPS, TRAIN_RESUME_TO, TRAIN_CKPT_EVERY = 30, 40, 10
TRAIN_TIMED_STEPS = 5
# one FP32 step of the full-width model, card against CPU: both sum their
# products in their own orders (cuBLAS, TF32 off, against the CPU's BLAS),
# through 12 layers forward and back
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GNORM_RTOL = 1e-4
# the update (new params - old) of the whole model in the L2 norm: Adam's
# first step is lr * g / (|g| + eps), about lr * sign(g), so an entry whose
# gradient is within roundoff of 0 may move the other way on the other
# device; a per-entry bound does not hold, the norm over all entries does
TRAIN_UPDATE_REL = 1e-3
# the gradient of every leaf, and of every layer's slice of a block leaf,
# card against CPU in the relative L2 (read from the first step's Adam m,
# (1 - b1) x the clipped gradient): a layer the card's backward missed
# reads 1
TRAIN_GRAD_REL = 1e-3
# the loop's loss falls: the mean of the last 5 of 40 steps at least this
# many nats below the first step's. On the Markov stream over all 50,257
# words, at lr 3e-4, 40 steps learn no next-token structure: the loss
# falls from the random logits' spread towards a uniform guess (ln 50257
# = 10.825), by 0.117 nats (10.985 to 10.868); with no update it would
# not fall (the batches' spread is about 0.01). So this gate shows that
# the loop updates the model; the learning gate below, that what it
# learns needs the blocks' gradients
TRAIN_LOSS_DROP = 0.05
# learning shows: the Markov stream over 64 of the words (8 successors a
# word: ln 64 = 4.159 nats for a uniform guess over them, ln 8 = 2.079
# with every transition learnt), 8 x 256 tokens, lr 1e-3, LEARN_STEPS
# steps from the seeded weights. The mean loss of the last 5 must be
# below LEARN_LOSS_MAX, and the control's, the same run with the blocks'
# gradients dropped (the backward reaching the embedding and the final
# norm alone), above it. The card read 2.410 and 3.313 (PERF.md section
# 6, PR 29 call 14): the limit halves the gap
LEARN_VOCAB, LEARN_BATCH, LEARN_SEQ, LEARN_LR, LEARN_STEPS = 64, 8, 256, 1e-3, 60
LEARN_LOSS_MAX = 2.85
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 2, 64, 3
# the bfloat16 model's step-1 loss and forward logits against the FP32
# forward of the same weights, each limit between the sound reading and a
# control read in the same run (the MoE output dropped: every layer's
# experts' we_out zeroed, or the last layer's alone). At random init the
# loss is mostly the unembedding's, so it moves little: 5.1e-4 sound
# against 2.5e-3 with every layer's experts dropped (and 2.6e-4, under the
# sound reading, with the last layer's alone); the logits' relative L2
# sees both: 0.070 sound (bfloat16 roundings and the router choices near a
# tie that they flip), 0.41 and 0.198 dropped (PERF.md section 6, PR 29
# call 14)
MOE_TRAIN_LOSS_RTOL = 1.2e-3
MOE_TRAIN_LOGIT_REL = 0.12


def kernel_launches():
    """Every hand-written kernel wrapper's launch count."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.launch import kernels_micro as KM
    return {"paged_mixed_attention": PA._wrapper.launches,
            **{n: w.launches for n, w in KM.WRAPPERS.items()}}


def train_card_vs_cpu(cfg, checks):
    """One make_train_step step of the full-width model on the card and on
    the CPU, from the same seeded weights and batch."""
    from repro_torch.core import tree as T
    from repro_torch.data.synthetic import DataConfig, SyntheticDataset
    from repro_torch.launch import steps as ST
    from repro_torch.models import api
    from repro_torch.optim import adamw
    opt_cfg = adamw.AdamWConfig()
    step = ST.make_train_step(cfg, opt_cfg)
    tokens = torch.from_numpy(SyntheticDataset(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_CHECK_SEQ,
        global_batch=TRAIN_CHECK_BATCH)).batch_at(0)["tokens"])
    p0 = api.init_params(cfg, 0, device="cpu")
    t0 = time.perf_counter()
    cpu_p, cpu_o, cpu_m = step(p0, adamw.init_state(p0), {"tokens": tokens})
    cpu_s = time.perf_counter() - t0
    card_p0 = T.map(lambda t: t.to(DEVICE), p0)
    card_p, card_o, card_m = step(card_p0, adamw.init_state(card_p0),
                                  {"tokens": tokens.to(DEVICE)})
    del card_p0
    num = den = 0.0
    worst_leaf, max_entry = 0.0, 0.0
    for a, c, b in zip(T.leaves(card_p), T.leaves(cpu_p), T.leaves(p0)):
        d = a.cpu().double() - c.double()
        u = c.double() - b.double()
        num += float(torch.sum(d * d))
        den += float(torch.sum(u * u))
        worst_leaf = max(worst_leaf, float(torch.linalg.norm(d))
                         / max(float(torch.linalg.norm(u)), 1e-30))
        max_entry = max(max_entry, float(torch.max(torch.abs(d))))
    # each leaf's gradient, and each layer's slice of a block leaf
    grad_rel, grad_zero = {}, []
    for (path, a), c in zip(T.flatten_with_path(card_o.m), T.leaves(cpu_o.m)):
        a = a.cpu().double()
        c = c.double()
        slices = ([(f"{'/'.join(path)}[{l}]", a[l], c[l])
                   for l in range(cfg.n_layers)] if path[0] == "blocks"
                  else [("/".join(path), a, c)])
        for name, x, y in slices:
            ny = float(torch.linalg.norm(y))
            if ny == 0.0:
                grad_zero.append(name)
            grad_rel[name] = float(torch.linalg.norm(x - y)) / max(ny, 1e-30)
    worst_grad = max(grad_rel, key=grad_rel.get)
    checks["train_step_grads"] = grad_rel[worst_grad] <= TRAIN_GRAD_REL
    checks["train_step_grads_nonzero"] = not grad_zero
    rel = {k: abs(float(card_m[k]) - float(cpu_m[k])) / abs(float(cpu_m[k]))
           for k in ("loss", "grad_norm")}
    update_rel = (num / den) ** 0.5
    checks["train_step_loss"] = rel["loss"] <= TRAIN_LOSS_RTOL
    checks["train_step_grad_norm"] = rel["grad_norm"] <= TRAIN_GNORM_RTOL
    checks["train_step_update"] = update_rel <= TRAIN_UPDATE_REL
    # no entry moves further apart than a sign flip of one Adam step
    checks["train_step_entries"] = max_entry <= 2.0 * opt_cfg.lr * (1 + 1e-3)
    checks["train_step_state"] = int(card_o.step) == 1
    return {"loss_card": float(card_m["loss"]), "loss_cpu": float(cpu_m["loss"]),
            "loss_rel": rel["loss"], "grad_norm_card": float(card_m["grad_norm"]),
            "grad_norm_rel": rel["grad_norm"], "update_rel": update_rel,
            "update_rel_worst_leaf": worst_leaf, "max_entry_apart": max_entry,
            "grad_rel_worst": [worst_grad, grad_rel[worst_grad]],
            "grad_slices": len(grad_rel), "grad_zero": grad_zero,
            "cpu_step_s": cpu_s}


def train_loop_on_card(cfg, checks):
    """runtime.train on the card, checkpointed, resumed; then timed steps."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import tree as T
    from repro_torch.data.synthetic import DataConfig, SyntheticDataset
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import TrainLoopConfig, train
    mesh = make_host_mesh()
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH)
    with tempfile.TemporaryDirectory() as ckpt:
        loop = TrainLoopConfig(total_steps=TRAIN_STEPS,
                               checkpoint_every=TRAIN_CKPT_EVERY,
                               log_every=TRAIN_CKPT_EVERY, checkpoint_dir=ckpt)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = train(cfg, mesh, loop, data_cfg=data_cfg)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        second = train(cfg, mesh, dataclasses.replace(
            loop, total_steps=TRAIN_RESUME_TO), data_cfg=data_cfg)
        second_s = time.perf_counter() - t0
        max_mem = torch.cuda.max_memory_allocated()
        mgr = CheckpointManager(ckpt)
        kept = sorted(p for p in os.listdir(ckpt) if p.startswith("step_"))
        saved = SH.gather({"params": first["params"], "opt": first["opt"]})
        back = mgr.restore(saved, step=TRAIN_STEPS - 1)
        checks["train_restore_bit_for_bit"] = all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(T.leaves(back), T.leaves(saved)))
        del back, saved, first["params"], first["opt"]
    losses = [m["loss"] for m in first["metrics"] + second["metrics"]]
    checks["train_steps_run"] = (len(first["metrics"]) == TRAIN_STEPS and
                                 len(second["metrics"]) ==
                                 TRAIN_RESUME_TO - TRAIN_STEPS)
    checks["train_losses_finite"] = all(np.isfinite(losses))
    last5 = float(np.mean(losses[-5:]))
    checks["train_loss_falls"] = last5 <= losses[0] - TRAIN_LOSS_DROP
    sp, so = second["params"], second["opt"]
    params, opt = SH.gather(sp), SH.gather(so)
    del second
    checks["train_opt_step"] = int(opt.step) == TRAIN_RESUME_TO
    # TRAIN_TIMED_STEPS more steps of the step the loop runs (DTensor state
    # on the one-rank mesh), each beside a make_train_step step on whole
    # tensors from the same state and batch; each timed to its end
    opt_cfg = adamw.AdamWConfig()
    sharded = ST.make_sharded_train_step(cfg, opt_cfg, mesh)
    plain = ST.make_train_step(cfg, opt_cfg)
    data = SyntheticDataset(data_cfg)
    times = {"sharded": [], "plain": []}
    same = True

    def timed(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
        return out
    for i in range(TRAIN_TIMED_STEPS):
        batch = {"tokens": torch.from_numpy(
            data.batch_at(TRAIN_RESUME_TO + i)["tokens"]).to(DEVICE)}
        sp, so, m_sharded = timed("sharded", sharded, sp, so, batch)
        params, opt, m_plain = timed("plain", plain, params, opt, batch)
        same = same and all(torch.equal(m_sharded[k], m_plain[k])
                            for k in m_plain)
    same = same and all(torch.equal(a, b) for a, b in zip(
        T.leaves(SH.gather({"p": sp, "o": so})),
        T.leaves({"p": params, "o": opt})))
    checks["train_sharded_step_bit_equal"] = same
    ms = statistics.median(times["sharded"]) * 1e3
    plain_ms = statistics.median(times["plain"]) * 1e3
    return {"losses": losses, "first_loss": losses[0], "last5_mean": last5,
            "drop": losses[0] - last5, "checkpoints_kept": kept,
            "first_run_s": first_s, "resumed_run_s": second_s,
            "loop_ms_per_step": 1e3 * (first_s + second_s) / TRAIN_RESUME_TO,
            "ms_per_step": ms,
            "step_ms_all": [t * 1e3 for t in times["sharded"]],
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
            "make_train_step_ms": plain_ms,
            "make_train_step_ms_all": [t * 1e3 for t in times["plain"]],
            "sharded_minus_plain_ms": ms - plain_ms,
            "sharded_bit_equal_plain": same,
            "max_memory_allocated": max_mem}


def train_learning_on_card(cfg, checks):
    """The learning gate (LEARN_* above): make_train_step's run and its
    control, the blocks' gradients dropped, on the 64-word Markov stream."""
    from repro_torch.core import tree as T
    from repro_torch.data.synthetic import DataConfig, SyntheticDataset
    from repro_torch.launch import steps as ST
    from repro_torch.models import api
    from repro_torch.optim import adamw
    opt_cfg = adamw.AdamWConfig(lr=LEARN_LR)
    data = SyntheticDataset(DataConfig(vocab=LEARN_VOCAB, seq_len=LEARN_SEQ,
                                       global_batch=LEARN_BATCH))
    batches = [{"tokens": torch.from_numpy(data.batch_at(i)["tokens"])
                .to(DEVICE)} for i in range(LEARN_STEPS)]
    step = ST.make_train_step(cfg, opt_cfg)

    def control_step(params, opt, batch):
        (loss, _), grads = ST.value_and_grad(
            lambda p, b: api.loss_fn(cfg, p, b), params, batch)
        grads["blocks"] = T.map(torch.zeros_like, grads["blocks"])
        params, opt, m = adamw.apply_updates(opt_cfg, params, grads, opt)
        return params, opt, {"loss": loss, **m}

    out = {}
    for name, fn in (("sound", step), ("blocks_gradient_dropped",
                                       control_step)):
        params = api.init_params(cfg, 0, device=DEVICE)
        opt = adamw.init_state(params)
        losses = []
        for b in batches:
            params, opt, m = fn(params, opt, b)
            losses.append(float(m["loss"]))
        del params, opt
        out[name] = {"first": losses[0], "last5_mean":
                     float(np.mean(losses[-5:])), "every_10": losses[::10]}
    checks["train_learns"] = out["sound"]["last5_mean"] <= LEARN_LOSS_MAX
    checks["train_learns_control"] = \
        out["blocks_gradient_dropped"]["last5_mean"] > LEARN_LOSS_MAX
    return out


def train_moe_on_card(checks):
    """The MoE family's backward and AdamW's bfloat16 cast on the card."""
    import gc
    from repro_torch.core import tree as T
    from repro_torch.data.synthetic import DataConfig, SyntheticDataset
    from repro_torch.launch import steps as ST
    from repro_torch.models import api
    from repro_torch.optim import adamw
    cfg = moe_2_layers()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, 0, device=DEVICE)
    init_s = time.perf_counter() - t0
    data = SyntheticDataset(DataConfig(vocab=cfg.vocab, seq_len=MOE_TRAIN_SEQ,
                                       global_batch=MOE_TRAIN_BATCH))
    batches = [{"tokens": torch.from_numpy(data.batch_at(i)["tokens"])
                .to(DEVICE)} for i in range(MOE_TRAIN_STEPS)]
    cfg32 = cfg.replace(dtype="float32")
    with torch.no_grad():
        p32 = T.map(lambda t: t.float(), params)
        loss32, _ = api.loss_fn(cfg32, p32, batches[0], remat=False)
        loss32 = float(loss32)
        logits32 = api.forward_logits(cfg32, p32, batches[0]).float()
        del p32

        def reading():
            loss, _ = api.loss_fn(cfg, params, batches[0], remat=False)
            lg = api.forward_logits(cfg, params, batches[0]).float()
            return (abs(float(loss) - loss32) / abs(loss32),
                    float(torch.linalg.norm(lg - logits32)
                          / torch.linalg.norm(logits32)))
        sound = reading()
        # the controls: the MoE output dropped, in every layer and in the
        # last alone, then the weights put back
        we_out = params["blocks"]["moe"]["we_out"]
        controls = {}
        for name, rows in (("all_layers_experts_dropped", slice(None)),
                           ("last_layer_experts_dropped", slice(-1, None))):
            keep = we_out[rows].clone()
            we_out[rows] = 0
            controls[name] = reading()
            we_out[rows] = keep
            del keep
        del logits32
    (loss1, _), grads = ST.value_and_grad(
        lambda p, b: api.loss_fn(cfg, p, b), params, batches[0])
    checks["moe_train_grads_finite"] = all(
        bool(torch.isfinite(g).all()) for g in T.leaves(grads))
    checks["moe_train_grad_dtypes"] = all(
        g.dtype == p.dtype for g, p in zip(T.leaves(grads), T.leaves(params)))
    router = grads["blocks"]["moe"]["router"]
    router_norms = [float(torch.linalg.norm(router[l]))
                    for l in range(cfg.n_layers)]
    checks["moe_train_router_grad"] = all(n > 0 for n in router_norms)
    del grads
    step = ST.make_train_step(cfg, adamw.AdamWConfig())
    opt = adamw.init_state(params)
    losses, gnorms, times = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        times.append(time.perf_counter() - t0)
    rel = abs(losses[0] - loss32) / abs(loss32)
    checks["moe_train_losses_finite"] = all(np.isfinite(losses + gnorms))
    checks["moe_train_loss_vs_fp32"] = rel <= MOE_TRAIN_LOSS_RTOL
    checks["moe_train_logits_vs_fp32"] = sound[1] <= MOE_TRAIN_LOGIT_REL
    # the gates tell the controls from the sound model
    checks["moe_train_loss_control"] = \
        controls["all_layers_experts_dropped"][0] > MOE_TRAIN_LOSS_RTOL
    checks["moe_train_logits_control"] = all(
        c[1] > MOE_TRAIN_LOGIT_REL for c in controls.values())
    checks["moe_train_params"] = all(
        bool(torch.isfinite(p.float()).all()) for p in T.leaves(params)) and \
        params["blocks"]["moe"]["router"].dtype == torch.float32 and \
        params["blocks"]["moe"]["we_in"].dtype == torch.bfloat16
    n_params = sum(p.numel() for p in T.leaves(params))
    out = {"config": cfg.name, "dtype": cfg.dtype, "n_params": n_params,
           "params_init_s": init_s, "loss_fp32": loss32,
           "loss_value_and_grad": float(loss1), "losses": losses,
           "grad_norms": gnorms, "loss_rel_fp32": rel,
           "logit_rel_fp32": sound[1], "forward_loss_rel_fp32": sound[0],
           "controls": {k: {"loss_rel_fp32": v[0], "logit_rel_fp32": v[1]}
                        for k, v in controls.items()},
           "router_grad_norms": router_norms,
           "step_ms": [t * 1e3 for t in times],
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del params, opt
    return out


def phase_train():
    """Training on the card (module docstring)."""
    import gc
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    gc.collect()
    torch.cuda.empty_cache()
    before = kernel_launches()
    checks = {}
    cfg = gpt2_small()
    step = train_card_vs_cpu(cfg, checks)
    emit("train_step", card=smi, config=cfg.name, batch=TRAIN_CHECK_BATCH,
         seq=TRAIN_CHECK_SEQ, gates=dict(loss_rtol=TRAIN_LOSS_RTOL,
                                         grad_norm_rtol=TRAIN_GNORM_RTOL,
                                         update_rel=TRAIN_UPDATE_REL,
                                         grad_rel=TRAIN_GRAD_REL), **step)
    gc.collect()
    torch.cuda.empty_cache()
    loop = train_loop_on_card(cfg, checks)
    print(f"train: gpt2-small {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"{loop['ms_per_step']:.1f} ms a step on the one-rank mesh "
          f"(make_train_step {loop['make_train_step_ms']:.1f} ms), "
          f"{loop['tokens_per_s']:.0f} tokens/s, max_memory_allocated "
          f"{loop['max_memory_allocated'] / 2**30:.2f} GiB on {smi}",
          flush=True)
    emit("train_loop", card=smi, config=cfg.name, batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, steps=TRAIN_STEPS, resumed_to=TRAIN_RESUME_TO,
         loss_drop_gate=TRAIN_LOSS_DROP, **loop)
    gc.collect()
    torch.cuda.empty_cache()
    learn = train_learning_on_card(cfg, checks)
    emit("train_learn", card=smi, config=cfg.name, vocab=LEARN_VOCAB,
         batch=LEARN_BATCH, seq=LEARN_SEQ, lr=LEARN_LR, steps=LEARN_STEPS,
         loss_max_gate=LEARN_LOSS_MAX, **learn)
    gc.collect()
    torch.cuda.empty_cache()
    moe = train_moe_on_card(checks)
    emit("train_moe", card=smi, batch=MOE_TRAIN_BATCH, seq=MOE_TRAIN_SEQ,
         loss_rtol_gate=MOE_TRAIN_LOSS_RTOL,
         logit_rel_gate=MOE_TRAIN_LOGIT_REL, **moe)
    after = kernel_launches()
    checks["train_no_kernel_launch"] = after == before
    emit("train", card=smi, launches_before=before, launches_after=after,
         seconds=time.perf_counter() - t0, checks=checks,
         ok=all(checks.values()))
    require(all(checks.values()), f"train phase failed its checks: "
            f"{ {k: v for k, v in checks.items() if not v} }")


# --------------------------------------------------------------- distributed

# sp_decode_attention at glm4-9b's published attention widths (32 heads on
# 2 KV heads, hd 128) over a bfloat16 cache of 32,768 positions, 8 rows;
# lengths at the edges of 4 ranks' 8192-position slices, a full row and a
# 1-key row
DIST_SP = dict(B=8, H=32, Hkv=2, D=128, S=32768)
DIST_SP_LENGTHS = [32768, 32767, 1, 8192, 8193, 20000, 24576, 12345]
DIST_SP_MU, DIST_SP_TAU = 7, 0.05
# card against CPU, the same code on as many ranks: FP32 products and sums
# in other orders over up to 32,768 keys (q and p rounded to bfloat16
# alike); the relaxed rule at mu 7 may flip a key whose logit the two
# orders put on either side of a PS(7) rounding edge, which moves its row's
# output by far less than a bfloat16 step
DIST_SP_ATOL = 1e-4
# 4 ranks against 1, entry by entry: each rank rounds p = exp(y - m) to the
# cache's bfloat16 against its own slice's max m before P.V (as the JAX
# package's p.astype(v.dtype) does), one rank against the whole row's, so
# each weight rounds within 2^-9 of p_i either way: entry d of a row's
# output moves at most 2^-8 sum_i p_i |v_id| / l, plus the FP32 sums'
# other orders (2^-16 of the same)
DIST_SP_SHARD_REL = 2.0 ** -8 + 2.0 ** -16
DIST_RANKS = 4
DIST_MOE_TOKENS = (8, 128)
DIST_TRAIN_STEPS = 3
DIST_SEED = 11


def sp_inputs():
    """q (FP32), the bfloat16 caches and the lengths, drawn on the card
    from a seeded generator (the same in every process on the card)."""
    g = torch.Generator(device=DEVICE).manual_seed(DIST_SEED)
    B, H, Hkv, D, S = (DIST_SP[k] for k in ("B", "H", "Hkv", "D", "S"))
    q = torch.randn((B, H, 1, D), generator=g, device=DEVICE)
    k = torch.randn((B, Hkv, S, D), generator=g, device=DEVICE).to(torch.bfloat16)
    v = torch.randn((B, Hkv, S, D), generator=g, device=DEVICE).to(torch.bfloat16)
    length = torch.tensor(DIST_SP_LENGTHS, dtype=torch.int32, device=DEVICE)
    return q, k, v, length


def sp_plain(q, k, v, length, mu, tau, lamp):
    """sp_decode_attention's arithmetic on one rank over whole rows: (keys
    the relaxed rule selects (0 with lamp off), valid keys, the bound's
    scale sum_i p_i |v_i| / l (B, H, 1, D), p unrounded)."""
    from repro_torch.core.numerics import round_to_mantissa
    B, H, _, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qg = (q.float() * D ** -0.5).reshape(B, Hkv, H // Hkv, D)
    y = torch.einsum("bhgd,bhkd->bhgk", qg.to(k.dtype).float(), k.float())
    ok = torch.arange(S, device=q.device)[None, None, None, :] < \
        length[:, None, None, None]
    neg = torch.tensor(-1e30, device=q.device)
    sel = torch.zeros_like(y, dtype=torch.bool)
    if lamp:
        y_low = round_to_mantissa(y, mu)
        s = torch.where(ok, y_low + torch.log(torch.abs(y_low)), neg)
        log_tau = torch.log(torch.tensor(max(tau, 1e-30), device=q.device))
        sel = ok & (s > log_tau + torch.amax(s, dim=-1, keepdim=True))
        y = torch.where(sel, y, y_low)
    p = torch.softmax(torch.where(ok, y, neg), dim=-1)
    scale = torch.einsum("bhgk,bhkd->bhgd", p, torch.abs(v.float()))
    return (int(sel.sum()), int(ok.expand_as(y).sum()),
            scale.reshape(B, H, 1, D))


def moe_layer_inputs(cfg):
    """One qwen3-moe layer's router (FP32), experts (bfloat16) and an
    8 x 128 token batch, drawn on the card from a seeded generator."""
    g = torch.Generator(device=DEVICE).manual_seed(DIST_SEED + 1)
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def normal(shape, scale, dtype):
        return (torch.randn(shape, generator=g, device=DEVICE) * scale).to(dtype)
    p = {"router": normal((d, E), d ** -0.5, torch.float32),
         "we_in": normal((E, d, 2 * ff), d ** -0.5, torch.bfloat16),
         "we_out": normal((E, ff, d), ff ** -0.5, torch.bfloat16)}
    x = normal(DIST_MOE_TOKENS + (d,), 1.0, torch.bfloat16)
    return p, x


def grad_tree(seed):
    """A gradient-sized tree: gpt2-small's parameter shapes, FP32 normal
    values from a seeded generator on the card."""
    from repro_torch.core import tree as T
    from repro_torch.models import api
    with torch.device("meta"):
        like = api.init_params(gpt2_small(), 0, device="meta")
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return T.map(lambda t: torch.randn(t.shape, generator=g, device=DEVICE)
                 * 1e-3, like)


def moe_gates(y, ref):
    rel = float(torch.linalg.norm(y.float() - ref.float())
                / torch.linalg.norm(ref.float()))
    mx = float(torch.max(torch.abs(y.float() - ref.float()))
               / torch.max(torch.abs(ref.float())))
    return rel, mx, rel <= MOE_REL_L2 and mx <= MOE_MAX_ABS_OF_MAX


def dist_one_rank(checks):
    """(a): a one-rank NCCL mesh of this process on the card."""
    from repro_torch.core import tree as T
    from repro_torch.data.synthetic import DataConfig, SyntheticDataset
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.models.moe import moe_apply, moe_apply_ep
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import TrainLoopConfig, train
    mesh = make_host_mesh()
    out = {"mesh": dict(SH.axis_sizes(mesh)),
           "backend": torch.distributed.get_backend()}
    # train on the host mesh against make_train_step's steps, same seed
    cfg = gpt2_small()
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_CHECK_SEQ,
                          global_batch=TRAIN_CHECK_BATCH)
    data = SyntheticDataset(data_cfg)
    step = ST.make_train_step(cfg, adamw.AdamWConfig())
    params = api.init_params(cfg, 0, device=DEVICE)
    opt = adamw.init_state(params)
    ref = []
    for i in range(DIST_TRAIN_STEPS):
        params, opt, m = step(params, opt, {"tokens": torch.from_numpy(
            data.batch_at(i)["tokens"]).to(DEVICE)})
        ref.append([float(m["loss"]), float(m["grad_norm"])])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ck:
        res = train(cfg, mesh, TrainLoopConfig(
            total_steps=DIST_TRAIN_STEPS, checkpoint_every=100,
            log_every=100, checkpoint_dir=ck), data_cfg=data_cfg)
    train_s = time.perf_counter() - t0
    got = [[m["loss"], m["grad_norm"]] for m in res["metrics"]]
    full = SH.gather({"p": res["params"], "o": res["opt"]})
    checks["dist_train_metrics_bit_equal"] = got == ref
    checks["dist_train_state_bit_equal"] = all(
        torch.equal(a, b) for a, b in zip(T.leaves(full),
                                          T.leaves({"p": params, "o": opt})))
    out["train"] = {"config": cfg.name, "batch": TRAIN_CHECK_BATCH,
                    "seq": TRAIN_CHECK_SEQ, "mesh_run": got, "no_mesh": ref,
                    "loop_s": train_s}
    del params, opt, full, res
    # sp_decode_attention, card against CPU
    q, k, v, length = sp_inputs()
    sp = {}
    for lamp in (False, True):
        kw = dict(mu=DIST_SP_MU if lamp else 23, tau=DIST_SP_TAU, lamp=lamp)
        card = C.sp_decode_attention(mesh, q, k, v, length, **kw)
        cpu = C.sp_decode_attention(mesh, q.cpu(), k.cpu(), v.cpu(),
                                    length.cpu(), **kw)
        err = float(torch.max(torch.abs(card.cpu() - cpu)))
        ms = time_call(lambda: C.sp_decode_attention(mesh, q, k, v, length,
                                                     **kw))
        row = {"max_abs_err": err, "max_abs": float(torch.max(torch.abs(cpu))),
               "ms": ms, "finite": bool(torch.isfinite(card).all())}
        sel, row["valid"], scale = sp_plain(q, k, v, length, DIST_SP_MU,
                                            DIST_SP_TAU, lamp)
        if lamp:
            row["selected_card"] = sel
            row["selected_cpu"] = sp_plain(
                q.cpu(), k.cpu(), v.cpu(), length.cpu(), DIST_SP_MU,
                DIST_SP_TAU, lamp)[0]
        sp["lamp" if lamp else "exact"] = row
        out.setdefault("sp_out", {})["lamp" if lamp else "exact"] = card.cpu()
        out.setdefault("sp_scale", {})["lamp" if lamp else "exact"] = \
            scale.cpu()
        del scale
        checks[f"dist_sp_card_vs_cpu_{'lamp' if lamp else 'exact'}"] = \
            row["finite"] and err <= DIST_SP_ATOL
    checks["dist_sp_lamp_moves"] = float(torch.max(torch.abs(
        out["sp_out"]["lamp"] - out["sp_out"]["exact"]))) > 0
    out["sp"] = sp
    del q, k, v
    # moe_apply_ep (all 128 experts on the one rank) and quantized_psum
    mcfg = moe_2_layers()
    p, x = moe_layer_inputs(mcfg)
    site = mcfg.lamp.router
    y_ep, met = moe_apply_ep(mcfg, p, x, lamp_site=site, mesh=mesh)
    y_ref, _ = moe_apply(mcfg, p, x, lamp_site=site, dropless=True)
    rel, mx, ok = moe_gates(y_ep, y_ref)
    kept = float(met["kept_frac"])
    checks["dist_moe_ep_one_rank"] = ok and kept == 1.0
    out["moe"] = {"kept_frac": kept, "rel_l2_vs_moe_apply": rel,
                  "max_abs_of_max_vs_moe_apply": mx}
    del p, x, y_ep, y_ref
    tree = grad_tree(DIST_SEED + 2)
    got = C.quantized_psum(mesh, tree)
    # half a quantization step of the largest leaf's scale, plus the
    # roundings of g / scale and of q x scale (one FP32 step of max|g|)
    top = max(float(torch.max(torch.abs(t))) for t in T.leaves(tree))
    bound = top / 254 + top * 2.0 ** -23
    worst = max(float(torch.max(torch.abs(a - b))) for a, b in
                zip(T.leaves(got), T.leaves(tree)))
    checks["dist_psum_one_rank"] = worst <= bound
    out["psum"] = {"max_abs_err": worst, "half_step": bound,
                   "n_values": sum(t.numel() for t in T.leaves(tree))}
    return out


def _host_s(fn):
    """Wall seconds of fn() on the host clock, the card synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def dist_rank(rank, tmp):
    """(b): one of DIST_RANKS processes sharing the card over gloo."""
    import datetime
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.core import tree as T
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.moe import moe_apply, moe_apply_ep
    torch.cuda.set_device(0)
    torch.set_num_threads(2)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), DIST_RANKS),
        rank=rank, world_size=DIST_RANKS,
        timeout=datetime.timedelta(seconds=240))
    res = {"rank": rank, "host_s": {}}
    card = init_device_mesh("cuda", (1, DIST_RANKS),
                            mesh_dim_names=("data", "model"))
    cpu = init_device_mesh("cpu", (1, DIST_RANKS),
                           mesh_dim_names=("data", "model"))

    # sp_decode_attention, this rank's 8192 positions
    q, k, v, length = sp_inputs()
    S_l = k.shape[2] // DIST_RANKS

    def cols(r):
        return slice(r * S_l, (r + 1) * S_l)
    k_l = k[:, :, cols(rank)].contiguous()
    v_l = v[:, :, cols(rank)].contiguous()
    for lamp in (False, True):
        kw = dict(mu=DIST_SP_MU if lamp else 23, tau=DIST_SP_TAU, lamp=lamp)
        tag = "lamp" if lamp else "exact"
        o, s = _host_s(lambda: C.sp_decode_attention(card, q, k_l, v_l,
                                                     length, **kw))
        res[f"sp_card_{tag}"] = o.cpu()
        res["host_s"][f"sp_{tag}"] = s
        res[f"sp_cpu_{tag}"] = C.sp_decode_attention(
            cpu, q.cpu(), k_l.cpu(), v_l.cpu(), length.cpu(), **kw)
    # the controls: each rank's slice at the next rank's positions (a
    # wrong pos offset), and the last rank's slice dropped from the
    # combine (its rows' lengths 0)
    nxt = cols((rank + 1) % DIST_RANKS)
    res["sp_control_pos_offset"] = C.sp_decode_attention(
        card, q, k[:, :, nxt].contiguous(), v[:, :, nxt].contiguous(),
        length).cpu()
    res["sp_control_slice_dropped"] = C.sp_decode_attention(
        card, q, k_l, v_l,
        length if rank < DIST_RANKS - 1 else torch.zeros_like(length)).cpu()
    del q, k, v, k_l, v_l

    # moe_apply_ep, 32 of the 128 experts a rank
    mcfg = moe_2_layers()
    p, x = moe_layer_inputs(mcfg)
    site = mcfg.lamp.router
    if rank == 0:
        res["moe_ref"] = moe_apply(mcfg, p, x, lamp_site=site,
                                   dropless=True)[0].cpu()
    specs = SH.param_specs({"moe": p}, card)["moe"]
    placed = SH.distribute(p, specs, card)
    del p
    torch.cuda.empty_cache()
    (y, met), s = _host_s(lambda: moe_apply_ep(mcfg, placed, x,
                                               lamp_site=site, mesh=card))
    res["moe_card"] = y.cpu()
    res["moe_kept"] = float(met["kept_frac"])
    res["host_s"]["moe"] = s
    local = {k: (DTensor.from_local(
        t.to_local().cpu(), cpu, [Replicate(), Shard(0)], run_check=False,
        shape=t.shape, stride=t.stride()) if k != "router"
        else t.full_tensor().cpu()) for k, t in placed.items()}
    res["moe_cpu"] = moe_apply_ep(mcfg, local, x.cpu(), lamp_site=site,
                                  mesh=cpu)[0]
    del placed, local, x, y

    # quantized_psum of a gradient-sized tree a rank
    dmesh = init_device_mesh("cuda", (DIST_RANKS,), mesh_dim_names=("data",))
    dcpu = init_device_mesh("cpu", (DIST_RANKS,), mesh_dim_names=("data",))
    tree = grad_tree(DIST_SEED + 3 + rank)
    got, s = _host_s(lambda: C.quantized_psum(dmesh, tree))
    res["host_s"]["psum"] = s
    want = C.quantized_psum(dcpu, T.map(lambda t: t.cpu(), tree))
    res["psum_bit_equal"] = all(torch.equal(a.cpu(), b) for a, b in
                                zip(T.leaves(got), T.leaves(want)))
    res["psum_values"] = sum(t.numel() for t in T.leaves(tree))

    res["launches"] = kernel_launches()
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def phase_distributed():
    """Distribution over torch.distributed (module docstring)."""
    import gc
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    gc.collect()
    torch.cuda.empty_cache()
    before = kernel_launches()
    checks = {}
    one = dist_one_rank(checks)
    sp_one, sp_scale = one.pop("sp_out"), one.pop("sp_scale")
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    # an exception in any rank ends the spawn, and so the phase
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(dist_rank, args=(tmp,), nprocs=DIST_RANKS)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(DIST_RANKS)]
    spawn_s = time.perf_counter() - t1
    r0 = ranks[0]
    four = {"mesh": {"data": 1, "model": DIST_RANKS},
            "collectives": "all_reduce SUM / MAX of FP32, bfloat16 and int32 "
                           "CUDA tensors over gloo (host-staged)",
            "host_s_through_gloo": [r["host_s"] for r in ranks],
            "spawn_s": spawn_s}

    def of_bound(out, tag):
        """The largest |out - one rank's| over its entry's bound."""
        bound = DIST_SP_SHARD_REL * sp_scale[tag]
        return float(torch.max(torch.abs(out - sp_one[tag]) / bound))
    for tag in ("exact", "lamp"):
        vs_one = float(torch.max(torch.abs(r0[f"sp_card_{tag}"]
                                           - sp_one[tag])))
        vs_cpu = float(torch.max(torch.abs(r0[f"sp_card_{tag}"]
                                           - r0[f"sp_cpu_{tag}"])))
        ratio = of_bound(r0[f"sp_card_{tag}"], tag)
        four[f"sp_{tag}"] = {"max_abs_err_vs_one_rank": vs_one,
                             "of_bound_vs_one_rank": ratio,
                             "max_abs_err_vs_cpu_4_ranks": vs_cpu}
        checks[f"dist_sp_4_ranks_{tag}"] = vs_cpu <= DIST_SP_ATOL and \
            ratio <= 1.0
    controls = {c: of_bound(r0[f"sp_control_{c}"], "exact")
                for c in ("pos_offset", "slice_dropped")}
    four["sp_controls_of_bound"] = controls
    checks["dist_sp_controls_fail_the_bound"] = all(
        v > 1.0 for v in controls.values())
    checks["dist_sp_ranks_agree"] = all(
        torch.equal(r[f"sp_card_{tag}"], r0[f"sp_card_{tag}"])
        for r in ranks for tag in ("exact", "lamp"))
    rel_ref, mx_ref, ok_ref = moe_gates(r0["moe_card"], r0["moe_ref"])
    rel_cpu, mx_cpu, ok_cpu = moe_gates(r0["moe_card"], r0["moe_cpu"])
    four["moe"] = {"kept_frac": r0["moe_kept"],
                   "rel_l2_vs_moe_apply": rel_ref,
                   "max_abs_of_max_vs_moe_apply": mx_ref,
                   "rel_l2_vs_cpu_4_ranks": rel_cpu,
                   "max_abs_of_max_vs_cpu_4_ranks": mx_cpu}
    checks["dist_moe_ep_4_ranks_vs_moe_apply"] = \
        ok_ref and r0["moe_kept"] == 1.0
    checks["dist_moe_ep_4_ranks_vs_cpu"] = ok_cpu
    four["psum"] = {"values_a_rank": r0["psum_values"],
                    "bit_equal_card_cpu": [r["psum_bit_equal"]
                                           for r in ranks]}
    checks["dist_psum_4_ranks_card_vs_cpu"] = all(
        r["psum_bit_equal"] for r in ranks)
    after = kernel_launches()
    checks["dist_no_kernel_launch"] = after == before and all(
        r["launches"] == before or all(v == 0 for v in r["launches"].values())
        for r in ranks)
    worst = max(four[f"sp_{t}"]["of_bound_vs_one_rank"]
                for t in ("exact", "lamp"))
    print(f"distributed: sp 4 ranks against 1 at {worst:.3g} of the bound, "
          f"its controls at {min(controls.values()):.3g} or more; on {smi}",
          flush=True)
    emit("distributed", card=smi, one_rank=one, four_ranks=four,
         gates=dict(sp_atol=DIST_SP_ATOL, sp_shard_rel=DIST_SP_SHARD_REL,
                    moe_rel_l2=MOE_REL_L2,
                    moe_max_abs_of_max=MOE_MAX_ABS_OF_MAX),
         launches_before=before, launches_after=after,
         seconds=time.perf_counter() - t0, checks=checks,
         ok=all(checks.values()))
    require(all(checks.values()), f"distributed phase failed its checks: "
            f"{ {k: v for k, v in checks.items() if not v} }")


# phase dryrun (a): run_cell on one cell of each kind, in a subprocess that
# plays rank 0 of a fake process group (this process holds a real one);
# started before phase moe so that its host work overlaps the card phases
DRYRUN_CELLS = (("olmoe-1b-7b", "decode_32k", False),
                ("olmoe-1b-7b", "train_4k", False),
                ("olmoe-1b-7b", "prefill_32k", True),
                ("rwkv6-7b", "long_500k", False))
# (b): olmoe-1b-7b cut to 2 layers (published widths) at decode_32k's
# per-rank shape on the (32, 8) mesh: 128 / 32 rows, 32,768 / 8 positions;
# counted on fake tensors on a one-rank fake mesh, run on the card on a
# one-rank NCCL mesh
DRYRUN_CUT = dict(arch="olmoe-1b-7b", layers=2, batch=4, seq=4096)
# peak_bytes_est over max_memory_allocated above the pre-step baseline,
# stated in PERF.md section 6 before the first card run; the estimate with
# the arguments left out (the control) must fall outside it
DRYRUN_MEM_BAND = (0.8, 1.25)
DRYRUN_TIMED = 10
DRYRUN_WORKER_TIMEOUT = 900


def dryrun_cut():
    """(cfg, shape) of phase dryrun (b)."""
    from repro_torch.configs import InputShape, get_config
    c = DRYRUN_CUT
    return (get_config(c["arch"]).replace(n_layers=c["layers"]),
            InputShape("decode_per_rank", "decode", c["seq"], c["batch"]))


def dryrun_worker(out_path):
    """The subprocess of phase dryrun: (b)'s cut cell counted on a one-rank
    fake mesh, then DRYRUN_CELLS through run_cell on the fake production
    meshes, then phase tp's bfloat16 train step on a fake TP_MESH group of
    TP_RANKS; the records as JSON at out_path. It touches no card."""
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_mesh
    cfg, shp = dryrun_cut()
    DR.start_fake_group(1)
    cut = DR.count_step(cfg, shp, make_mesh((1, 1), ("data", "model"),
                                            device="cpu"))
    cells = [DR.run_cell(a, s, mp) for a, s, mp in DRYRUN_CELLS]
    DR.start_fake_group(TP_RANKS)
    tp = DR.count_step(tp_cfg(torch.bfloat16), tp_train_shape(),
                       make_mesh(TP_MESH, ("data", "model"), device="cpu"))
    with open(out_path, "w") as f:
        json.dump({"cut": cut, "cells": cells, "tp": tp}, f)


def start_dryrun_worker(tmp):
    """Popen of `dryrun_worker` writing under tmp (no card: an empty
    CUDA_VISIBLE_DEVICES), its log beside."""
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    log = open(os.path.join(tmp, "dryrun.log"), "w")
    out = os.path.join(tmp, "dryrun.json")
    proc = subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke as CS; CS.dryrun_worker({out!r})"],
        cwd=HERE, stdout=log, stderr=subprocess.STDOUT, env=env)
    return proc, log, out


def dryrun_on_card(cfg, shp):
    """(b) on the card: the cut cell's serve step on a one-rank NCCL mesh,
    random bfloat16 weights and cache (half full). Its peak memory above
    the baseline before its arguments were placed, its flops
    (FlopCounterMode), and DRYRUN_TIMED warm steps timed by CUDA events."""
    import gc
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.core import tree as T
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import specs as SP
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    mesh = make_host_mesh()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    g = torch.Generator(device=DEVICE).manual_seed(0)
    like = SP.params_shape(cfg, SP.fake_mode())
    raw = T.map(lambda t: (0.02 * torch.randn(t.shape, generator=g,
                                              device=DEVICE)).to(t.dtype),
                like)
    params = SH.distribute(raw, SH.param_specs(raw, mesh), mesh)
    cache = api.init_cache(cfg, shp.global_batch, shp.seq_len,
                           torch.bfloat16, device=DEVICE)
    for k in ("k", "v"):
        cache[k].normal_(generator=g)
    cache["length"].fill_(shp.seq_len // 2)
    cache = SH.distribute(cache, SH.cache_specs(cache, mesh), mesh)
    tokens = torch.randint(0, cfg.vocab, (shp.global_batch, 1), generator=g,
                           device=DEVICE, dtype=torch.int32)
    del raw
    step = ST.make_sharded_serve_step(
        cfg, mesh, model_kwargs=DR.model_defaults(cfg, shp,
                                                  SH.batch_size(mesh), {}))
    gc.collect()
    torch.cuda.synchronize()
    args_bytes = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    logits, _ = step(params, cache, tokens)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    finite = bool(torch.isfinite(logits.full_tensor()).all())
    del logits
    with FlopCounterMode(display=False) as fc:
        step(params, cache, tokens)
    for _ in range(3):
        step(params, cache, tokens)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(DRYRUN_TIMED)]
    for a, b in ev:
        a.record()
        step(params, cache, tokens)
        b.record()
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in ev]
    del params, cache, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return {"flops": int(fc.get_total_flops()), "peak_bytes": peak,
            "argument_bytes": args_bytes, "logits_finite": finite,
            "ms": ms, "ms_median": statistics.median(ms)}


def phase_dryrun(worker):
    """The dry run (module docstring); `worker` = start_dryrun_worker's."""
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as MESH
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    proc, log, out = worker
    before = kernel_launches()
    cfg, shp = dryrun_cut()
    card = dryrun_on_card(cfg, shp)
    after = kernel_launches()
    print(f"dryrun: cut cell on the card: {card['flops']} flops, peak "
          f"{card['peak_bytes']} B above the baseline ({card['argument_bytes']}"
          f" B of arguments), median step {card['ms_median']:.4g} ms; "
          f"waiting for the worker", flush=True)
    t1 = time.perf_counter()
    rc = proc.wait(timeout=DRYRUN_WORKER_TIMEOUT)
    log.close()
    with open(log.name) as f:
        tail = f.read()[-3000:]
    require(rc == 0, f"dryrun worker exited {rc}: {tail}")
    with open(out) as f:
        res = json.load(f)
    wait_s = time.perf_counter() - t1
    checks = {}
    for rec in res["cells"]:
        tag = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
        checks[f"dryrun_cell_ok_{tag}"] = rec["status"] == "ok" and \
            rec["n_devices"] == (512 if rec["mesh"] == "multi" else 256)
        print(f"dryrun {tag}: {DR.roofline_line(rec)}", flush=True)
    cut = res["cut"]
    cost, mem = cut["cost"], cut["memory"]
    lo, hi = DRYRUN_MEM_BAND
    mem_ratio = mem["peak_bytes_est"] / card["peak_bytes"]
    control = (mem["peak_bytes_est"] - mem["argument_bytes"]) / card["peak_bytes"]
    floor_s = max(cost["flops_bf16_per_device"] / MESH.PEAK_FLOPS_BF16
                  + cost["flops_fp32_per_device"] / MESH.PEAK_FLOPS_FP32,
                  cost["matmul_argument_bytes_per_device"] / MESH.HBM_BW)
    roof = cut["roofline"]
    roof_s = max(roof["compute_s"], roof["memory_s"], roof["collective_s"])
    step_s = card["ms_median"] / 1e3
    checks["dryrun_flops_exact"] = card["flops"] == int(cost["flops_per_device"])
    checks["dryrun_memory_in_band"] = lo <= mem_ratio <= hi
    checks["dryrun_memory_control_outside_band"] = not lo <= control <= hi
    checks["dryrun_time_not_below_floor"] = step_s >= floor_s
    checks["dryrun_logits_finite"] = card["logits_finite"]
    checks["dryrun_no_kernel_launch"] = after == before
    print(f"dryrun: cut cell step {card['ms_median']:.4g} ms = "
          f"{step_s / floor_s:.3g} x its floor, {step_s / roof_s:.3g} x the "
          f"roofline's largest term ({roof['dominant']}); memory estimate "
          f"{mem_ratio:.4g} of the card's peak (control {control:.4g}); "
          f"on {smi}", flush=True)
    emit("dryrun", card=smi, cut=dict(DRYRUN_CUT, record=cut),
         on_card=card, flops_counted=cost["flops_per_device"],
         mem_ratio=mem_ratio, mem_control_ratio=control,
         mem_band=DRYRUN_MEM_BAND, floor_s=floor_s, step_s=step_s,
         time_over_floor=step_s / floor_s,
         time_over_roofline_max=step_s / roof_s,
         cells=res["cells"], worker_wait_s=wait_s,
         launches_before=before, launches_after=after,
         seconds=time.perf_counter() - t0, checks=checks,
         ok=all(checks.values()))
    require(all(checks.values()), f"dryrun phase failed its checks: "
            f"{ {k: v for k, v in checks.items() if not v} }")
    return res["tp"]


# phase tp: the tensor-parallel steps of the transformer families
# (launch.steps.make_sharded_*_step: FSDP over data x tensor parallelism
# over model) on TP_RANKS processes sharing the card over gloo, glm4-9b at
# its published widths (d 4096, 32 heads on 2 KV heads, ff 13696 swiglu,
# vocabulary 151,552) cut to TP_LAYERS layers: on (data 2, model 2) its 2
# KV heads and 32 heads split whole, its gate / up columns do not (wi is
# gathered over model a layer at a time), its vocabulary splits
TP_ARCH, TP_LAYERS = "glm4-9b", 2
TP_RANKS, TP_MESH = 4, (2, 2)
TP_BATCH, TP_SEQ = 4, 128                 # train: 2 rows a data rank
TP_PROMPT, TP_CACHE, TP_NEW = 32, 64, 8   # prefill / greedy decode, 2 rows
TP_SEED = 13
TP_LOSS_RTOL = 1e-5                       # loss and grad_norm, 4 ranks vs 1
# the gradients, 4 ranks against 1, FP32, leaf by leaf: the clipped
# gradient g = m / (1 - b1) from AdamW's first m, relative L2 per leaf
# over every rank's shard. The summation orders differ (row-parallel SUM
# over model, reduce-scatter over data), a roundoff of about 1e-6; a
# replicated leaf summed over model, or a missed part, reads 1. The control
# in the same run: the one-rank step on one data rank's rows only
TP_GRAD_REL = 1e-3
# the updated params, 4 ranks against 1: an element's first AdamW step is
# lr u(g) + lr wd p with u(g) = g / (|g| + eps), lr sign(g) where |g| >> eps
# and blind to g's scale (the gradient gate carries that). Where |g| is
# near eps (1e-8) roundoff in g moves u(g) by up to ~1, so the new params
# are held to the one-rank step's once each side's own u(g) is applied
# (within TP_PARAM_ATOL), and every element within TP_PARAM_MAX_LR x lr;
# the count beyond TP_PARAM_ATOL is printed with those elements' |g|
TP_PARAM_ATOL = 3e-7                      # lr / 1000 at lr 3e-4
TP_PARAM_MAX_LR = 1.0
# each rank's bfloat16 step: max_memory_allocated above the baseline before
# its arguments over op_cost's peak_bytes_est of the same step on a fake
# TP_MESH group (the worker of phase dryrun), as phase dryrun's band
TP_MEM_BAND = (0.8, 1.25)


def tp_cfg(dtype):
    from repro_torch.configs import get_config
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    return get_config(TP_ARCH).replace(n_layers=TP_LAYERS, dtype=name)


def tp_train_shape():
    from repro_torch.configs import InputShape
    return InputShape("tp_train", "train", TP_SEQ, TP_BATCH)


def tp_params(cfg, mesh=None):
    """cfg's params on the card, each leaf drawn whole from its own seeded
    CUDA generator (0.02 N(0, 1), the same values in every process) in the
    config's dtype; with `mesh`, placed by param_specs one leaf at a time
    (the rank keeps its shard)."""
    from repro_torch.core import tree as T
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import specs as SP
    like = SP.params_shape(cfg, SP.fake_mode())
    specs = T.leaves(SH.param_specs(like, mesh)) if mesh is not None else None
    out = []
    for i, t in enumerate(T.leaves(like)):
        g = torch.Generator(device=DEVICE).manual_seed(TP_SEED + i)
        w = (0.02 * torch.randn(t.shape, generator=g, device=DEVICE)).to(
            t.dtype)
        if mesh is not None:
            w = SH.distribute({"x": w}, {"x": specs[i]}, mesh)["x"]
        out.append(w)
    return T.unflatten(like, out)


def tp_inputs(cfg):
    """(train batch, prompt): token ids from a seeded CPU generator."""
    g = torch.Generator().manual_seed(TP_SEED)
    train = torch.randint(0, cfg.vocab, (TP_BATCH, TP_SEQ), generator=g,
                          dtype=torch.int32)
    prompt = torch.randint(0, cfg.vocab, (2, TP_PROMPT), generator=g,
                           dtype=torch.int32)
    return {"tokens": train.to(DEVICE)}, {"tokens": prompt.to(DEVICE)}


def tp_greedy(prefill, serve, params, cache, prompt, full):
    """Prefill, then TP_NEW greedy decode steps: (tokens (2, TP_NEW),
    [logits of each step])."""
    logits, cache = prefill(params, cache, prompt)
    seen, toks = [full(logits)], []
    for _ in range(TP_NEW):
        tok = seen[-1][:, -1].argmax(-1).to(torch.int32)[:, None]
        toks.append(tok)
        logits, cache = serve(params, cache, tok)
        seen.append(full(logits))
    return torch.cat(toks, 1).cpu(), [x.cpu() for x in seen]


def _synced_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def tp_one_rank():
    """The reference: the plain steps of this process on the card, FP32:
    one train step (and its time, a second step from the same state),
    then prefill and TP_NEW greedy decode steps."""
    import gc
    from repro_torch.core import tree as T
    from repro_torch.launch import steps as ST
    from repro_torch.models import api
    from repro_torch.optim import adamw
    cfg = tp_cfg(torch.float32)
    params = tp_params(cfg)
    batch, prompt = tp_inputs(cfg)
    step = ST.make_train_step(cfg, adamw.AdamWConfig())
    opt = adamw.init_state(params)
    out, first_s = _synced_s(lambda: step(params, opt, batch))
    m = out[2]
    res = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "params": dict(_flat_cpu(out[0])), "m": dict(_flat_cpu(out[1].m)),
           "first_s": first_s}
    del out
    gc.collect()
    _, res["step_s"] = _synced_s(
        lambda: step(params, opt, batch)[2]["loss"])
    # the control: the gradient of data rank 0's rows alone
    half = {"tokens": batch["tokens"][:TP_BATCH // TP_MESH[0]]}
    ctl = step(params, opt, half)[1].m
    res["control_rel"] = {}
    for q, t in T.flatten_with_path(ctl):
        full = res["m"]["/".join(q)].to(DEVICE)
        res["control_rel"]["/".join(q)] = float(
            torch.linalg.vector_norm(t - full) / torch.linalg.vector_norm(full))
    del ctl, full, opt
    gc.collect()
    cache = api.init_cache(cfg, 2, TP_CACHE, torch.float32, device=DEVICE)
    res["tokens"], res["logits"] = tp_greedy(
        ST.make_prefill_step(cfg), ST.make_serve_step(cfg), params, cache,
        prompt, lambda t: t)
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _flat_cpu(tree):
    from repro_torch.core import tree as T
    return [("/".join(p), t.detach().cpu()) for p, t in
            T.flatten_with_path(tree)]


def tp_rank(rank, tmp):
    """One of TP_RANKS processes sharing the card over gloo, mesh TP_MESH:
    (a) FP32: the sharded train step twice from the same state (the
    second timed), its new params' and first m's shards written for the
    main process,
    the sharded prefill and greedy decode; (b) bfloat16: one sharded train
    step, max_memory_allocated above the baseline before its arguments."""
    import datetime
    import faulthandler
    import gc
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import tree as T
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import api
    from repro_torch.optim import adamw
    # a crash in native code (gloo, CUDA) prints this rank's Python stack
    faulthandler.enable()
    torch.cuda.set_device(0)
    torch.set_num_threads(2)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), TP_RANKS),
        rank=rank, world_size=TP_RANKS,
        timeout=datetime.timedelta(seconds=300))
    mesh = init_device_mesh("cuda", TP_MESH, mesh_dim_names=("data", "model"))
    res = {"rank": rank, "coords": {a: SH.axis_index(mesh, a)
                                    for a in ("data", "model")}}

    def stage(what):
        print(f"tp: rank {rank} {what}", flush=True)
    cfg = tp_cfg(torch.float32)
    params = tp_params(cfg, mesh)
    stage("FP32 params placed")
    batch, prompt = tp_inputs(cfg)
    opt = _tp_opt(params, mesh)
    step = ST.make_sharded_train_step(cfg, adamw.AdamWConfig(), mesh)
    out, res["first_s"] = _synced_s(lambda: step(params, opt, batch))
    m = out[2]
    res["loss"], res["grad_norm"] = float(m["loss"]), float(m["grad_norm"])
    stage("FP32 train step done")
    m_loc = {"/".join(p): t.to_local().cpu()
             for p, t in T.flatten_with_path(out[1].m)}
    shards = {"/".join(p): (SH.spec_of(t), t.to_local().cpu(), m_loc[
        "/".join(p)]) for p, t in T.flatten_with_path(out[0])}
    torch.save(shards, os.path.join(tmp, f"shards{rank}.pt"))
    del out, shards
    gc.collect()
    _, res["step_s"] = _synced_s(
        lambda: step(params, opt, batch)[2]["loss"])
    del opt
    gc.collect()
    cache = api.init_cache(cfg, 2, TP_CACHE, torch.float32, device=DEVICE)
    cache = SH.distribute(cache, SH.cache_specs(cache, mesh), mesh)
    res["tokens"], res["logits"] = tp_greedy(
        ST.make_sharded_prefill_step(cfg, mesh),
        ST.make_sharded_serve_step(cfg, mesh), params, cache, prompt,
        tp_full)
    stage("FP32 prefill and decode done")
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()

    cfg = tp_cfg(torch.bfloat16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = tp_params(cfg, mesh)
    opt = _tp_opt(params, mesh)
    step = ST.make_sharded_train_step(cfg, adamw.AdamWConfig(), mesh)
    gc.collect()
    torch.cuda.synchronize()
    res["bf16_argument_bytes"] = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    m, res["bf16_step_s"] = _synced_s(lambda: step(params, opt, batch)[2])
    res["bf16_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    res["bf16_loss"] = float(m["loss"])
    stage("bfloat16 train step done")
    res["launches"] = kernel_launches()
    del params, opt
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def tp_full(t):
    """The whole of a DTensor by c10d all-gathers over the mesh axes it is
    split on, minor first: gloo takes those on CUDA tensors, where
    DTensor.full_tensor's functional collectives crash the process on the
    H100 (SIGSEGV in wait_tensor; torch 2.11)."""
    from repro_torch.distributed import collectives as C
    local = t.to_local()
    for name, p in reversed(list(zip(t.device_mesh.mesh_dim_names,
                                     t.placements))):
        if p.is_shard():
            local = C.all_gather(local, t.device_mesh, name, p.dim)
    return local


def _tp_opt(params, mesh):
    """AdamW's zero state placed as the params are (opt_specs)."""
    from repro_torch.core import tree as T
    from repro_torch.distributed import sharding as SH
    from repro_torch.optim import adamw
    local = adamw.init_state(T.map(SH.to_local, params))
    return adamw.AdamWState(
        step=SH.distribute({"s": local.step}, {"s": ()}, mesh)["s"],
        m=T.map(_placed_as, local.m, params),
        v=T.map(_placed_as, local.v, params))


def _placed_as(local, p):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, p.device_mesh, p.placements,
                              run_check=False, shape=p.shape,
                              stride=p.stride())


def _slice_of(t, spec, coords):
    """The rank at mesh coordinates `coords` of TP_MESH's shard of the
    whole tensor t placed by spec."""
    sizes = dict(zip(("data", "model"), TP_MESH))
    for d, ax in enumerate(spec):
        if isinstance(ax, str):
            size = t.shape[d] // sizes[ax]
            t = t.narrow(d, coords[ax] * size, size)
    return t


def phase_tp(tp_count):
    """The tensor-parallel steps (module docstring); `tp_count` is the
    dryrun worker's op_cost record of the bfloat16 train step on a fake
    TP_MESH group."""
    import gc
    import torch.multiprocessing as mp
    from repro_torch.launch import specs as SP
    from repro_torch.optim import adamw
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    gc.collect()
    torch.cuda.empty_cache()
    before = kernel_launches()
    one = tp_one_rank()
    acfg = adamw.AdamWConfig()
    lr = acfg.lr
    apart, worst, resid, n = 0, 0.0, 0.0, 0
    sq = collections.defaultdict(lambda: [0.0, 0.0])   # leaf: |dg|^2, |g|^2
    apart_leaf = collections.Counter()
    # |g| of the elements beyond TP_PARAM_ATOL, by decade below 1e-8 .. 1e-3
    g_edges = [1e-8, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3]
    g_hist, g_apart_max = [0] * (len(g_edges) + 1), 0.0

    def u(m):
        g = m.float() / (1 - acfg.b1)
        return g / (torch.abs(g) + acfg.eps)
    t1 = time.perf_counter()
    # an exception in any rank ends the spawn, and so the phase
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(tp_rank, args=(tmp,), nprocs=TP_RANKS)
        spawn_s = time.perf_counter() - t1
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(TP_RANKS)]
        for r in range(TP_RANKS):
            shards = torch.load(os.path.join(tmp, f"shards{r}.pt"))
            # compared on the card, free again once the ranks have ended
            for path, (spec, t, m4) in shards.items():
                at = ranks[r]["coords"]
                t, m4 = t.to(DEVICE), m4.to(DEVICE)
                ref = _slice_of(one["params"][path], spec, at).to(DEVICE)
                m1 = _slice_of(one["m"][path], spec, at).to(DEVICE)
                d = t.float() - ref.float()
                far = torch.abs(d) > TP_PARAM_ATOL
                apart_leaf[path] += int(torch.sum(far))
                apart += int(torch.sum(far))
                worst = max(worst, float(torch.max(torch.abs(d))))
                # the difference left once each side's own u(g) is applied
                resid = max(resid, float(torch.max(torch.abs(
                    d + lr * (u(m4) - u(m1))))))
                g_far = torch.abs(m1[far].double()) / (1 - acfg.b1)
                if g_far.numel():
                    g_apart_max = max(g_apart_max, float(g_far.max()))
                    idx = torch.bucketize(g_far, torch.tensor(
                        g_edges, dtype=torch.float64, device=DEVICE))
                    for i, c in enumerate(torch.bincount(
                            idx, minlength=len(g_hist)).tolist()):
                        g_hist[i] += c
                sq[path][0] += float(torch.sum(
                    (m4.float() - m1.float()) ** 2, dtype=torch.float64))
                sq[path][1] += float(torch.sum(m1.float() ** 2,
                                               dtype=torch.float64))
                n += t.numel()
            del shards, t, m4, ref, m1, d, far
    del one["params"], one["m"]
    torch.cuda.empty_cache()
    grad_rel = {p: (a / b) ** 0.5 if b > 0 else float(a > 0)
                for p, (a, b) in sq.items()}
    r0 = ranks[0]
    checks = {}
    checks["tp_loss_4_ranks_vs_1"] = all(
        abs(r["loss"] - one["loss"]) <= TP_LOSS_RTOL * abs(one["loss"])
        for r in ranks)
    checks["tp_grad_norm_4_ranks_vs_1"] = all(
        abs(r["grad_norm"] - one["grad_norm"])
        <= TP_LOSS_RTOL * abs(one["grad_norm"]) for r in ranks)
    checks["tp_grads_per_leaf_4_ranks_vs_1"] = (
        max(grad_rel.values()) <= TP_GRAD_REL)
    checks["tp_grad_control_outside"] = (
        set(one["control_rel"]) == set(grad_rel)
        and min(one["control_rel"].values()) > TP_GRAD_REL)
    checks["tp_params_as_their_grads"] = resid <= TP_PARAM_ATOL
    checks["tp_params_within_lr"] = worst <= TP_PARAM_MAX_LR * lr
    checks["tp_tokens_equal_one_rank"] = all(
        torch.equal(r["tokens"], one["tokens"]) for r in ranks)
    logit_rel = [float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))
                 for a, b in zip(r0["logits"], one["logits"])]
    checks["tp_logits_finite"] = all(
        bool(torch.isfinite(x).all()) for x in r0["logits"])
    # (b) memory: the count, and the data-parallel step's floor: its
    # arguments (the same shards) plus the whole model's params and
    # gradients, which it gathers and computes whole
    cfg = tp_cfg(torch.bfloat16)
    whole = sum(t.numel() * t.element_size() for t in
                _leaves(SP.params_shape(cfg, SP.fake_mode())))
    est = tp_count["memory"]["peak_bytes_est"]
    mem = [{"rank": r["rank"], "peak_bytes": r["bf16_peak_bytes"],
            "argument_bytes": r["bf16_argument_bytes"],
            "of_estimate": r["bf16_peak_bytes"] / est,
            "dp_floor_bytes": r["bf16_argument_bytes"] + 2 * whole,
            "of_dp_floor": r["bf16_peak_bytes"]
            / (r["bf16_argument_bytes"] + 2 * whole)} for r in ranks]
    lo, hi = TP_MEM_BAND
    checks["tp_memory_in_band"] = all(lo <= m["of_estimate"] <= hi
                                      for m in mem)
    checks["tp_memory_below_dp_floor"] = all(m["of_dp_floor"] < 1
                                             for m in mem)
    checks["tp_bf16_loss_finite"] = all(np.isfinite(r["bf16_loss"])
                                        for r in ranks)
    after = kernel_launches()
    checks["tp_no_kernel_launch"] = after == before and all(
        r["launches"] == before or all(v == 0 for v in r["launches"].values())
        for r in ranks)
    step_s = [r["step_s"] for r in ranks]
    print(f"tp: glm4-9b-{TP_LAYERS}l on {TP_RANKS} gloo ranks {TP_MESH}: loss "
          f"{r0['loss']:.7g} vs one rank {one['loss']:.7g}, grad_norm "
          f"{r0['grad_norm']:.7g} vs {one['grad_norm']:.7g}; gradients "
          f"per leaf: worst {max(grad_rel.values()):.3g} relative L2 "
          f"({max(grad_rel, key=grad_rel.get)}), control's least "
          f"{min(one['control_rel'].values()):.3g}; params: {apart} of {n} "
          f"beyond {TP_PARAM_ATOL:g}, max {worst:.3g}, {resid:.3g} once "
          f"each side's own gradient is applied", flush=True)
    print(f"tp: |g| of the {apart} params beyond {TP_PARAM_ATOL:g}, by "
          f"edges {g_edges}: {g_hist}, largest {g_apart_max:.3g}; the "
          f"leaves that hold them: {dict((+apart_leaf).most_common(8))}; "
          f"tokens equal {checks['tp_tokens_equal_one_rank']}, logits "
          f"{max(logit_rel):.3g} of the largest; bfloat16 peak "
          f"{[round(m['of_estimate'], 4) for m in mem]} of op_cost's "
          f"{est} B, {[round(m['of_dp_floor'], 4) for m in mem]} of the "
          f"data-parallel floor (whole params + grads {2 * whole} B + "
          f"arguments)", flush=True)
    print(f"tp: FP32 train step {max(step_s) * 1e3:.1f} ms on {TP_RANKS} "
          f"ranks (gloo's host-staged collectives, not NVLink's), "
          f"{one['step_s'] * 1e3:.1f} ms on one rank; on {smi}", flush=True)
    emit("tp", card=smi, arch=TP_ARCH, layers=TP_LAYERS, mesh=TP_MESH,
         one_rank={k: v for k, v in one.items()
                   if k not in ("tokens", "logits", "control_rel")},
         ranks=[{k: v for k, v in r.items() if k not in ("tokens", "logits")}
                for r in ranks],
         tokens=one["tokens"].tolist(), logits_rel_to_one_rank=logit_rel,
         params_apart=apart, params_n=n, params_max_abs=worst,
         params_resid_after_own_grads=resid, grad_rel=grad_rel,
         grad_control_rel=one["control_rel"], params_apart_g_edges=g_edges,
         params_apart_g_hist=g_hist, params_apart_g_max=g_apart_max,
         params_apart_leaves=dict(+apart_leaf),
         memory=mem, op_cost_peak_bytes_est=est, whole_params_bytes=whole,
         gates=dict(loss_rtol=TP_LOSS_RTOL, grad_rel=TP_GRAD_REL,
                    param_atol=TP_PARAM_ATOL,
                    param_max_lr=TP_PARAM_MAX_LR,
                    mem_band=TP_MEM_BAND),
         spawn_s=spawn_s, launches_before=before, launches_after=after,
         seconds=time.perf_counter() - t0, checks=checks,
         ok=all(checks.values()))
    require(all(checks.values()), f"tp phase failed its checks: "
            f"{ {k: v for k, v in checks.items() if not v} }")


def _leaves(tree):
    from repro_torch.core import tree as T
    return T.leaves(tree)


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
    launches, ref_tokens, gather_arm = phase_engine(params, cfg, rec)
    spec_launches, spec_wall = phase_spec(params, cfg, ref_tokens, rec)
    phase_profile(params, cfg, spec_wall)
    rows = phase_kernels(rec, launches + spec_launches["mixed"],
                         spec_launches["decode"])
    phase_obs(params, cfg, ref_tokens)
    dense = phase_gather(params, cfg, gather_arm)
    phase_faults(params, cfg, ref_tokens)
    phase_kv_dtype(params, cfg, ref_tokens, rec, dense)
    del dense
    phase_sampled(params, cfg)
    phase_policy(params, cfg)
    phase_audit(params, cfg, ref_tokens)
    phase_phased(params, cfg, ref_tokens)
    with tempfile.TemporaryDirectory() as tmp:
        worker = start_dryrun_worker(tmp)
        try:
            phase_moe()
            phase_paper()
            phase_static()
            phase_train()
            phase_distributed()
            tp_count = phase_dryrun(worker)
            phase_tp(tp_count)
        finally:
            if worker[0].poll() is None:
                worker[0].kill()
            worker[0].wait()
            worker[1].close()
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": rows + micro_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
