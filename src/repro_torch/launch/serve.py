"""Serve a synthetic Poisson request stream with the port's LAMP engine (the
port of ``repro/launch/serve.py``'s stream, observability and fault-tolerance
flags).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2 --reduced \
        --qps 8 --num-requests 8 --device cpu [--speculative] \
        [--kernel gather] [--trace-out t.json] [--metrics-out m.json]

Weights are random, drawn from `--seed`. Requests arrive with exponential
inter-arrival times at `--qps`, with prompt and output lengths drawn per
request (`--shared-prefix N` opens every prompt with the same N tokens);
the engine admits them into the paged KV pool, continuously batches them
and reports throughput, latency percentiles, KV-block utilization, the
prefix cache, the per-request and aggregate LAMP recompute rate, compile
events and the wall time of each step phase; with `--speculative` also
rounds, acceptance, tokens per round and the verify pass's recompute rate.

Observability: `--metrics-every S` prints a one-line registry snapshot
every S seconds of stream time; `--trace-out f.json` records step-phase
spans and writes a Chrome trace (Perfetto / chrome://tracing);
`--metrics-out f.json` dumps the final metrics registry; `--torch-profile
DIR` wraps the run in torch.profiler and writes its Chrome trace there.
All loop timing runs off the engine's one clock (`engine.obs.now`), so
`serve_stream` is deterministic under a fake clock. `--kernel gather` runs
the paged attention's plain versions instead of the kernels. Runs on CUDA
unless `--device cpu`.

Fault tolerance: `--deadline S` gives every request a wall-clock TTL,
`--max-queue N` bounds the admission queue (rejected arrivals are logged and
skipped), and `--fault-nan/alloc/draft/step/stall R` inject deterministic
faults at those per-step rates (`--fault-salt` is the replay key,
`--fault-max` caps the total). With faults on the summary gains a
`[serve] faults:` line; any request that failed alone (timeout, exhausted
recovery ladder, stall) or was rejected makes the CLI exit 1.

Policy: `--policy` turns on the adaptive LAMP policy loop (per-layer tau
toward `--target-recompute-rate`, degrading draft length and rule tier
under pool pressure or a missed `--latency-slo`); the summary gains a
`[serve] policy:` line and `--metrics-every` lines show its mode.

Engine: `--block-size`, `--n-blocks` (0 sizes the pool from the model
length), `--max-model-len` (0: the longest request + 8),
`--max-prefill-tokens` (the prefill step's token budget, the chunk size),
`--[no-]prefix-cache`, `--[no-]chunked-prefill` and `--[no-]fused`
(`--no-fused`: the phase-segregated prefill / decode plans).

Audit: `--audit-rate R` shadow-audits that fraction of steps (replays the
sampled rows against the FP32 reference without touching a served token);
the summary gains `[serve] audit:` lines (audited steps and rows, flip
rate, logit error, per-layer KQ error, calibrated targets), the
`--metrics-every` lines the audited flip rate, and `--audit-out f.json`
gets `stats()["audit"]`.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.configs import get_config, list_archs, reduced as reduce_cfg
from repro_torch.models import transformer
from repro_torch.obs import ObsConfig
from repro_torch.serving import (AuditConfig, EngineConfig, FaultConfig,
                                 LampEngine, PolicyConfig, QueueFullError,
                                 SamplingParams)
from repro_torch.serving.engine import TEXT_FAMILIES


def servable_archs():
    return [a for a in list_archs() if get_config(a).family in TEXT_FAMILIES]


def build_stream(rng: np.random.Generator, args, vocab: int):
    """Synthetic Poisson stream: (arrival_s, prompt, sampling) per request.
    With --shared-prefix N, every prompt opens with the same N tokens (a
    shared system prompt), the traffic shape prefix caching exists for."""
    arrivals = np.cumsum(rng.exponential(1.0 / args.qps, args.num_requests))
    shared = rng.integers(0, vocab, size=args.shared_prefix).tolist() \
        if args.shared_prefix else []
    reqs = []
    for i in range(args.num_requests):
        plen = int(rng.integers(args.min_prompt, args.max_prompt + 1))
        new = int(rng.integers(args.min_new, args.max_new + 1))
        prompt = shared + rng.integers(0, vocab, size=plen).tolist()
        sampling = SamplingParams(max_new_tokens=new,
                                  temperature=args.temperature, seed=i,
                                  top_k=args.top_k,
                                  deadline_s=getattr(args, "deadline", 0.0))
        reqs.append((float(arrivals[i]), prompt, sampling))
    return reqs


def metrics_line(engine: LampEngine, elapsed: float) -> str:
    """One-line live snapshot for periodic progress logging (the JAX
    line). Carries the policy mode and the audited flip rate ("-" with the
    audit off), so a burst-load run is readable from the log alone:
    "mode=shed" explains a rate drop, and a flip-rate spike says the
    degradation is costing real tokens."""
    s = engine.stats()
    mode = s["policy"]["mode"] if s["policy"]["enabled"] else "off"
    audit = s["audit"]
    flips = (f"{audit['flip_rate']:.3f}" if audit["enabled"] else "-")
    return (f"[serve] t={elapsed:7.2f}s live={s['live_requests']:>3d} "
            f"done={s['num_finished']:>3d} steps={s['steps']} "
            f"tok/s={s['tokens_per_s']:7.1f} "
            f"kv_util={s['kv_util_peak']:.0%} "
            f"lamp_rate={s['lamp_recompute_rate']:.4f} "
            f"mode={mode} audit_flips={flips} "
            f"compiles={s['compiles']}")


def serve_stream(engine: LampEngine, stream, *,
                 metrics_every: float = 0.0,
                 sleep: Optional[Callable[[float], None]] = None,
                 log: Callable[[str], None] = print,
                 per_request: bool = True,
                 outputs: Optional[List] = None) -> List:
    """Drive the engine over a pre-built (arrival_s, prompt, sampling)
    stream. Every timestamp -- arrivals, idle waits, the snapshot cadence --
    comes from the engine's own clock (`engine.obs.now`), so a fake clock
    plus a clock-advancing `sleep` makes the whole loop deterministic.

    A bounded admission queue (EngineConfig.max_queue) rejects arrivals
    with QueueFullError; rejected requests are logged and skipped, the
    stream keeps serving. Pass `outputs` to share the result list with the
    caller: requests finished before a mid-stream exception stay visible
    for reporting."""
    clock = engine.obs.now
    if sleep is None:
        sleep = time.sleep
    t0 = clock()
    next_metrics = metrics_every
    i = 0
    if outputs is None:
        outputs = []
    while i < len(stream) or engine.has_unfinished():
        now = clock() - t0
        while i < len(stream) and stream[i][0] <= now:
            arr, prompt, sampling = stream[i]
            try:
                engine.add_request(prompt, sampling, arrival_time=t0 + arr)
            except QueueFullError as e:
                log(f"[serve]   req at t={arr:.2f}s REJECTED: {e}")
            i += 1
        done = engine.step()
        outputs.extend(done)
        if per_request:
            for o in done:
                if o.error is not None:
                    log(f"[serve]   req {o.req_id:>3d} FAILED "
                        f"({o.finish_reason}): {o.error}")
                    continue
                log(f"[serve]   req {o.req_id:>3d} done: "
                    f"prompt={len(o.prompt)} new={len(o.tokens)} "
                    f"latency={o.latency * 1e3:7.1f}ms "
                    f"ttft={o.ttft * 1e3:7.1f}ms "
                    f"preempt={o.num_preemptions} "
                    f"cached={o.num_cached_tokens} "
                    f"lamp_rate={o.lamp_recompute_rate:.4f}")
        if metrics_every > 0 and clock() - t0 >= next_metrics:
            log(metrics_line(engine, clock() - t0))
            next_metrics += metrics_every
        if not engine.has_unfinished() and i < len(stream):
            sleep(max(0.0, stream[i][0] - (clock() - t0)))
    return outputs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gpt2", choices=servable_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the config to CPU-smoke scale")
    ap.add_argument("--qps", type=float, default=8.0,
                    help="Poisson arrival rate (requests/s)")
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--min-prompt", type=int, default=8)
    ap.add_argument("--max-prompt", type=int, default=48)
    ap.add_argument("--min-new", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--n-blocks", type=int, default=0,
                    help="KV pool size in blocks (0 = auto)")
    ap.add_argument("--max-model-len", type=int, default=0)
    ap.add_argument("--max-prefill-tokens", type=int, default=2048,
                    help="prefill-step token budget = chunk size")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="share prompt-prefix KV blocks across requests "
                         "(copy-on-write)")
    ap.add_argument("--chunked-prefill",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="prefill long prompts in max-prefill-tokens chunks "
                         "so decode steps interleave")
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="fused serving step: one mixed "
                         "prefill+decode+verify plan per step (token-"
                         "identical to the phase-segregated step). On by "
                         "default; --no-fused restores the split phases")
    ap.add_argument("--top-k", type=int, default=0,
                    help="sample from the top-k logits only (0 = "
                         "unfiltered); also the filter the speculative "
                         "accept rule scores against")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend a common prefix of this many tokens to "
                         "every prompt (prefix-cache traffic)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernel", choices=transformer.KERNELS, default="cuda",
                    help="paged-attention path: 'cuda' runs the kernels (on "
                         "a card; their plain versions on the CPU), "
                         "'gather' the plain versions on any device")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-lamp", action="store_true")
    ap.add_argument("--speculative", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="LAMP self-draft speculative decoding: draft with "
                         "the pure low-precision forward (rule 'none'), "
                         "verify all drafted positions in one multi-token "
                         "LAMP forward (greedy outputs identical to "
                         "non-speculative decoding)")
    ap.add_argument("--draft-len", type=int, default=4,
                    help="speculative draft tokens per sequence per round")
    ap.add_argument("--policy", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="adaptive LAMP policy loop: actuate per-layer "
                         "thresholds toward --target-recompute-rate every "
                         "step (written in place into the tensor the kernel "
                         "reads) and degrade draft length / rule tier under "
                         "KV-pool pressure")
    ap.add_argument("--target-recompute-rate", type=float, default=0.05,
                    help="per-layer LAMP recompute-rate setpoint the "
                         "policy controller steers tau toward")
    ap.add_argument("--latency-slo", type=float, default=0.0,
                    help="step-latency SLO in seconds; exceeding it is "
                         "pressure that degrades the policy mode (0 = no "
                         "latency signal)")
    ap.add_argument("--audit-rate", type=float, default=0.0,
                    help="shadow-audit this fraction of serving steps: "
                         "re-run sampled rows through the FP32 reference "
                         "forward (never perturbs served tokens) and "
                         "report realized LAMP error -- per-layer "
                         "attribution, argmax flip rate, top-k overlap "
                         "(0 = off)")
    ap.add_argument("--audit-out", default="",
                    help="write the final audit summary (stats()['audit'] "
                         "JSON: per-layer errors, flip rate, calibrated "
                         "targets) here")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-request wall-clock TTL in seconds; an "
                         "expired request is cancelled with "
                         "finish_reason='timeout' and its blocks freed "
                         "(0 = no deadline)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded admission queue: reject arrivals once "
                         "this many requests are waiting (0 = unbounded)")
    ap.add_argument("--fault-nan", type=float, default=0.0,
                    help="deterministic fault injection: per-step "
                         "probability of poisoning one row's logits/KV "
                         "with NaN (exercises the health guard + recovery "
                         "ladder)")
    ap.add_argument("--fault-alloc", type=float, default=0.0,
                    help="fault injection: per-step probability of failing "
                         "the next KV-block allocation (degrades to "
                         "deferral, never crashes)")
    ap.add_argument("--fault-draft", type=float, default=0.0,
                    help="fault injection: per-step probability of "
                         "corrupting one row's speculative draft tokens "
                         "(the verifier rejects them)")
    ap.add_argument("--fault-step", type=float, default=0.0,
                    help="fault injection: per-step probability of a "
                         "fused-step launch anomaly (degrades that step to "
                         "the split twin)")
    ap.add_argument("--fault-stall", type=float, default=0.0,
                    help="fault injection: per-step probability of an "
                         "artificial stall (no-progress steps the "
                         "watchdog must clear)")
    ap.add_argument("--fault-salt", type=int, default=0,
                    help="salt for the deterministic fault hash: same "
                         "salt + rates + stream replays the same faults "
                         "bit-for-bit")
    ap.add_argument("--fault-max", type=int, default=0,
                    help="cap total injected faults (0 = unlimited)")
    ap.add_argument("--metrics-every", type=float, default=0.0,
                    help="print a one-line metrics snapshot every S seconds "
                         "of stream time (0 = off)")
    ap.add_argument("--trace-out", default="",
                    help="record step-phase spans and write a Chrome trace "
                         "JSON here (open in Perfetto / chrome://tracing)")
    ap.add_argument("--metrics-out", default="",
                    help="write the final metrics-registry snapshot (JSON) "
                         "here")
    ap.add_argument("--torch-profile", default="",
                    help="wrap the run in torch.profiler and write its "
                         "Chrome trace into this directory")
    args = ap.parse_args(argv)
    if args.num_requests < 1:
        ap.error("--num-requests must be >= 1")
    if args.min_prompt > args.max_prompt or args.min_new > args.max_new:
        ap.error("--min-prompt/--min-new must not exceed --max-prompt/--max-new")
    device = transformer.resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    longest = args.shared_prefix + args.max_prompt
    max_len = args.max_model_len or min(cfg.max_seq,
                                        longest + args.max_new + 8)
    if longest + args.max_new > max_len:
        ap.error(f"shared prefix + max prompt + max new "
                 f"({longest + args.max_new}) exceeds the model length "
                 f"budget {max_len}; raise --max-model-len "
                 f"(<= cfg.max_seq {cfg.max_seq}) or shrink the request sizes")
    params = transformer.init_params(cfg, args.seed, device=device)
    obs = ObsConfig(trace=bool(args.trace_out), trace_path=args.trace_out,
                    torch_profile_dir=args.torch_profile)
    fault_rates = dict(nan_rate=args.fault_nan, alloc_rate=args.fault_alloc,
                       draft_rate=args.fault_draft,
                       step_rate=args.fault_step,
                       stall_rate=args.fault_stall)
    faults = FaultConfig(enabled=any(r > 0 for r in fault_rates.values()),
                         salt=args.fault_salt, max_faults=args.fault_max,
                         **fault_rates)
    policy = PolicyConfig(enabled=args.policy,
                          target_rate=args.target_recompute_rate,
                          latency_slo_s=args.latency_slo)
    engine = LampEngine(cfg, params, EngineConfig(
        block_size=args.block_size, n_blocks=args.n_blocks,
        max_model_len=max_len, use_lamp=not args.no_lamp,
        max_prefill_tokens=args.max_prefill_tokens,
        prefix_cache=args.prefix_cache,
        chunked_prefill=args.chunked_prefill,
        speculative=args.speculative, draft_len=args.draft_len,
        fused_step=args.fused, kernel=args.kernel, obs=obs,
        device=str(device), faults=faults, max_queue=args.max_queue,
        policy=policy, audit=AuditConfig(rate=args.audit_rate)))
    stream = build_stream(np.random.default_rng(args.seed), args, cfg.vocab)
    print(f"[serve] arch={cfg.name} device={device} lamp={not args.no_lamp} "
          f"qps={args.qps} requests={args.num_requests} "
          f"pool={engine.pool.num_total}x{engine.pool.block_size} blocks "
          f"prefix_cache={args.prefix_cache} "
          f"chunked_prefill={args.chunked_prefill} "
          f"kernel={args.kernel} speculative={args.speculative} "
          f"policy={args.policy} fused={args.fused}")

    outputs: List = []
    with engine.obs.profile():
        serve_stream(engine, stream, metrics_every=args.metrics_every,
                     outputs=outputs)

    # end-of-run report: exact percentiles over every finished request (the
    # periodic lines use the streaming histogram estimates)
    s = engine.stats(exact=True)
    if args.audit_out:
        with open(args.audit_out, "w") as f:
            json.dump(s["audit"], f, indent=1)
        print(f"[serve] wrote audit summary to {args.audit_out}")
    if args.trace_out:
        path = engine.write_trace()
        print(f"[serve] wrote Chrome trace ({len(engine.obs.tracer.events())} "
              f"events, {engine.obs.tracer.dropped} dropped) to {path}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(engine.metrics_snapshot(), f, indent=1)
        print(f"[serve] wrote metrics snapshot to {args.metrics_out}")
    mean_rate = (np.mean([o.lamp_recompute_rate for o in outputs])
                 if outputs else 0.0)
    shape = (f"{s['mixed_steps']} mixed steps, {s['launches']} launches"
             if args.fused else
             f"{s['prefill_steps']} prefill / {s['decode_steps']} decode "
             f"steps, {s['launches']} launches")
    print(f"[serve] finished {s['num_finished']}/{args.num_requests} requests "
          f"in {s['elapsed_s']:.2f}s ({shape}, {s['preemptions']} "
          f"preemptions)")
    print(f"[serve] throughput {s['tokens_per_s']:.1f} tok/s, "
          f"{s['requests_per_s']:.2f} req/s")
    print(f"[serve] latency p50 {s['latency_p50_s'] * 1e3:.0f}ms  "
          f"p99 {s['latency_p99_s'] * 1e3:.0f}ms  "
          f"ttft p50 {s['ttft_p50_s'] * 1e3:.0f}ms")
    print(f"[serve] kv-block utilization mean {s['kv_util_mean']:.2%} "
          f"peak {s['kv_util_peak']:.2%}")
    print(f"[serve] prefix cache: hit rate {s['cache_hit_rate']:.2%} "
          f"({s['cached_tokens']} cached / {s['prefill_tokens_run']} run "
          f"tokens), {s['blocks_saved']} blocks saved / "
          f"{s['blocks_allocated']} allocated, {s['cow_copies']} COW copies, "
          f"{s['cache_evictions']} evictions, "
          f"{s['prefill_chunks']} prefill chunks, "
          f"{s['resume_cached_tokens']} resume-cached tokens")
    print(f"[serve] LAMP recompute rate: aggregate "
          f"{s['lamp_recompute_rate']:.4f}, per-request mean {mean_rate:.4f}")
    rates = s["lamp_layer_rates"]
    if any(v > 0 for v in rates):
        print("[serve] per-layer recompute rate: "
              + " ".join(f"L{i}={r:.3f}" for i, r in enumerate(rates)))
    if s["compiles"]:
        print(f"[serve] first runs of a step bucket: {s['compiles']} "
              f"({s['compile_time_s']:.2f}s wall): "
              + " ".join(f"{e['kind']}{e['shape']}"
                         for e in engine.compile_events))
    phases = sorted(s["phase"].items(),
                    key=lambda kv: -kv[1]["mean_us"] * kv[1]["count"])
    print("[serve] phase wall time: "
          + "  ".join(f"{name}={p['mean_us']:.0f}us x{p['count']}"
                      for name, p in phases))
    if args.speculative:
        acc = [o.spec_acceptance_rate for o in outputs if o.spec_drafted]
        print(f"[serve] speculative: {s['spec_rounds']} rounds, "
              f"acceptance {s['spec_acceptance_rate']:.2%} "
              f"(per-request mean {np.mean(acc) if acc else 0.0:.2%}), "
              f"{s['spec_tokens_per_round']:.2f} tokens/round, "
              f"verify recompute rate {s['verify_recompute_rate']:.4f}")
    if args.policy:
        p = s["policy"]
        print(f"[serve] policy: mode={p['mode']} "
              f"({p['mode_transitions']} transitions, "
              f"{p['actuations']} actuations), tau mean {p['tau_mean']:.4f} "
              f"[{p['tau_min']:.4f}, {p['tau_max']:.4f}], "
              f"draft_len={p['draft_len']}")
    if args.audit_rate > 0:
        a = s["audit"]
        if a["enabled"]:
            print(f"[serve] audit: {a['audited_steps']} steps / "
                  f"{a['audited_rows']} rows audited, "
                  f"flip rate {a['flip_rate']:.4f}, "
                  f"logit rel err {a['logit_rel_err']:.3e}, "
                  f"{a['calibrations']} calibrations")
            print("[serve] audit per-layer KQ err: "
                  + " ".join(f"L{i}={e:.2e}"
                             for i, e in enumerate(a["layer_kq_err"])))
            if "targets" in a:
                print("[serve] audit calibrated targets: "
                      + " ".join(f"L{i}={t:.3f}"
                                 for i, t in enumerate(a["targets"]))
                      + f" (guarded: "
                      f"{sum(1 for ok in a['relax_ok'] if not ok)})")
        else:
            print("[serve] audit: disabled (--no-lamp runs have no LAMP "
                  "error to measure)")
    if s["faults"]["enabled"] or s["recoveries"] or s["failed_requests"]:
        f = s["faults"]
        by = (" ".join(f"{k}={v}" for k, v in f["by_site"].items())
              if f["enabled"] else "off")
        print(f"[serve] faults: injected="
              f"{f['injected'] if f['enabled'] else 0} ({by}), "
              f"recoveries={s['recoveries']}, "
              f"failed_requests={s['failed_requests']}")
    # exit non-zero when any request failed alone (timeout, exhausted
    # recovery ladder, stall eviction) or was rejected at admission, so a
    # chaos run can gate on a clean stream
    failed = [o for o in outputs if o.error is not None]
    rejected = args.num_requests - len(outputs)
    for o in failed:
        print(f"[serve] FAILED req {o.req_id} ({o.finish_reason}): "
              f"{o.error}")
    if rejected > 0:
        print(f"[serve] {rejected} request(s) rejected at admission "
              f"(queue bound {args.max_queue})")
    return 1 if failed or rejected > 0 else 0


if __name__ == "__main__":
    raise SystemExit(main())
