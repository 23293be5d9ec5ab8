"""Serve a batch of synthetic requests with the port's LAMP engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2 --reduced \
        --num-requests 8 --device cpu [--speculative [--draft-len 4]]

Weights are random, drawn from `--seed`. Prompts of 8-48 tokens (a third of
them opening with one shared 16-token prefix, so prefix caching has work)
all arrive at once; every request generates 16 tokens greedily. Prints one
line per finished request and a summary: throughput, steps, prefix-cache
hit rate and the LAMP recompute rate; with `--speculative` also rounds,
acceptance, tokens per round and the verify pass's recompute rate. Runs on
CUDA unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, list_archs, reduced as reduce_cfg
from repro_torch.models import transformer
from repro_torch.serving import EngineConfig, LampEngine, SamplingParams
from repro_torch.serving.engine import TEXT_FAMILIES


def servable_archs():
    return [a for a in list_archs() if get_config(a).family in TEXT_FAMILIES]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gpt2", choices=servable_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the config to CPU-smoke scale")
    ap.add_argument("--num-requests", type=int, default=8)
    ap.add_argument("--device", default="cuda")
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
    args = ap.parse_args(argv)
    if args.num_requests < 1:
        ap.error("--num-requests must be >= 1")
    device = transformer.resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    params = transformer.init_params(cfg, args.seed, device=device)
    engine = LampEngine(cfg, params, EngineConfig(
        max_model_len=min(cfg.max_seq, 256), max_prefill_tokens=64,
        use_lamp=not args.no_lamp, speculative=args.speculative,
        draft_len=args.draft_len, device=str(device)))
    rng = np.random.default_rng(args.seed)
    shared = rng.integers(0, cfg.vocab, size=16).tolist()
    for i in range(args.num_requests):
        prompt = rng.integers(0, cfg.vocab,
                              size=int(rng.integers(8, 33))).tolist()
        if i % 3 == 0:
            prompt = shared + prompt
        engine.add_request(prompt, SamplingParams(max_new_tokens=16, seed=i))
    t0 = time.perf_counter()
    outs = engine.run_to_completion()
    wall = time.perf_counter() - t0
    for o in sorted(outs, key=lambda o: o.req_id):
        print(f"[serve] req {o.req_id}: prompt={len(o.prompt)} "
              f"new={len(o.tokens)} ({o.finish_reason}) "
              f"lamp_rate={o.lamp_recompute_rate:.4f}")
    s = engine.stats()
    print(f"[serve] {cfg.name} on {device}: {s['num_finished']} requests, "
          f"{s['steps']} mixed steps, {engine.generated_tokens} tokens in "
          f"{wall:.3f} s ({engine.generated_tokens / wall:.1f} tok/s), "
          f"prefix hit rate {s['cache_hit_rate']:.3f}, "
          f"prefill chunks {s['prefill_chunks']}, "
          f"LAMP recompute rate {s['lamp_recompute_rate']:.4f}")
    if args.speculative:
        acc = [o.spec_acceptance_rate for o in outs if o.spec_drafted]
        print(f"[serve] speculative: {s['spec_rounds']} rounds, "
              f"acceptance {s['spec_acceptance_rate']:.2%} "
              f"(per-request mean {np.mean(acc) if acc else 0.0:.2%}), "
              f"{s['spec_tokens_per_round']:.2f} tokens/round, "
              f"verify recompute rate {s['verify_recompute_rate']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
