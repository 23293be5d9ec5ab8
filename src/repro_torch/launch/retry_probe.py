"""Rung 0 of the recovery ladder at one row: is a quarantined row's
one-row retry bit-identical to the row of the batched step it replaces?

    PYTHONPATH=src python -m repro_torch.launch.retry_probe [--device cpu]

Serves GPT-2 small at full width (random weights from ``--seed``; the
stream of ``chip_smoke.py``'s phase ``engine``: 8 greedy requests, prompts
of 32-256 tokens, 32 new tokens each) twice: fault-free, then with NaN
injected into about half the steps (``FaultConfig(salt=5, nan_rate=0.5)``,
speculation off). In the second run ``transformer.paged_mixed_step`` is
wrapped: each one-row call (a retry) is held against the batched call
before it, at the row with the same block table, start and window --
final logits equal in every bit, and the largest absolute difference.
Prints one JSON line: retried rows, rows bit-equal, that difference,
retries the engine counted, and whether the greedy tokens equal the
fault-free run's. ``--reduced`` runs the 2-layer, 64-wide config with
prompts an eighth as long (the CPU test). A measurement, not a check:
nothing in the port calls it.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import transformer
from repro_torch.serving import (EngineConfig, FaultConfig, LampEngine,
                                 SamplingParams)

LENS = [256, 40, 180, 96, 32, 220, 128, 60]


class RetryProbe:
    """Wraps ``transformer.paged_mixed_step``: holds each one-row retry's
    final logits against the batched call before it, at the row with the
    same block table, start and window (bits equal, max abs difference)."""

    def __init__(self):
        self.rows = self.equal = 0
        self.max_diff = 0.0
        self.last = None

    def __enter__(self):
        self.inner = transformer.paged_mixed_step

        def step(cfg, params, tokens, arena, bt, starts, qlens, **kw):
            out = self.inner(cfg, params, tokens, arena, bt, starts, qlens,
                             **kw)
            hit = []
            if tokens.shape[0] == 1 and self.last is not None:
                # a retry re-runs a row of the step before it; a step of
                # its own never repeats a row's (table, start, window)
                pbt, pstarts, pqlens, plogits = self.last
                hit = ((pbt == bt[0]).all(1) & (pstarts == starts[0])
                       & (pqlens == qlens[0])).nonzero()
            if len(hit) != 1:
                self.last = (bt, starts, qlens, out[0])
                return out
            a, b = plogits[hit[0, 0], -1], out[0][0, -1]
            self.rows += 1
            self.equal += bool(torch.equal(a, b))
            self.max_diff = max(self.max_diff, (a - b).abs().max().item())
            return out

        transformer.paged_mixed_step = step
        return self

    def __exit__(self, *exc):
        transformer.paged_mixed_step = self.inner


def requests(vocab: int, scale: int) -> List[List[int]]:
    """Phase ``engine``'s prompts (lengths divided by `scale`)."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, size=64).tolist()
    out = []
    for i, n in enumerate(LENS):
        body = rng.integers(0, vocab, size=n).tolist()
        prompt = (shared + body)[:n] if i % 3 == 0 else body
        out.append(prompt[:max(4, n // scale)])
    return out


def serve(cfg, params, prompts, device, new_tokens, faults=FaultConfig()):
    eng = LampEngine(cfg, params, EngineConfig(
        block_size=16, max_model_len=320, n_blocks=8 * 20 + 1,
        max_prefill_tokens=128, device=device, faults=faults))
    for i, prompt in enumerate(prompts):
        eng.add_request(prompt, SamplingParams(max_new_tokens=new_tokens,
                                               seed=i))
    outs = eng.run_to_completion()
    return eng, {o.req_id: o.tokens for o in outs}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    cfg = get_config("gpt2-small")
    scale, new_tokens = 1, 32
    if args.reduced:
        cfg, scale, new_tokens = reduced(get_config("gpt2")), 8, 8
    params = transformer.init_params(cfg, args.seed, device=args.device)
    prompts = requests(cfg.vocab, scale)
    _, base = serve(cfg, params, prompts, args.device, new_tokens)
    with RetryProbe() as probe:
        eng, tokens = serve(cfg, params, prompts, args.device, new_tokens,
                            FaultConfig(enabled=True, salt=5, nan_rate=0.5))
    fam = eng.obs.registry.get("engine_recoveries_total")
    retries = sum(int(c.value) for key, c in fam.items()
                  if key[0] == "retry")
    dev = args.device
    result = {"device": (torch.cuda.get_device_name(0) if dev == "cuda"
                         else dev),
              "config": cfg.name, "rows": probe.rows,
              "bits_equal": probe.equal, "max_abs_diff": probe.max_diff,
              "retries": retries, "failed": eng.stats()["failed_requests"],
              "tokens_equal_fault_free": tokens == base}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
