"""End-to-end serving on the port (the twin of
``examples/serve_lamp.py``): a batch of prompts against a small model with
LAMP inference, through the static loop (``runtime.serve_loop``).

    PYTHONPATH=src python -m repro_torch.launch.serve_lamp [arch] \
        [--device cuda|cpu]

Prefills 4 prompts of 32 tokens, samples 24 new tokens each (temperature
0.7, seed 7) with LAMP off (FP32) and on, and prints the prefill time,
decode tokens/s and the first sequence's first tokens. Any arch, reduced
(``configs.reduced``); the prompts, whisper's frames and llava's image
embeddings come from a numpy seed (not the JAX example's draws). Runs on
CUDA unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.models import api
from repro_torch.models.transformer import resolve_device
from repro_torch.runtime.serve_loop import ServeConfig, generate

BATCH, PROMPT_LEN, NEW_TOKENS = 4, 32, 24


def make_batch(cfg, batch_size: int, prompt_len: int, device, seed: int = 0):
    """The prompt dict: seeded uniform tokens, and the stub frontends'
    inputs (N(0, 0.1^2) frames for whisper, image embeddings for llava)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch_size, prompt_len))).to(device)}

    def normal(rows):
        x = rng.standard_normal((batch_size, rows, cfg.d_model)) * 0.1
        return torch.from_numpy(x.astype(np.float32)).to(device)

    if cfg.family == "whisper":
        batch["frames"] = normal(cfg.enc_seq)
    if cfg.family == "llava":
        batch["image_embeds"] = normal(cfg.n_patches)
    return batch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch", nargs="?", default="qwen3-moe-30b-a3b",
                    choices=list_archs())
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = reduced(get_config(args.arch))
    params = api.init_params(cfg, 0, device)
    batch = make_batch(cfg, BATCH, PROMPT_LEN, device)
    cache_len = PROMPT_LEN + NEW_TOKENS + cfg.n_patches + cfg.n_meta_tokens + 8
    for use_lamp in (False, True):
        serve = ServeConfig(max_new_tokens=NEW_TOKENS, temperature=0.7,
                            use_lamp=use_lamp, cache_len=cache_len, seed=7)
        out = generate(cfg, params, batch, serve)
        tag = "LAMP" if use_lamp else "FP32"
        print(f"[{tag}] prefill {out['prefill_s']*1e3:6.0f}ms  "
              f"decode {out['decode_tok_per_s']:6.1f} tok/s  "
              f"first-seq tokens: {out['tokens'][0][:8].tolist()}")
    print("\n(LAMP serving: KQ products in PS(mu) with rule-(9) selective "
          "FP32 recompute; MoE router logits under rule (8).)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
