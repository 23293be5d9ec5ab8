"""Batched serving loop with LAMP inference (port of
``repro/runtime/serve_loop.py``).

prefill, then a decode loop with temperature sampling, through the uniform
model API (``models.api``) on every family; and the `logits` LAMP site
(the final unembed -> sampling-softmax composition, the serving analogue
of the paper's KQ site, for the attention-free rwkv6).

The JAX package jits the decode step and caches it per (cfg, use_lamp)
(`_DECODE_CACHE`, `decode_fn`, and `_sample` around the sampler); the
port runs eagerly and calls ``api.decode_step`` and ``sampling.sample``
directly. The loop runs on the device of the batch's tensors.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict

import torch

from repro_torch.core import lamp as L
from repro_torch.core import prng
from repro_torch.core.numerics import round_to_mantissa
from repro_torch.models import api
from repro_torch.serving import sampling


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0     # 0 = greedy
    seed: int = 0
    use_lamp: bool = True
    cache_len: int = 512
    top_k: int = 0               # 0 = unfiltered


def generate(cfg, params, batch: Dict[str, Any], serve: ServeConfig,
             ) -> Dict[str, Any]:
    """batch: the prompt dict (tokens (B, S) and the stub modality inputs)
    on the params' device. Returns the new tokens (B, max_new_tokens)
    int64, `prefill_s` and `decode_tok_per_s`.

    The key schedule is the JAX package's: one ``PRNGKey(seed)``, one
    ``split`` a token, so a sampled stream equals JAX's token for token.
    Timing departs from the JAX loop's on a card only: there the loop
    synchronizes with the device before each clock read, so the two
    figures time the device's work and not the host's enqueueing."""
    tokens = batch["tokens"]
    dev = tokens.device
    B = tokens.shape[0]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cache = api.init_cache(cfg, B, serve.cache_len, torch.float32, device=dev)
    sync()
    t0 = time.monotonic()
    logits, cache = api.prefill(cfg, params, batch, cache,
                                use_lamp=serve.use_lamp)
    sync()
    prefill_s = time.monotonic() - t0
    key = prng.PRNGKey(serve.seed, dev)

    key, sub = prng.split(key)
    toks = sampling.sample(logits[:, -1], sub, serve.temperature,
                           top_k=serve.top_k)[:, None]
    out = [toks]
    sync()
    t0 = time.monotonic()
    for _ in range(serve.max_new_tokens - 1):
        key, sub = prng.split(key)
        logits, cache = api.decode_step(cfg, params, cache, toks,
                                        use_lamp=serve.use_lamp)
        toks = sampling.sample(logits[:, -1], sub, serve.temperature,
                               top_k=serve.top_k)[:, None]
        out.append(toks)
    sync()
    decode_s = time.monotonic() - t0
    return {
        "tokens": torch.cat(out, dim=1),
        "prefill_s": prefill_s,
        "decode_tok_per_s": B * (serve.max_new_tokens - 1) / max(decode_s, 1e-9),
    }


def lamp_logits_softmax(logits: torch.Tensor, mu: int, tau: float):
    """LAMP at the LM-head site: the unembed matmul's output is y and the
    sampling softmax is f; the strict rule (8) flags the logits whose
    rounding to PS(mu) would shift the sampling distribution, and they
    take their FP32 values. Returns (the softmax, the share recomputed)."""
    y_low = round_to_mantissa(logits.float(), mu)
    mask = L.select_softmax_strict(y_low, tau)
    y = torch.where(mask, logits.float(), y_low)
    return L.masked_softmax(y), torch.mean(mask.float())
