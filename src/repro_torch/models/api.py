"""One model API across all families (port of ``repro/models/api.py``).

    init_params(cfg, seed, device)              -> params dictionary
    loss_fn(cfg, params, batch, **kw)           -> (loss, metrics) [train]
    forward_logits(cfg, params, batch, **kw)    -> logits
    init_cache(cfg, batch_size, max_len, dtype, device) -> cache / state
    prefill(cfg, params, batch, cache, **kw)    -> (last_logits, cache)
    decode_step(cfg, params, cache, tok, **kw)  -> (logits, cache)

`batch` is a dict: tokens (B, S) always; frames (B, enc_seq, d) for
whisper; image_embeds (B, P, d) for llava. The modality frontends are
stubs: those tensors arrive precomputed. The weights are drawn from a
seeded torch generator (``transformer.init_params``), not JAX's bits.
Where a family takes fewer arguments, the JAX package's pops drop them.
`loss_fn` passes `remat` on to every family (on by default, as in the JAX
package: each layer is checkpointed for the backward).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from . import hymba, rwkv, transformer, whisper

_DENSE_FAMILIES = transformer.DENSE_FAMILIES


def _unknown(cfg):
    return ValueError(f"unknown family {cfg.family!r}")


def init_params(cfg, seed: int = 0, device="cuda"):
    if cfg.family in _DENSE_FAMILIES:
        return transformer.init_params(cfg, seed, device)
    if cfg.family == "rwkv6":
        return rwkv.init_params(cfg, seed, device)
    if cfg.family == "hymba":
        return hymba.init_params(cfg, seed, device)
    if cfg.family == "whisper":
        return whisper.init_params(cfg, seed, device)
    raise _unknown(cfg)


def loss_fn(cfg, params, batch: Dict[str, Any], **kw):
    if cfg.family in _DENSE_FAMILIES:
        return transformer.loss_fn(cfg, params, batch, **kw)
    if cfg.family == "rwkv6":
        kw.pop("use_lamp", None)
        kw.pop("attn_impl", None)
        kw.pop("moe_groups", None)
        return rwkv.loss_fn(cfg, params, batch, **kw)
    if cfg.family == "hymba":
        kw.pop("moe_groups", None)
        return hymba.loss_fn(cfg, params, batch, **kw)
    if cfg.family == "whisper":
        kw.pop("moe_groups", None)
        return whisper.loss_fn(cfg, params, batch, **kw)
    raise _unknown(cfg)


def forward_logits(cfg, params, batch: Dict[str, Any], **kw):
    if cfg.family in _DENSE_FAMILIES:
        logits, _ = transformer.forward(cfg, params, batch["tokens"],
                                        image_embeds=batch.get("image_embeds"),
                                        **kw)
        return logits
    if cfg.family == "rwkv6":
        kw.pop("use_lamp", None)
        kw.pop("attn_impl", None)
        logits, _, _ = rwkv.forward(cfg, params, batch["tokens"], **kw)
        return logits
    if cfg.family == "hymba":
        logits, _, _ = hymba.forward(cfg, params, batch["tokens"], **kw)
        return logits
    if cfg.family == "whisper":
        logits, _ = whisper.forward(cfg, params, batch["tokens"],
                                    frames=batch["frames"], **kw)
        return logits
    raise _unknown(cfg)


def init_cache(cfg, batch_size: int, max_len: int, dtype=torch.bfloat16,
               device="cuda"):
    """The family's cache, on `device`. rwkv6's is its recurrent state,
    whatever max_len and dtype (its S is FP32)."""
    if cfg.family in _DENSE_FAMILIES:
        return transformer.init_cache(cfg, batch_size, max_len, dtype, device)
    if cfg.family == "rwkv6":
        return rwkv.init_state(cfg, batch_size, device=device)
    if cfg.family == "hymba":
        return hymba.init_cache(cfg, batch_size, max_len, dtype, device)
    if cfg.family == "whisper":
        return whisper.init_cache(cfg, batch_size, max_len, dtype, device)
    raise _unknown(cfg)


def prefill(cfg, params, batch: Dict[str, Any], cache, **kw):
    if cfg.family in _DENSE_FAMILIES:
        return transformer.prefill(cfg, params, batch["tokens"], cache,
                                   image_embeds=batch.get("image_embeds"), **kw)
    if cfg.family == "rwkv6":
        kw.pop("use_lamp", None)
        kw.pop("attn_impl", None)
        return rwkv.prefill(cfg, params, batch["tokens"], cache, **kw)
    if cfg.family == "hymba":
        return hymba.prefill(cfg, params, batch["tokens"], cache, **kw)
    if cfg.family == "whisper":
        return whisper.prefill(cfg, params, batch["tokens"], cache,
                               frames=batch["frames"], **kw)
    raise _unknown(cfg)


def decode_step(cfg, params, cache, tokens, **kw):
    if cfg.family in _DENSE_FAMILIES:
        return transformer.decode_step(cfg, params, cache, tokens, **kw)
    if cfg.family == "rwkv6":
        kw.pop("use_lamp", None)
        return rwkv.decode_step(cfg, params, cache, tokens, **kw)
    if cfg.family == "hymba":
        return hymba.decode_step(cfg, params, cache, tokens, **kw)
    if cfg.family == "whisper":
        return whisper.decode_step(cfg, params, cache, tokens, **kw)
    raise _unknown(cfg)
