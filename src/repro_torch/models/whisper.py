"""Whisper (arXiv:2212.04356): encoder-decoder speech transformer. Port of
``repro/models/whisper.py``.

The conv / mel frontend is a stub: precomputed frame embeddings (B,
enc_seq, d) go straight into the encoder. Encoder: bidirectional
self-attention. Decoder: causal self-attention, then cross-attention to
the encoder output. LayerNorm and GELU, learned positions, tied decoder
embeddings. LAMP applies at all three softmax sites (encoder
self-attention, decoder self-attention, cross-attention).

Serving: prefill encodes the frames, stores every layer's cross K/V in
the cache's dtype and fills the decoder's self-attention cache; a decode
step projects q from the decoder state at position `length` for both
attentions and reads the cross K/V back in the model's dtype. The
self-attention cache is written in place.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core import tree as T

from . import layers as LY
from .transformer import layer_params, next_token_nll, resolve_device


def _norm_params(lead, d, names):
    out = {}
    for n in names:
        out[f"{n}_w"], out[f"{n}_b"] = torch.ones(lead + (d,)), torch.zeros(lead + (d,))
    return out


def init_params(cfg, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Seeded random weights with the JAX package's layout, shapes and
    scales (see ``transformer.init_params``)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    d = cfg.d_model
    enc_lead, dec_lead = (cfg.n_enc_layers,), (cfg.n_layers,)
    enc = {**_norm_params(enc_lead, d, ("ln1", "ln2")),
           "attn": LY.attn_params(cfg, gen, enc_lead),
           "mlp": LY.mlp_params(cfg, gen, enc_lead)}
    dec = {**_norm_params(dec_lead, d, ("ln1", "ln2", "ln3")),
           "attn": LY.attn_params(cfg, gen, dec_lead),
           "xattn": LY.attn_params(cfg, gen, dec_lead),
           "mlp": LY.mlp_params(cfg, gen, dec_lead)}
    params = {"embed": LY.embed_params(cfg, gen),
              "enc_pos": LY.normal(gen, (cfg.enc_seq, d), 0.01),
              "enc_blocks": enc, "dec_blocks": dec,
              **_norm_params((), d, ("enc_lnf", "lnf"))}
    dt = LY.dtype_of(cfg)
    return T.map(lambda t: t.to(device=device, dtype=dt), params)


def encode(cfg, params, frames: torch.Tensor, *, use_lamp: bool = False,
           attn_impl: str = "auto") -> torch.Tensor:
    """frames: (B, enc_seq, d) precomputed embeddings (the frontend stub)
    -> the encoder output (B, enc_seq, d)."""
    x = frames.to(LY.dtype_of(cfg)) + params["enc_pos"][None]
    positions = torch.arange(x.shape[1], device=x.device)
    site = LY.kq_site(cfg, use_lamp)
    for l in range(cfg.n_enc_layers):
        p_l = layer_params(params["enc_blocks"], l)
        h = LY.layer_norm(x, p_l["ln1_w"], p_l["ln1_b"])
        a, _ = LY.attention_sublayer(cfg, p_l["attn"], h, positions=positions,
                                     lamp_site=site, causal=False,
                                     attn_impl=attn_impl)
        x = x + a
        h = LY.layer_norm(x, p_l["ln2_w"], p_l["ln2_b"])
        x = x + LY.mlp_apply(cfg, p_l["mlp"], h)
    return LY.layer_norm(x, params["enc_lnf_w"], params["enc_lnf_b"])


def _cross_kv(cfg, p_x, enc_out):
    B, Te, _ = enc_out.shape
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    k = (enc_out @ p_x["wk"]).reshape(B, Te, Hkv, hd)
    v = (enc_out @ p_x["wv"]).reshape(B, Te, Hkv, hd)
    return k, v


def _decoder_layer(cfg, p_l, x, positions, site, attn_impl, kv):
    """One teacher-forced decoder layer: self-attention, cross-attention
    on `kv`, MLP. Returns (x, the self-attention's (k, v) (B, T, Hkv, hd),
    which prefill caches)."""
    h = LY.layer_norm(x, p_l["ln1_w"], p_l["ln1_b"])
    q, k, v = LY._project_qkv(cfg, p_l["attn"], h, positions)
    a, _ = LY.attention_out(cfg, p_l["attn"], q, k, v, site,
                            attn_impl=attn_impl, random_control=True)
    x = x + a
    h = LY.layer_norm(x, p_l["ln2_w"], p_l["ln2_b"])
    a, _ = LY.attention_sublayer(cfg, p_l["xattn"], h, positions=positions,
                                 lamp_site=site, causal=False,
                                 attn_impl=attn_impl, kv=kv)
    x = x + a
    h = LY.layer_norm(x, p_l["ln3_w"], p_l["ln3_b"])
    return x + LY.mlp_apply(cfg, p_l["mlp"], h), (k, v)


def _decoder_body(cfg, p_l, x, positions, site, attn_impl, enc_out):
    """One layer of `decode_full`, its cross K/V projected inside (the JAX
    package's scan body, which remat recomputes whole)."""
    x, _ = _decoder_layer(cfg, p_l, x, positions, site, attn_impl,
                          _cross_kv(cfg, p_l["xattn"], enc_out))
    return x


def decode_full(cfg, params, tokens: torch.Tensor, enc_out: torch.Tensor, *,
                use_lamp: bool = False, attn_impl: str = "auto",
                remat: bool = False):
    """The teacher-forced decoder over the whole token sequence: logits
    (B, S, V). `remat` checkpoints each layer (``layers.remat_call``)."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = LY.embed(cfg, params["embed"], tokens.long(), positions)
    site = LY.kq_site(cfg, use_lamp)
    for l in range(cfg.n_layers):
        x = LY.remat_call(remat, _decoder_body, cfg,
                          layer_params(params["dec_blocks"], l), x, positions,
                          site, attn_impl, enc_out)
    x = LY.layer_norm(x, params["lnf_w"], params["lnf_b"])
    return LY.unembed(cfg, params["embed"], x)


def forward(cfg, params, tokens, *, frames=None, use_lamp: bool = False,
            attn_impl: str = "auto", remat: bool = False, **_):
    """(logits, {}); `remat` checkpoints the decoder's layers, as in the
    JAX package (the encoder's are not)."""
    enc_out = encode(cfg, params, frames, use_lamp=use_lamp, attn_impl=attn_impl)
    return decode_full(cfg, params, tokens, enc_out, use_lamp=use_lamp,
                       attn_impl=attn_impl, remat=remat), {}


def loss_fn(cfg, params, batch, *, use_lamp: bool = False, remat: bool = True,
            attn_impl: str = "auto", **_):
    """Next-token cross entropy. Returns (loss, metrics)."""
    logits, aux = forward(cfg, params, batch["tokens"], frames=batch["frames"],
                          use_lamp=use_lamp, attn_impl=attn_impl, remat=remat)
    loss = next_token_nll(logits, batch["tokens"])
    return loss, {"loss": loss, **aux}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda") -> Dict[str, torch.Tensor]:
    """The decoder's self-attention cache k, v (L, batch, max_len, Hkv, hd),
    the cross K/V xk, xv (L, batch, enc_seq, Hkv, hd) and `length`."""
    device = resolve_device(device)
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd

    def zeros(T):
        return torch.zeros((L, batch, T, Hkv, hd), dtype=dtype, device=device)

    return {"k": zeros(max_len), "v": zeros(max_len),
            "xk": zeros(cfg.enc_seq), "xv": zeros(cfg.enc_seq),
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}


def prefill(cfg, params, tokens, cache, *, frames=None, use_lamp: bool = True,
            attn_impl: str = "auto", **_):
    """Encode the frames, store each layer's cross K/V and the prompt's
    self-attention K/V. Returns (last-position logits (B, 1, V), cache)
    with length S."""
    B, S = tokens.shape
    enc_out = encode(cfg, params, frames, use_lamp=use_lamp, attn_impl=attn_impl)
    positions = torch.arange(S, device=tokens.device)
    x = LY.embed(cfg, params["embed"], tokens.long(), positions)
    site = LY.kq_site(cfg, use_lamp)
    for l in range(cfg.n_layers):
        p_l = layer_params(params["dec_blocks"], l)
        xk, xv = _cross_kv(cfg, p_l["xattn"], enc_out)
        cache["xk"][l] = xk.to(cache["xk"].dtype)
        cache["xv"][l] = xv.to(cache["xv"].dtype)
        x, (k, v) = _decoder_layer(cfg, p_l, x, positions, site, attn_impl,
                                   (xk, xv))
        cache["k"][l, :, :S] = k.to(cache["k"].dtype)
        cache["v"][l, :, :S] = v.to(cache["v"].dtype)
    x = LY.layer_norm(x[:, -1:], params["lnf_w"], params["lnf_b"])
    return LY.unembed(cfg, params["embed"], x), dict(
        cache, length=torch.full((B,), S, dtype=torch.int32, device=x.device))


def decode_step(cfg, params, cache, tokens, *, use_lamp: bool = True, **_):
    """One token: self-attention against the cache (written in place),
    cross-attention against the stored cross K/V. Returns (logits (B, 1,
    V), cache with length + 1)."""
    length = cache["length"]
    x = LY.embed(cfg, params["embed"], tokens.long(), length.long()[:, None])
    site = LY.kq_site(cfg, use_lamp)
    for l in range(cfg.n_layers):
        p_l = layer_params(params["dec_blocks"], l)
        h = LY.layer_norm(x, p_l["ln1_w"], p_l["ln1_b"])
        a, _, _, _ = LY.attention_decode_sublayer(
            cfg, p_l["attn"], h, cache_k=cache["k"][l], cache_v=cache["v"][l],
            length=length, lamp_site=site)
        x = x + a
        h = LY.layer_norm(x, p_l["ln2_w"], p_l["ln2_b"])
        xk, xv = cache["xk"][l], cache["xv"][l]
        a, _, _, _ = LY.attention_decode_sublayer(
            cfg, p_l["xattn"], h, cache_k=xk, cache_v=xv, length=length,
            lamp_site=site, kv_cross=(xk.to(x.dtype), xv.to(x.dtype)))
        x = x + a
        h = LY.layer_norm(x, p_l["ln3_w"], p_l["ln3_b"])
        x = x + LY.mlp_apply(cfg, p_l["mlp"], h)
    x = LY.layer_norm(x, params["lnf_w"], params["lnf_b"])
    return LY.unembed(cfg, params["embed"], x), dict(cache, length=length + 1)
