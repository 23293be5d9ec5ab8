"""Decoder-only transformer: the paged serving steps (port of
``repro/models/transformer.py:30-60,316-575,735-787``).

Parameters are a dictionary with the JAX package's layout: every block
tensor is stacked with a leading (L,) axis, and the layer ``lax.scan``
becomes a Python loop over those stacks. The paged KV arena is a pair of
(L, n_blocks, block_size, Hkv, hd) tensors; block 0 is the null block that
padding points at and writes into.

Window steps (`paged_mixed_step`, `paged_prefill_window`,
`paged_verify_window`) attend through
``kernels.paged_attention.paged_mixed_attention``; the single-token
`paged_decode_step` of the split step and the speculative draft through
``paged_decode_attention`` (``layers.paged_attention_decode_sublayer``).
Each is the hand-written CUDA kernel for tensors on the card and its plain
gather version for tensors on the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.policy import LampSite
from repro_torch.kernels import paged_attention as PA

from . import layers as LY

FAMILIES = ("dense", "gpt2")


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; CUDA asked for and absent is an error,
    never a quiet fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on CUDA unless device='cpu' is passed, and no "
            "CUDA device is available")
    return dev


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32) * scale


def init_params(cfg, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random weights drawn from a seeded CPU generator (so every device
    gets the same values), with the JAX package's shapes and scales, then
    moved to `device`. Not the JAX package's random bits: tests that need
    both packages on one set of weights use ``convert.params_from_jax``."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"the port serves the {FAMILIES} families, got "
                         f"{cfg.family!r}")
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    L, d, hd, ff = cfg.n_layers, cfg.d_model, cfg.hd, cfg.d_ff
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    attn = {
        "wq": _normal(gen, (L, d, H * hd), d ** -0.5),
        "wk": _normal(gen, (L, d, Hkv * hd), d ** -0.5),
        "wv": _normal(gen, (L, d, Hkv * hd), d ** -0.5),
        "wo": _normal(gen, (L, H * hd, d), (H * hd) ** -0.5),
    }
    if cfg.qk_norm:
        attn["qn_w"] = torch.zeros((L, hd))
        attn["kn_w"] = torch.zeros((L, hd))
    gated = cfg.act in ("swiglu", "geglu")
    blocks: Dict[str, Any] = {
        "attn": attn,
        "mlp": {"wi": _normal(gen, (L, d, 2 * ff if gated else ff), d ** -0.5),
                "wo": _normal(gen, (L, ff, d), ff ** -0.5)},
    }
    params: Dict[str, Any] = {"embed": {"tok": _normal(gen, (cfg.vocab, d), 0.02)},
                              "blocks": blocks}
    if cfg.pos == "learned":
        params["embed"]["pos"] = _normal(gen, (cfg.max_seq, d), 0.01)
    if not cfg.tie_embeddings:
        params["embed"]["unembed"] = _normal(gen, (d, cfg.vocab), d ** -0.5)
    if cfg.norm == "layernorm":
        for n in ("ln1", "ln2"):
            blocks[f"{n}_w"], blocks[f"{n}_b"] = torch.ones((L, d)), torch.zeros((L, d))
        params["lnf_w"], params["lnf_b"] = torch.ones((d,)), torch.zeros((d,))
    else:
        blocks["ln1_w"], blocks["ln2_w"] = torch.zeros((L, d)), torch.zeros((L, d))
        params["lnf_w"] = torch.zeros((d,))
    dt = LY.dtype_of(cfg)
    return map_params(params, lambda t: t.to(device=device, dtype=dt))


def map_params(tree, fn):
    """Apply `fn` to every tensor of a nested parameter dictionary."""
    if isinstance(tree, dict):
        return {k: map_params(v, fn) for k, v in tree.items()}
    return fn(tree)


def layer_params(blocks: Dict[str, Any], l: int) -> Dict[str, Any]:
    """Layer l's slice of the stacked block parameters (views, no copy)."""
    return map_params(blocks, lambda t: t[l])


def init_paged_cache(cfg, n_blocks: int, block_size: int,
                     dtype=torch.float32, device="cuda") -> Dict[str, torch.Tensor]:
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    device = resolve_device(device)
    shape = (L, n_blocks, block_size, Hkv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _serving_site(site: LampSite) -> LampSite:
    """The benchmark-only 'random' control arm is served as the strict rule."""
    if site.enabled and site.rule == "random":
        return site.replace(rule="strict")
    return site


def _kq_site(cfg, use_lamp: bool) -> LampSite:
    kq = cfg.lamp.kq
    return _serving_site(kq if use_lamp and kq.enabled else LampSite(enabled=False))


def paged_prefill_window(cfg, params, tokens, arena, block_tables, starts,
                         lengths, *, use_lamp: bool = True,
                         per_layer: bool = False, taus=None):
    """Prefill a window of each prompt against its block table: logits at
    each row's last valid window position. See ``paged_mixed_step``."""
    return paged_mixed_step(cfg, params, tokens, arena, block_tables, starts,
                            lengths, use_lamp=use_lamp, per_layer=per_layer,
                            taus=taus, all_logits=False)


def paged_verify_window(cfg, params, tokens, arena, block_tables, starts,
                        lengths, *, use_lamp: bool = True,
                        per_layer: bool = False, taus=None):
    """The speculative verifier: row b runs `tokens` at absolute positions
    starts[b] .. starts[b] + lengths[b] - 1, (re)writing their K/V, and
    returns logits for every window position, (B, W, V) -- position j's are
    what a plain decode step at that position would give. Logits past
    lengths[b] are padding. See ``paged_mixed_step``."""
    return paged_mixed_step(cfg, params, tokens, arena, block_tables, starts,
                            lengths, use_lamp=use_lamp, per_layer=per_layer,
                            taus=taus, all_logits=True)


def paged_decode_step(cfg, params, arena, block_tables, lengths, tokens, *,
                      use_lamp: bool = True, per_layer: bool = False,
                      taus: Optional[torch.Tensor] = None):
    """One continuous-batch decode step over the paged arena.

    tokens: (R, 1) last sampled token per row; lengths: (R,) int32 cache
    fill (the new token's K/V land at position lengths[r]; padded rows use
    length 0 and a null block table). `taus` ((L,) float32 on the device)
    carries the per-layer KQ thresholds; the LAMP rule comes from `cfg` (the
    speculative draft passes its draft config). Writes the arena in place
    and returns (logits (R, 1, V), arena, (n_selected, n_valid)): counts
    (R,), or (L, R) with `per_layer`."""
    L = cfg.n_layers
    dev = tokens.device
    x = LY.embed(cfg, params["embed"], tokens.long(), lengths.long()[:, None])
    site = _kq_site(cfg, use_lamp)
    if taus is None:
        taus = torch.full((L,), float(site.tau), dtype=torch.float32, device=dev)
    nsel_l, nval_l = [], []
    for l in range(L):
        p_l = layer_params(params["blocks"], l)
        h = LY.apply_norm(cfg, x, p_l, "ln1")
        a, nsel, nval = LY.paged_attention_decode_sublayer(
            cfg, p_l["attn"], h, arena_k=arena["k"][l], arena_v=arena["v"][l],
            block_tables=block_tables, lengths=lengths, lamp_site=site,
            tau=taus[l])
        x = x + a
        h = LY.apply_norm(cfg, x, p_l, "ln2")
        x = x + LY.mlp_apply(cfg, p_l["mlp"], h)
        nsel_l.append(nsel)
        nval_l.append(nval)
    x = LY.apply_norm(cfg, x, {"lnf_w": params["lnf_w"],
                               "lnf_b": params.get("lnf_b")}, "lnf")
    nsel, nval = torch.stack(nsel_l), torch.stack(nval_l)
    if not per_layer:
        nsel, nval = nsel.sum(dim=0), nval.sum(dim=0)
    return LY.unembed(cfg, params["embed"], x), arena, (nsel, nval)


def paged_mixed_step(cfg, params, tokens, arena, block_tables, starts,
                     lengths, *, use_lamp: bool = True,
                     per_layer: bool = False, taus=None,
                     all_logits: bool = False):
    """One fused serving step over a mixed row batch.

    tokens: (B, W) window tokens left-aligned per row, padded to the bucket
    width W; starts: (B,) tokens already cached per row; lengths: (B,) live
    tokens in this window (1 for a decode row, the chunk width for a
    prefill row; padded rows use starts 0, lengths 1 and a null block
    table). All index tensors live on the parameters' device.

    Writes the window's K/V into `arena` in place and returns (logits,
    arena, (n_selected, n_valid)): logits (B, 1, V) at each row's last
    valid position, or (B, W, V) with `all_logits`; counts (B,), or (L, B)
    with `per_layer`."""
    B = tokens.shape[0]
    x, arena, counts = _paged_window_apply(
        cfg, params, tokens, arena, block_tables, starts, lengths,
        use_lamp=use_lamp, per_layer=per_layer, taus=taus)
    if not all_logits:
        last = torch.clamp(lengths.long(), min=1) - 1
        x = x[torch.arange(B, device=x.device), last][:, None]
    return LY.unembed(cfg, params["embed"], x), arena, counts


def _paged_window_apply(cfg, params, tokens, arena, block_tables, starts,
                        lengths, *, use_lamp: bool, per_layer: bool = False,
                        taus: Optional[torch.Tensor] = None):
    """The layer stack over one window per row: the final-norm hidden
    states (B, W, d), the arena (updated in place), and per-row LAMP
    (n_selected, n_valid). `taus` ((L,) float32 on the device) carries the
    per-layer KQ thresholds; layer l's kernel reads taus[l] from device
    memory."""
    B, W = tokens.shape
    dev = tokens.device
    n_max = block_tables.shape[1]
    bs = arena["k"].shape[2]
    L, H = cfg.n_layers, cfg.n_heads
    starts_l = starts.long()
    positions = starts_l[:, None] + torch.arange(W, device=dev)[None, :]  # (B, W)
    x = LY.embed(cfg, params["embed"], tokens.long(), positions)
    site = _kq_site(cfg, use_lamp)
    valid_tok = torch.arange(W, device=dev)[None, :] < lengths[:, None]
    blk_idx = torch.clamp(positions // bs, 0, n_max - 1)
    blk = torch.where(valid_tok, torch.gather(block_tables.long(), 1, blk_idx), 0)
    off = torch.where(valid_tok, positions % bs, 0)
    qmask = valid_tok.to(torch.float32)
    if taus is None:
        taus = torch.full((L,), float(site.tau), dtype=torch.float32, device=dev)
    # KQ products inside the causal (and window) mask, per query and all heads
    cap = n_max * bs if cfg.window is None else cfg.window
    nval_rows = torch.clamp(positions + 1, 0, cap).to(torch.float32) * H
    zeros = torch.zeros((B,), dtype=torch.float32, device=dev)
    nsel_l, nval_l = [], []
    for l in range(L):
        p_l = layer_params(params["blocks"], l)
        ck, cv = arena["k"][l], arena["v"][l]
        h = LY.apply_norm(cfg, x, p_l, "ln1")
        q, k, v = LY._project_qkv(cfg, p_l["attn"], h, positions)
        # in place: the window's K/V land in the arena slots its block table
        # names (the JAX package returns an updated copy instead); padded
        # tokens all write the null block
        ck[blk, off] = k.to(ck.dtype)
        cv[blk, off] = v.to(cv.dtype)
        qh = q.transpose(1, 2).contiguous()
        o, nsel_rows = PA.paged_mixed_attention(
            qh, ck, cv, block_tables, starts, lengths, site, tau=taus[l],
            window=cfg.window)
        if site.enabled:
            nsel_l.append(torch.sum(nsel_rows * qmask, dim=1))
            nval_l.append(torch.sum(nval_rows * qmask, dim=1))
        else:
            nsel_l.append(zeros)
            nval_l.append(zeros)
        o = o.transpose(1, 2).reshape(B, W, -1).to(x.dtype)
        x = x + o @ p_l["attn"]["wo"]
        h = LY.apply_norm(cfg, x, p_l, "ln2")
        x = x + LY.mlp_apply(cfg, p_l["mlp"], h)
    x = LY.apply_norm(cfg, x, {"lnf_w": params["lnf_w"],
                               "lnf_b": params.get("lnf_b")}, "lnf")
    nsel, nval = torch.stack(nsel_l), torch.stack(nval_l)
    if not per_layer:
        nsel, nval = nsel.sum(dim=0), nval.sum(dim=0)
    return x, arena, (nsel, nval)
