"""Shared model layers (port of ``repro/models/layers.py:27-123,245-306,
326-375``).

Plain functions over parameter dictionaries, in the config dtype with FP32
islands where the JAX package has them (norm statistics, final logits).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.policy import LampSite
from repro_torch.kernels import paged_attention as PA

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()
    return out.to(x.dtype)


def apply_norm(cfg, x: torch.Tensor, p: Dict[str, torch.Tensor],
               prefix: str) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p[f"{prefix}_w"], p[f"{prefix}_b"])
    return rms_norm(x, p[f"{prefix}_w"])


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         fraction: float = 1.0) -> torch.Tensor:
    """x: (B, T, H, D); positions: (B, T) or (T,). Rotates the first
    `fraction` of D."""
    D = x.shape[-1]
    rot = int(D * fraction) // 2 * 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    ang = ang[None, :, None, :] if positions.ndim == 1 else ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., :half].float(), xr[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def _project_qkv(cfg, p, x: torch.Tensor, positions: torch.Tensor):
    B, T, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, T, H, hd)
    k = (x @ p["wk"]).reshape(B, T, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, T, Hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["qn_w"])
        k = rms_norm(k, p["kn_w"])
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def paged_attention_decode_sublayer(cfg, p, x: torch.Tensor, *, arena_k,
                                    arena_v, block_tables, lengths,
                                    lamp_site: LampSite,
                                    window: Optional[int] = None, tau=None):
    """Single-token decode against a paged KV arena (one layer).

    x: (R, 1, d) hidden states; arena_k / arena_v: (n_blocks, block_size,
    Hkv, hd), updated in place (the JAX package returns updated copies);
    block_tables: (R, n_max) int32; lengths: (R,) int32 tokens already
    cached -- the new token's K/V land at position lengths[r], block
    block_tables[r, lengths // bs], offset lengths % bs, and attention runs
    at the effective length lengths + 1. `tau` (a float32 value on the
    device) overrides the site's threshold. Returns (out (R, 1, d),
    n_selected (R,), n_valid (R,)); n_valid = min(lengths + 1, window) * H
    whatever the site, as in the JAX kernel branch."""
    R = x.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    bs, n_max = arena_k.shape[1], block_tables.shape[1]
    q, k, v = _project_qkv(cfg, p, x, lengths[:, None])
    ln = lengths.long()
    rows = torch.arange(R, device=x.device)
    # JAX clamps an out-of-range gather index; so does this lookup
    blk = block_tables.long()[rows, torch.clamp(ln // bs, max=n_max - 1)]
    off = ln % bs
    arena_k[blk, off] = k[:, 0].to(arena_k.dtype)
    arena_v[blk, off] = v[:, 0].to(arena_v.dtype)
    window = window if window is not None else cfg.window
    eff = lengths + 1
    out, nsel = PA.paged_decode_attention(
        q.transpose(1, 2).contiguous(), arena_k, arena_v, block_tables, eff,
        lamp_site, tau=tau, window=window)
    cap = eff if window is None else torch.clamp(eff, max=window)
    nval = cap.to(torch.float32) * H
    out = out.transpose(1, 2).reshape(R, 1, H * hd).to(x.dtype)
    return out @ p["wo"], nsel, nval


def mlp_apply(cfg, p, x: torch.Tensor) -> torch.Tensor:
    h = x @ p["wi"]
    if cfg.act in ("swiglu", "geglu"):
        ff = p["wo"].shape[0]
        g, u = h[..., :ff].float(), h[..., ff:].float()
        act = F.silu(g) if cfg.act == "swiglu" else F.gelu(g, approximate="tanh")
        h = (act * u).to(x.dtype)
    elif cfg.act == "gelu":
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    elif cfg.act == "relu2":
        r = F.relu(h.float())
        h = (r * r).to(x.dtype)
    else:
        raise ValueError(f"unknown act {cfg.act!r}")
    return h @ p["wo"]


def embed(cfg, p, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    x = p["tok"][tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    if cfg.pos == "learned":
        # padding positions may run past the table; JAX clamps such gathers
        x = x + p["pos"][torch.clamp(positions, max=p["pos"].shape[0] - 1)]
    return x


def unembed(cfg, p, x: torch.Tensor) -> torch.Tensor:
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    return x.float() @ w.float()
