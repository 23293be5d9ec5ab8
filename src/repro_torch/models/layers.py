"""Shared model layers (port of ``repro/models/layers.py:27-375``).

Plain functions over parameter dictionaries, in the config dtype with FP32
islands where the JAX package has them (norm statistics, final logits).
The parameter makers draw FP32 values from a seeded torch generator with
the JAX package's shapes and scales (not its random bits); the caller
casts them to the model's dtype.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import attention as A
from repro_torch.core import prng
from repro_torch.core.policy import LampSite
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import paged_attention as PA

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

# attention paths over the paged arena (the JAX package's `kernel`
# argument): "cuda" calls the kernel wrappers, which launch the kernels for
# CUDA tensors and run their plain versions for CPU tensors; "gather" calls
# the plain versions by name, on any device
KERNELS = ("cuda", "gather")


def check_kernel(kernel: str) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")


def paged_attention_fns(kernel: str):
    """(mixed-row, decode) paged attention of attention path `kernel`,
    looked up when called, so a caller that wraps the wrappers' module
    attributes sees the calls."""
    check_kernel(kernel)
    if kernel == "cuda":
        return PA.paged_mixed_attention, PA.paged_decode_attention
    return PA.paged_mixed_attention_plain, PA.paged_decode_attention_plain


def remat_call(remat: bool, fn, *args, **kwargs):
    """fn(*args, **kwargs); with `remat`, under activation checkpointing
    (``torch.utils.checkpoint``, non-reentrant): the backward recomputes
    fn's activations instead of keeping them, as ``jax.checkpoint`` wraps
    the JAX package's layer-scan body."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return fn(*args, **kwargs)


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def kq_site(cfg, use_lamp: bool) -> LampSite:
    """The config's KQ site with LAMP on, a disabled site without it."""
    kq = cfg.lamp.kq
    return kq if use_lamp and kq.enabled else LampSite(enabled=False)


def normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32) * scale


def attn_params(cfg, gen: torch.Generator, lead=()) -> Dict[str, torch.Tensor]:
    """One attention sublayer's projections (of `lead` layers stacked)."""
    lead = tuple(lead)
    d, hd, H, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    p = {"wq": normal(gen, lead + (d, H * hd), d ** -0.5),
         "wk": normal(gen, lead + (d, Hkv * hd), d ** -0.5),
         "wv": normal(gen, lead + (d, Hkv * hd), d ** -0.5),
         "wo": normal(gen, lead + (H * hd, d), (H * hd) ** -0.5)}
    if cfg.qk_norm:
        p["qn_w"] = torch.zeros(lead + (hd,))
        p["kn_w"] = torch.zeros(lead + (hd,))
    return p


def mlp_params(cfg, gen: torch.Generator, lead=()) -> Dict[str, torch.Tensor]:
    lead = tuple(lead)
    d, ff = cfg.d_model, cfg.d_ff
    gated = cfg.act in ("swiglu", "geglu")
    return {"wi": normal(gen, lead + (d, 2 * ff if gated else ff), d ** -0.5),
            "wo": normal(gen, lead + (ff, d), ff ** -0.5)}


def embed_params(cfg, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    p = {"tok": normal(gen, (cfg.vocab, cfg.d_model), 0.02)}
    if cfg.pos == "learned":
        p["pos"] = normal(gen, (cfg.max_seq, cfg.d_model), 0.01)
    if not cfg.tie_embeddings:
        p["unembed"] = normal(gen, (cfg.d_model, cfg.vocab), cfg.d_model ** -0.5)
    return p


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


def _repeat_kv(t: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return t
    return torch.repeat_interleave(t, n_rep, dim=1)


# the online softmax's KV block under attn_impl "chunked" (the JAX
# sublayer's default)
CHUNK_BLOCK = 512


def attention_out(cfg, p, q, k, v, lamp_site: LampSite, *,
                  causal: bool = True, attn_impl: str = "auto",
                  random_control: bool = False):
    """The attention sublayer after its projections: q (B, T, H, hd)
    against k, v (B, Tk, Hkv, hd) over `cfg.window` keys, then `wo`.
    Returns (out (B, T, d), recompute rate as a 0-d tensor). A caller that
    also caches k and v projects them once.

    `attn_impl` "full" materializes the logits (``attention_lamp``, or
    ``attention_reference`` with LAMP off); "chunked" runs the online
    softmax over KV blocks of ``CHUNK_BLOCK`` keys, where LAMP takes the
    relaxed rule whatever the site names and the site's `onepass` picks the
    threshold; "auto" is "full" up to 2048 positions. With
    `random_control` the rule "random" is the App C.4 control arm: the
    strict rule's counts at random positions, under ``PRNGKey(0)`` (the
    sublayer's use); without it that rule raises, as the JAX package's
    prefill does."""
    out, rate = attend(cfg, q, k, v, lamp_site, causal=causal,
                       attn_impl=attn_impl, random_control=random_control)
    return out @ p["wo"], rate


def attend(cfg, q, k, v, lamp_site: LampSite, *, causal: bool = True,
           attn_impl: str = "auto", random_control: bool = False,
           kv_index: Optional[torch.Tensor] = None):
    """`attention_out` before `wo`: q (B, T, Hq, hd) against k, v (B, Tk,
    Hk, hd), query head i reading KV head i // (Hq // Hk), or KV head
    kv_index[i] when given (a rank's heads of a split that cuts a query
    group). Returns ((B, T, Hq * hd) in q's dtype, rate)."""
    B, T = q.shape[:2]
    dtype, window = q.dtype, cfg.window
    q = q.transpose(1, 2)
    if kv_index is None:
        n_rep = q.shape[1] // k.shape[2]
        k = _repeat_kv(k.transpose(1, 2), n_rep)
        v = _repeat_kv(v.transpose(1, 2), n_rep)
    else:
        k = k.transpose(1, 2).index_select(1, kv_index)
        v = v.transpose(1, 2).index_select(1, kv_index)
    if attn_impl == "auto":
        attn_impl = "full" if max(T, k.shape[2]) <= 2048 else "chunked"
    rate = torch.zeros((), dtype=torch.float32, device=q.device)
    if attn_impl == "full":
        if lamp_site.enabled:
            if random_control and lamp_site.rule == "random":
                out, aux = A.attention_lamp(
                    q, k, v, lamp_site.replace(rule="strict"), causal=causal,
                    window=window, random_key=prng.PRNGKey(0, q.device))
            else:
                out, aux = A.attention_lamp(q, k, v, lamp_site, causal=causal,
                                            window=window)
            rate = aux.recompute_rate
        else:
            out = A.attention_reference(q, k, v, causal=causal, window=window)
    elif attn_impl == "chunked":
        if lamp_site.enabled:
            site = lamp_site if lamp_site.rule == "relaxed" \
                else lamp_site.replace(rule="relaxed")
            out, aux = A.chunked_attention_lamp(q, k, v, site, causal=causal,
                                                block=CHUNK_BLOCK,
                                                window=window,
                                                onepass=site.onepass)
            rate = aux.recompute_rate
        else:
            out = A.chunked_attention(q, k, v, causal=causal,
                                      block=CHUNK_BLOCK, window=window)
    else:
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    return out.transpose(1, 2).reshape(B, T, -1).to(dtype), rate


def attention_sublayer(cfg, p, x: torch.Tensor, *, positions: torch.Tensor,
                       lamp_site: LampSite, causal: bool = True,
                       attn_impl: str = "auto", kv=None):
    """Full-sequence attention (the paper's evaluation, the encoder) over
    `cfg.window` keys. Returns (out, recompute rate as a 0-d tensor); see
    `attention_out`, which runs the rule "random" as the control arm here.
    `kv`:
    (k, v) in (B, Tk, Hkv, hd) supplied from outside (the whisper
    decoder's cross-attention): q comes from x, k and v from the
    encoder."""
    q, k, v = _project_qkv(cfg, p, x, positions)
    if kv is not None:
        k, v = kv
    return attention_out(cfg, p, q, k, v, lamp_site, causal=causal,
                         attn_impl=attn_impl, random_control=True)


def _write_new(cache, new, slot):
    """cache (B, S_l, Hkv, hd) in place: row b's new K or V (B, Hkv, hd) at
    local position slot[b]; a slot outside [0, S_l) writes nothing."""
    S_l = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    slot_c = torch.clamp(slot.long(), 0, S_l - 1)
    keep = ((slot >= 0) & (slot < S_l))[:, None, None]
    cache[rows, slot_c] = torch.where(keep, new.to(cache.dtype),
                                      cache[rows, slot_c])


def attention_decode_sublayer(cfg, p, x: torch.Tensor, *, cache_k, cache_v,
                              length, lamp_site: LampSite, kv_cross=None):
    """Single-token decode against a dense cache (one layer).

    x: (B, 1, d); cache_k / cache_v: (B, S, Hkv, hd), written in place (the
    JAX package returns updated copies): the new token's K/V land at
    position length[b], and a write past S is dropped, as JAX's scatter
    drops it. Attention runs through ``decode_attention_lamp`` (the "dot_ps"
    order) at the effective length length + 1, over `cfg.window` keys.
    `kv_cross`: (k, v) (B, Te, Hkv, hd) of the encoder; then nothing is
    written and all Te keys are read. Returns (out (B, 1, d), cache_k,
    cache_v, recompute rate).

    Under an ambient mesh (``distributed.sharding.set_mesh``) the caches
    are DTensors laid out by ``sharding.cache_specs`` and x, length this
    rank's batch rows. When the mesh's `model` axis (> 1) divides S, the
    caches' sequence is sharded over it: only the rank whose slice holds
    position length[b] writes row b's K/V, attention is the
    sequence-parallel ``collectives.sp_decode_attention`` (the relaxed rule
    at the site's mu and tau when LAMP is on) and the rate is 0 (not
    tracked on that path, as in the JAX package). Otherwise the rank's
    local caches take the single-device path. The caches returned are
    then the rank's local shards (written in place).
    """
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = _project_qkv(cfg, p, x, length[:, None])
    mesh = SH.current_mesh()
    if kv_cross is None:
        if mesh is not None:
            S = cache_k.shape[1]
            cache_k, cache_v = SH.to_local(cache_k), SH.to_local(cache_v)
            n_model = SH.axis_size(mesh, "model")
            if n_model > 1 and S % n_model == 0:
                S_l = cache_k.shape[1]
                if S_l * n_model != S:
                    raise ValueError("under a mesh the caches must be laid "
                                     "out by sharding.cache_specs")
                first = SH.axis_index(mesh, "model") * S_l
                _write_new(cache_k, k[:, 0], length - first)
                _write_new(cache_v, v[:, 0], length - first)
                out = C.sp_decode_attention(
                    mesh, q.transpose(1, 2), cache_k.movedim(2, 1),
                    cache_v.movedim(2, 1), length + 1,
                    mu=lamp_site.mu if lamp_site.enabled else 23,
                    tau=lamp_site.tau, lamp=lamp_site.enabled,
                    window=cfg.window)
                out = out.transpose(1, 2).reshape(B, 1, H * hd).to(x.dtype)
                return out @ p["wo"], cache_k, cache_v, \
                    torch.zeros((), dtype=torch.float32, device=x.device)
        _write_new(cache_k, k[:, 0], length)
        _write_new(cache_v, v[:, 0], length)
        use_k, use_v = cache_k, cache_v
        eff = length + 1
    else:
        use_k, use_v = kv_cross
        eff = torch.full((B,), use_k.shape[1], dtype=torch.int32,
                         device=x.device)
    kh = _repeat_kv(use_k.movedim(2, 1), H // Hkv)
    vh = _repeat_kv(use_v.movedim(2, 1), H // Hkv)
    out, aux = A.decode_attention_lamp(q.transpose(1, 2), kh, vh, eff,
                                       lamp_site, window=cfg.window)
    out = out.transpose(1, 2).reshape(B, 1, H * hd).to(x.dtype)
    return out @ p["wo"], cache_k, cache_v, aux.recompute_rate


def paged_attention_decode_sublayer(cfg, p, x: torch.Tensor, *, arena_k,
                                    arena_v, block_tables, lengths,
                                    lamp_site: LampSite,
                                    window: Optional[int] = None, tau=None,
                                    kernel: str = "cuda"):
    """Single-token decode against a paged KV arena (one layer).

    x: (R, 1, d) hidden states; arena_k / arena_v: (n_blocks, block_size,
    Hkv, hd), updated in place (the JAX package returns updated copies);
    block_tables: (R, n_max) int32; lengths: (R,) int32 tokens already
    cached -- the new token's K/V land at position lengths[r], block
    block_tables[r, lengths // bs], offset lengths % bs, and attention runs
    at the effective length lengths + 1. `tau` (a float32 value on the
    device) overrides the site's threshold. Returns (out (R, 1, d),
    n_selected (R,), n_valid (R,)); n_valid = min(lengths + 1, window) * H
    whatever the site, as in the JAX kernel branch. `kernel` is the
    attention path (``KERNELS``). The query reaches attention in FP32,
    whatever the model's dtype."""
    _, attend = paged_attention_fns(kernel)
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
    out, nsel = attend(
        q.transpose(1, 2).float().contiguous(), arena_k, arena_v,
        block_tables, eff, lamp_site, tau=tau, window=window)
    cap = eff if window is None else torch.clamp(eff, max=window)
    nval = cap.to(torch.float32) * H
    out = out.transpose(1, 2).reshape(R, 1, H * hd).to(x.dtype)
    return out @ p["wo"], nsel, nval


def mlp_apply(cfg, p, x: torch.Tensor) -> torch.Tensor:
    return _mlp(cfg, x, p["wi"], p["wo"])


def _mlp(cfg, x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor):
    """The MLP on hidden units wo.shape[0]: wi's columns are those units
    (gated: their gate columns, then their up columns)."""
    h = x @ wi
    if cfg.act in ("swiglu", "geglu"):
        ff = wo.shape[0]
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
    return h @ wo


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


# ---------------------------------------------------------------------------
# tensor parallelism over the mesh's `model` axis (the sharded steps of
# ``launch.steps``): each function takes the layer's leaves as this rank's
# shards `p` with their specs `sp` (``sharding.spec_of``, the stacked
# layer axis dropped) and runs the rank's share, as XLA's SPMD partitioner
# runs the JAX package's jitted step over ``param_specs``
# ---------------------------------------------------------------------------

class TensorParallel(NamedTuple):
    """A rank's share of the transformer on `mesh`: for each rank of
    `model`, its query heads, the KV heads they read and its hidden units
    of the FFN, as (start, stop) ranges, contiguous and as even as the
    counts allow; `rank` is this rank's index on `model`."""
    mesh: Any
    rank: int
    heads: Tuple[Tuple[int, int], ...]
    kv: Tuple[Tuple[int, int], ...]
    ff: Tuple[Tuple[int, int], ...]

    @property
    def n(self) -> int:
        return len(self.heads)


def _split(total: int, n: int):
    return tuple((r * total // n, (r + 1) * total // n) for r in range(n))


def tensor_parallel(cfg, mesh) -> TensorParallel:
    """This rank's `TensorParallel` share of cfg's transformer on mesh;
    `model` may not exceed the heads or the hidden units."""
    n = SH.axis_size(mesh, "model")
    if cfg.n_heads < n or cfg.d_ff < n:
        raise ValueError(f"`model` of {n} needs at least {n} heads and "
                         f"hidden units, got {cfg.n_heads} and {cfg.d_ff}")
    G = cfg.n_heads // cfg.n_kv_heads
    heads = _split(cfg.n_heads, n)
    return TensorParallel(mesh, SH.axis_index(mesh, "model"), heads,
                          tuple((a // G, (b - 1) // G + 1) for a, b in heads),
                          _split(cfg.d_ff, n))


def _cols(rng, width: int):
    return [(rng[0] * width, rng[1] * width)]


def kv_index(tp: TensorParallel, cfg, device):
    """The KV head (counted from the first of the rank's KV heads) that
    each of the rank's query heads reads, or None where its heads are
    whole query groups (``attend``'s repeat)."""
    G = cfg.n_heads // cfg.n_kv_heads
    h0, h1 = tp.heads[tp.rank]
    if h0 % G == 0 and h1 % G == 0:
        return None
    return torch.arange(h0, h1, device=device) // G - tp.kv[tp.rank][0]


def project_qkv_tp(cfg, tp: TensorParallel, p, sp, x, positions):
    """`_project_qkv` for the rank's query heads and the KV heads they
    read: q (B, T, Hq_r, hd), k, v (B, T, Hk_r, hd). x is replicated over
    `model` (its gradient summed over it: `copy_to_axis`); the qk norm
    weights' gradients, partial a rank, are summed too."""
    B, T, _ = x.shape
    hd, mesh = cfg.hd, tp.mesh
    h = C.copy_to_axis(x, mesh, "model")
    hq, hk = tp.heads[tp.rank], tp.kv[tp.rank]
    q = h @ C.take(p["wq"], sp["wq"], mesh, dim=1, ranges=_cols(hq, hd))
    k = h @ C.take(p["wk"], sp["wk"], mesh, dim=1, ranges=_cols(hk, hd))
    v = h @ C.take(p["wv"], sp["wv"], mesh, dim=1, ranges=_cols(hk, hd))
    q = q.reshape(B, T, hq[1] - hq[0], hd)
    k = k.reshape(B, T, hk[1] - hk[0], hd)
    v = v.reshape(B, T, hk[1] - hk[0], hd)
    if cfg.qk_norm:
        q = rms_norm(q, C.copy_to_axis(
            C.take(p["qn_w"], sp["qn_w"], mesh), mesh, "model"))
        k = rms_norm(k, C.copy_to_axis(
            C.take(p["kn_w"], sp["kn_w"], mesh), mesh, "model"))
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def out_proj_tp(tp: TensorParallel, cfg, p, sp, out):
    """The row-parallel `wo` of the rank's heads' outputs (B, T, Hq_r *
    hd), summed over `model`."""
    wo = C.take(p["wo"], sp["wo"], tp.mesh, dim=0,
                ranges=_cols(tp.heads[tp.rank], cfg.hd))
    return C.reduce_over_axis(out @ wo, tp.mesh, "model")


def attention_sublayer_tp(cfg, tp: TensorParallel, p, sp, x, *, positions,
                          lamp_site: LampSite, attn_impl: str = "auto"):
    """`attention_sublayer` on the rank's heads (LAMP's y_low, selection
    and FP32 recompute are per head: no communication), then the
    row-parallel `wo`. Returns (out, the recompute rate of the rank's
    heads weighted by their share of all heads)."""
    q, k, v = project_qkv_tp(cfg, tp, p, sp, x, positions)
    out, rate = attend(cfg, q, k, v, lamp_site, attn_impl=attn_impl,
                       random_control=True,
                       kv_index=kv_index(tp, cfg, x.device))
    h0, h1 = tp.heads[tp.rank]
    return out_proj_tp(tp, cfg, p, sp, out), rate * ((h1 - h0) / cfg.n_heads)


def attention_decode_tp(cfg, tp: TensorParallel, p, sp, x, *, cache_k,
                        cache_v, length, lamp_site: LampSite,
                        seq_split: bool):
    """`attention_decode_sublayer` on the rank's heads, against its cache
    shards cache_k / cache_v (B, S_l, Hkv, hd), written in place. The new
    token's K/V heads are gathered over `model` (B x Hkv x hd) for the
    write. With `seq_split` the caches' sequence is split over `model`:
    the query heads are gathered too (B x H x hd), the rank whose slice
    holds position length[b] writes row b, attention is
    ``collectives.sp_decode_attention`` over all heads, and the rank keeps
    its heads' outputs; else the rank writes every row of its whole
    caches and attends with its heads. Then the row-parallel `wo`."""
    B, mesh, hd = x.shape[0], tp.mesh, cfg.hd
    q, k, v = project_qkv_tp(cfg, tp, p, sp, x, length[:, None])
    k = C.gather_parts(k, mesh, 2, tp.kv)[:, 0]
    v = C.gather_parts(v, mesh, 2, tp.kv)[:, 0]
    h0, h1 = tp.heads[tp.rank]
    if seq_split:
        first = tp.rank * cache_k.shape[1]
        _write_new(cache_k, k, length - first)
        _write_new(cache_v, v, length - first)
        out = C.sp_decode_attention(
            mesh, C.gather_parts(q, mesh, 2, tp.heads).transpose(1, 2),
            cache_k.movedim(2, 1), cache_v.movedim(2, 1), length + 1,
            mu=lamp_site.mu if lamp_site.enabled else 23, tau=lamp_site.tau,
            lamp=lamp_site.enabled, window=cfg.window)[:, h0:h1]
    else:
        _write_new(cache_k, k, length)
        _write_new(cache_v, v, length)
        k0, k1 = tp.kv[tp.rank]
        kh, vh = (c.narrow(2, k0, k1 - k0).movedim(2, 1)
                  for c in (cache_k, cache_v))
        idx = kv_index(tp, cfg, x.device)
        if idx is None:
            G = cfg.n_heads // cfg.n_kv_heads
            kh, vh = _repeat_kv(kh, G), _repeat_kv(vh, G)
        else:
            kh, vh = kh.index_select(1, idx), vh.index_select(1, idx)
        out, _ = A.decode_attention_lamp(q.transpose(1, 2), kh, vh,
                                         length + 1, lamp_site,
                                         window=cfg.window)
    out = out.transpose(1, 2).reshape(B, 1, (h1 - h0) * hd).to(x.dtype)
    return out_proj_tp(tp, cfg, p, sp, out)


def mlp_apply_tp(cfg, tp: TensorParallel, p, sp, x):
    """`mlp_apply` on the rank's hidden units: `wi` column-parallel (a
    gated MLP's gate and up columns of those units), `wo` row-parallel,
    summed over `model`."""
    f0, f1 = tp.ff[tp.rank]
    ff, mesh = cfg.d_ff, tp.mesh
    ranges = [(f0, f1)]
    if cfg.act in ("swiglu", "geglu"):
        ranges.append((ff + f0, ff + f1))
    wi = C.take(p["wi"], sp["wi"], mesh, dim=1, ranges=ranges)
    wo = C.take(p["wo"], sp["wo"], mesh, dim=0, ranges=[(f0, f1)])
    y = _mlp(cfg, C.copy_to_axis(x, mesh, "model"), wi, wo)
    return C.reduce_over_axis(y, mesh, "model")


def split_over_model(spec, dim: int, mesh) -> bool:
    """Whether a leaf placed by `spec` has its dim split over a `model`
    axis > 1 (a table by vocabulary, `mm_proj` by columns)."""
    return SH.axis_size(mesh, "model") > 1 and spec[dim] == "model"


def _vocab_rows(cfg, tp: TensorParallel):
    size = cfg.vocab // tp.n
    return [(tp.rank * size, (tp.rank + 1) * size)]


def embed_tp(cfg, tp: TensorParallel, p, sp, tokens, positions):
    """`embed` with `tok` split by vocabulary over `model` where its
    spec puts it there (``collectives.vocab_embed``), else whole."""
    mesh = tp.mesh
    if split_over_model(sp["tok"], 0, mesh):
        rows = _vocab_rows(cfg, tp)
        table = C.take(p["tok"], sp["tok"], mesh, dim=0, ranges=rows)
        x = C.vocab_embed(table, tokens, rows[0][0], mesh)
    else:
        x = C.take(p["tok"], sp["tok"], mesh, redundant=True)[tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    if cfg.pos == "learned":
        pos = C.take(p["pos"], sp["pos"], mesh, redundant=True)
        x = x + pos[torch.clamp(positions, max=pos.shape[0] - 1)]
    return x


def unembed_tp(cfg, tp: TensorParallel, p, sp, x):
    """(FP32 logits, first vocabulary index): this rank's vocabulary
    columns where the table is split by vocabulary over `model`, else all
    of them from 0."""
    mesh = tp.mesh
    name, dim = ("tok", 0) if cfg.tie_embeddings else ("unembed", 1)
    if not split_over_model(sp[name], dim, mesh):
        w = C.take(p[name], sp[name], mesh, redundant=True)
        return unembed(cfg, {name: w}, x), 0
    rows = _vocab_rows(cfg, tp)
    w = C.take(p[name], sp[name], mesh, dim=dim, ranges=rows)
    w = w.T if cfg.tie_embeddings else w
    return C.copy_to_axis(x, mesh, "model").float() @ w.float(), rows[0][0]
