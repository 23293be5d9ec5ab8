"""Hymba (arXiv:2411.13676): hybrid-head LM -- every layer runs attention
heads and Mamba (selective-SSM) heads in parallel on the same input, then
fuses the two branch outputs (each RMS-normalized, learnable per-branch
scales). Port of ``repro/models/hymba.py``.

Attention is sliding-window GQA over `cfg.window` keys, and
`cfg.n_meta_tokens` learnable meta tokens are prepended to the sequence.
The attention branch takes the KQ LAMP site; the SSM branch has no softmax,
so LAMP does not apply there. One shared state size N = `cfg.ssm_state`, a
depthwise causal conv of kernel 4, fusion by normalized averaging.

Serving keeps a ring of W = min(window or max_len, max_len) + n_meta K/V
slots and the SSM state. Its semantics are the JAX package's, kept as they
are: prefill writes the last min(W, M + S) positions at slot 0 on; decode
writes slot min(length, W - 1) (once the ring is full, every step
overwrites slot W - 1: the reference's "shift-free approximation") and
attends over the first min(length + 1, W) slots with no window mask. The
K/V cache is written in place; the conv and SSM states are returned anew.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.core import attention as CA
from repro_torch.core import tree as T
from repro_torch.core.policy import LampSite

from . import layers as LY
from .transformer import layer_params, next_token_nll, resolve_device

CONV_K = 4
# kept in FP32 in every model dtype, as in the JAX package
_FP32_LEAVES = ("m_A_log", "m_D", "fuse_beta")


def init_params(cfg, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Seeded random weights with the JAX package's layout, shapes and
    scales (see ``transformer.init_params``)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    L, d, N = cfg.n_layers, cfg.d_model, cfg.ssm_state
    lead = (L,)

    def lin(m, n):
        return LY.normal(gen, lead + (m, n), m ** -0.5)

    a_log = torch.log(torch.linspace(1.0, float(N), N))
    blocks = {
        "ln1_w": torch.zeros(lead + (d,)),
        "ln2_w": torch.zeros(lead + (d,)),
        "attn": LY.attn_params(cfg, gen, lead),
        "m_in": lin(d, 2 * d),
        "m_conv": LY.normal(gen, lead + (CONV_K, d), 0.3),
        "m_dt": lin(d, d),
        "m_dt_bias": torch.zeros(lead + (d,)),
        "m_bc": lin(d, 2 * N),
        "m_A_log": a_log.expand(lead + (d, N)).clone(),
        "m_D": torch.ones(lead + (d,)),
        "m_out": lin(d, d),
        "fuse_na": torch.zeros(lead + (d,)),
        "fuse_ns": torch.zeros(lead + (d,)),
        "fuse_beta": torch.ones(lead + (2,)),
        "mlp": LY.mlp_params(cfg, gen, lead),
    }
    params = {"embed": LY.embed_params(cfg, gen),
              "meta": LY.normal(gen, (cfg.n_meta_tokens, d), 0.02),
              "blocks": blocks,
              "lnf_w": torch.zeros((d,))}
    dt = LY.dtype_of(cfg)
    params = T.map(lambda t: t.to(device=device, dtype=dt), params)
    for k in _FP32_LEAVES:
        params["blocks"][k] = blocks[k].to(device)
    return params


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _ssm_scan(xf, dt_soft, B_t, C_t, A, D, h0):
    """Selective scan. xf, dt_soft (B, T, d); B_t, C_t (B, T, N); A (d, N);
    h0 (B, d, N). Returns (y (B, T, d), h_T)."""
    dA = torch.exp(dt_soft[..., None] * (-torch.exp(A))[None, None])  # (B,T,d,N)
    dBx = dt_soft[..., None] * B_t[:, :, None, :] * xf[..., None]     # (B,T,d,N)
    h, ys = h0, []
    for t in range(xf.shape[1]):
        h = dA[:, t] * h + dBx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, C_t[:, t]))
    return torch.stack(ys, dim=1) + xf * D[None, None], h


def mamba_branch(cfg, p, x, conv_state, ssm_state):
    """x: (B, T, d); conv_state (B, CONV_K - 1, d); ssm_state (B, d, N).
    Returns (out (B, T, d), new conv state, new SSM state)."""
    T, d = x.shape[1], x.shape[2]
    N = cfg.ssm_state
    h = x @ p["m_in"]
    xin, gate = h[..., :d], h[..., d:]
    # causal depthwise conv (kernel CONV_K)
    xpad = torch.cat([conv_state.to(xin.dtype), xin], dim=1)
    new_conv_state = xpad[:, -(CONV_K - 1):, :]
    w = p["m_conv"].float()
    xc = sum(xpad[:, i:i + T, :].float() * w[i][None, None]
             for i in range(CONV_K))
    xf = F.silu(xc)
    dt_soft = _softplus((xf.to(x.dtype) @ p["m_dt"]).float()
                        + p["m_dt_bias"].float())
    bc = (xf.to(x.dtype) @ p["m_bc"]).float()
    y, hT = _ssm_scan(xf, dt_soft, bc[..., :N], bc[..., N:], p["m_A_log"],
                      p["m_D"], ssm_state.float())
    y = y * F.silu(gate.float())
    out = y.to(x.dtype) @ p["m_out"]
    return out, new_conv_state, hT.to(ssm_state.dtype)


def _fuse(p, a, s, x):
    """The two branches' fusion, added to the residual x."""
    beta = p["fuse_beta"].float()
    fused = (LY.rms_norm(a, p["fuse_na"]).float() * beta[0]
             + LY.rms_norm(s, p["fuse_ns"]).float() * beta[1]) * 0.5
    return x + fused.to(x.dtype)


def block_apply(cfg, p, x, *, positions, lamp_site: LampSite, attn_impl: str,
                state: Dict[str, Any]):
    """One block over the whole sequence: (x, new state, recompute rate,
    the attention's (k, v) (B, T, Hkv, hd), which prefill caches)."""
    h = LY.rms_norm(x, p["ln1_w"])
    q, k, v = LY._project_qkv(cfg, p["attn"], h, positions)
    a, rate = LY.attention_out(cfg, p["attn"], q, k, v, lamp_site,
                               attn_impl=attn_impl, random_control=True)
    s, conv_st, ssm_st = mamba_branch(cfg, p, h, state["conv"], state["ssm"])
    x = _fuse(p, a, s, x)
    x = x + LY.mlp_apply(cfg, p["mlp"], LY.rms_norm(x, p["ln2_w"]))
    return x, {"conv": conv_st, "ssm": ssm_st}, rate, (k, v)


def init_state(cfg, batch: int, device="cuda") -> Dict[str, torch.Tensor]:
    L, d, N = cfg.n_layers, cfg.d_model, cfg.ssm_state
    device = resolve_device(device)
    return {"conv": torch.zeros((L, batch, CONV_K - 1, d),
                                dtype=LY.dtype_of(cfg), device=device),
            "ssm": torch.zeros((L, batch, d, N), dtype=torch.float32,
                               device=device)}


def _embed_with_meta(cfg, params, tokens):
    """(x (B, M + S, d), positions (M + S,)): the meta tokens, then the
    token embeddings."""
    B, S = tokens.shape
    M = cfg.n_meta_tokens
    dev = tokens.device
    x = LY.embed(cfg, params["embed"], tokens.long(), torch.arange(S, device=dev))
    meta = params["meta"][None].expand(B, M, cfg.d_model).to(x.dtype)
    return torch.cat([meta, x], dim=1), torch.arange(M + S, device=dev)


def forward(cfg, params, tokens, *, use_lamp: bool = False,
            attn_impl: str = "auto", remat: bool = False, **_):
    """tokens (B, S) from a zero state -> (logits (B, S, V) float32, new
    state, aux with the layers' mean `attn_lamp_rate`). `remat`
    checkpoints each layer (``layers.remat_call``)."""
    M = cfg.n_meta_tokens
    x, positions = _embed_with_meta(cfg, params, tokens)
    site = LY.kq_site(cfg, use_lamp)
    state = init_state(cfg, tokens.shape[0], device=tokens.device)
    convs, ssms, rates = [], [], []
    for l in range(cfg.n_layers):
        x, st, rate, _ = LY.remat_call(
            remat, block_apply,
            cfg, layer_params(params["blocks"], l), x, positions=positions,
            lamp_site=site, attn_impl=attn_impl,
            state={"conv": state["conv"][l], "ssm": state["ssm"][l]})
        convs.append(st["conv"])
        ssms.append(st["ssm"])
        rates.append(rate)
    x = LY.rms_norm(x, params["lnf_w"])
    logits = LY.unembed(cfg, params["embed"], x[:, M:])
    return logits, {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}, \
        {"attn_lamp_rate": torch.mean(torch.stack(rates))}


def loss_fn(cfg, params, batch, *, use_lamp: bool = False, remat: bool = True,
            **_):
    """Next-token cross entropy. Returns (loss, metrics)."""
    logits, _, aux = forward(cfg, params, batch["tokens"], use_lamp=use_lamp,
                             remat=remat)
    loss = next_token_nll(logits, batch["tokens"])
    return loss, {"loss": loss, **aux}


# ---------------------------------------------------------------------------
# Serving: ring-buffer SWA cache + SSM state
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda") -> Dict[str, torch.Tensor]:
    """The ring of W = min(window or max_len, max_len) + n_meta K/V slots
    (bounded by the window whatever max_len), the conv and SSM states and
    the fill `length` (meta tokens included)."""
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    W = min(cfg.window or max_len, max_len) + cfg.n_meta_tokens
    st = init_state(cfg, batch, device=device)
    dev = st["ssm"].device
    return {"k": torch.zeros((L, batch, W, Hkv, hd), dtype=dtype, device=dev),
            "v": torch.zeros((L, batch, W, Hkv, hd), dtype=dtype, device=dev),
            "conv": st["conv"], "ssm": st["ssm"],
            "length": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def prefill(cfg, params, tokens, cache, *, use_lamp: bool = True,
            attn_impl: str = "auto", **_):
    """The whole prompt through the blocks, the last min(W, M + S) K/V
    written at slot 0 on. Returns (last-position logits (B, 1, V), cache)
    with length M + S."""
    B, S = tokens.shape
    M = cfg.n_meta_tokens
    W = cache["k"].shape[2]
    x, positions = _embed_with_meta(cfg, params, tokens)
    site = LY.kq_site(cfg, use_lamp)
    take = min(W, M + S)
    convs, ssms = [], []
    for l in range(cfg.n_layers):
        x, st, _, (k, v) = block_apply(
            cfg, layer_params(params["blocks"], l), x, positions=positions,
            lamp_site=site, attn_impl=attn_impl,
            state={"conv": cache["conv"][l], "ssm": cache["ssm"][l]})
        cache["k"][l, :, :take] = k[:, -take:].to(cache["k"].dtype)
        cache["v"][l, :, :take] = v[:, -take:].to(cache["v"].dtype)
        convs.append(st["conv"])
        ssms.append(st["ssm"])
    x = LY.rms_norm(x[:, -1:], params["lnf_w"])
    return LY.unembed(cfg, params["embed"], x), {
        "k": cache["k"], "v": cache["v"], "conv": torch.stack(convs),
        "ssm": torch.stack(ssms),
        "length": torch.full((B,), M + S, dtype=torch.int32, device=x.device)}


def decode_step(cfg, params, cache, tokens, *, use_lamp: bool = True, **_):
    """One token: the ring write at min(length, W - 1), attention over
    min(length + 1, W) slots, one SSM step. Returns (logits (B, 1, V),
    cache with length + 1)."""
    B = tokens.shape[0]
    length = cache["length"]
    W = cache["k"].shape[2]
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    x = LY.embed(cfg, params["embed"], tokens.long(), length.long()[:, None])
    site = LY.kq_site(cfg, use_lamp)
    rows = torch.arange(B, device=x.device)
    slot = torch.clamp(length.long(), max=W - 1)   # the shift-free ring write
    eff = torch.clamp(length + 1, max=W)
    convs, ssms = [], []
    for l in range(cfg.n_layers):
        p_l = layer_params(params["blocks"], l)
        h = LY.rms_norm(x, p_l["ln1_w"])
        q, k, v = LY._project_qkv(cfg, p_l["attn"], h, length[:, None])
        ck, cv = cache["k"][l], cache["v"][l]
        ck[rows, slot] = k[:, 0].to(ck.dtype)
        cv[rows, slot] = v[:, 0].to(cv.dtype)
        kh = LY._repeat_kv(ck.to(x.dtype).movedim(2, 1), H // Hkv)
        vh = LY._repeat_kv(cv.to(x.dtype).movedim(2, 1), H // Hkv)
        a, _ = CA.decode_attention_lamp(q.transpose(1, 2), kh, vh, eff, site)
        a = a.transpose(1, 2).reshape(B, 1, -1).to(x.dtype) @ p_l["attn"]["wo"]
        s, conv_st, ssm_st = mamba_branch(cfg, p_l, h, cache["conv"][l],
                                          cache["ssm"][l])
        x = _fuse(p_l, a, s, x)
        x = x + LY.mlp_apply(cfg, p_l["mlp"], LY.rms_norm(x, p_l["ln2_w"]))
        convs.append(conv_st)
        ssms.append(ssm_st)
    x = LY.rms_norm(x, params["lnf_w"])
    return LY.unembed(cfg, params["embed"], x), {
        "k": cache["k"], "v": cache["v"], "conv": torch.stack(convs),
        "ssm": torch.stack(ssms), "length": length + 1}
