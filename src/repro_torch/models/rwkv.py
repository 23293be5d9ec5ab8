"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free LM with data-dependent
per-channel decay. Time-mix (the WKV recurrence) and channel-mix (relu^2)
blocks with token shift and LoRA-style data-dependent interpolation. Port
of ``repro/models/rwkv.py``.

RWKV has no token softmax, so the KQ LAMP rule does not apply: the arch
runs without it (its config's policy is disabled); the serving layer's
logits site (``runtime.serve_loop.lamp_logits_softmax``) is its LAMP site.

Recurrence (per head h, head dim n = 64):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          S in R^{n x n}
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

Two evaluations of it, both the JAX package's: the step scan (`forward`
and `decode_step`, chunk 0) and the chunked form (`prefill`, chunk 64),
equal in exact arithmetic. The state is returned anew by every call.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.core import tree as T

from . import layers as LY
from .transformer import layer_params, next_token_nll, resolve_device

LORA_R = 32
HEAD_DIM = 64
# the chunk of `prefill`'s recurrence (0 elsewhere: the step scan)
PREFILL_CHUNK = 64


def _n_heads(cfg) -> int:
    return cfg.d_model // HEAD_DIM


def init_params(cfg, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Seeded random weights with the JAX package's layout, shapes and
    scales (see ``transformer.init_params``)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    L, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    H = _n_heads(cfg)
    lead = (L,)
    sc = d ** -0.5

    def lin(m, n, s=None):
        return LY.normal(gen, lead + (m, n), s or m ** -0.5)

    def uniform(*shape):
        return torch.rand(lead + shape, generator=gen, dtype=torch.float32)

    blocks = {
        "ln1_w": torch.ones(lead + (d,)), "ln1_b": torch.zeros(lead + (d,)),
        "ln2_w": torch.ones(lead + (d,)), "ln2_b": torch.zeros(lead + (d,)),
        # time-mix: the mixes of r, k, v, w, g
        "tm_mu": uniform(5, d),
        "tm_lora_down": lin(d, LORA_R),
        "tm_lora_up": LY.normal(gen, lead + (5, LORA_R, d), LORA_R ** -0.5),
        "w_base": LY.normal(gen, lead + (d,), 0.5) - 6.0,
        "w_lora_down": lin(d, LORA_R),
        "w_lora_up": lin(LORA_R, d),
        "u": LY.normal(gen, lead + (H, HEAD_DIM), 0.1),
        "wr": lin(d, d, sc), "wk": lin(d, d, sc),
        "wv": lin(d, d, sc), "wg": lin(d, d, sc),
        "wo": lin(d, d, sc),
        "ln_x": torch.ones(lead + (d,)),
        # channel-mix: the mixes of k, r
        "cm_mu": uniform(2, d),
        "cm_wk": lin(d, ff, sc),
        "cm_wv": lin(ff, d, ff ** -0.5),
        "cm_wr": lin(d, d, sc),
    }
    params = {"embed": LY.embed_params(cfg, gen), "blocks": blocks,
              "lnf_w": torch.ones((d,)), "lnf_b": torch.zeros((d,))}
    dt = LY.dtype_of(cfg)
    return T.map(lambda t: t.to(device=device, dtype=dt), params)


def _ddlerp(p, x, x_prev):
    """Finch's data-dependent interpolation: the 5 mixed streams (r, k, v,
    w, g), (5, B, T, d)."""
    mu = p["tm_mu"][:, None, None, :]
    lora = torch.tanh(x @ p["tm_lora_down"])                        # (B,T,R)
    dyn = torch.einsum("btr,srd->sbtd", lora, p["tm_lora_up"])
    mix = torch.clamp(mu + dyn, 0.0, 1.0)
    return x + (x_prev - x) * mix


def _wkv_scan(rf, kf, vf, w, u, S0):
    """The per-timestep recurrence. (B, T, H, n) inputs; returns (S_T,
    y (B, T, H, n))."""
    S, ys = S0, []
    for t in range(rf.shape[1]):
        r_t, k_t, v_t, w_t = rf[:, t], kf[:, t], vf[:, t], w[:, t]  # (B,H,n)
        kv = k_t[..., :, None] * v_t[..., None, :]                   # (B,H,n,n)
        ys.append(torch.einsum("bhi,bhij->bhj", r_t,
                               S + u[None, :, :, None] * kv))
        S = w_t[..., :, None] * S + kv
    return S, torch.stack(ys, dim=1)


def _wkv_chunked(rf, kf, vf, w, u, S0, chunk: int):
    """The chunked recurrence: the state is carried once per `chunk` steps;
    inside a chunk, step t reads step s < t through the decay product
    exp(L_{t-1} - L_s) <= 1 (L the running sum of log w). Exactly the step
    scan in exact arithmetic. T is padded to chunks with w = 1 (no decay)
    and zeros; log w is clamped at -60 (log of at least 1e-30)."""
    B, T, H, n = rf.shape
    C = chunk
    nb = -(-T // C)
    pad = nb * C - T
    if pad:
        def padded(t, value=0.0):
            return F.pad(t, (0, 0, 0, 0, 0, pad), value=value)
        rf, kf, vf, w = padded(rf), padded(kf), padded(vf), padded(w, 1.0)
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=rf.device), -1)
    S, ys = S0, []
    for b in range(nb):
        rc, kc, vc, wc = (t[:, b * C:(b + 1) * C] for t in (rf, kf, vf, w))
        logw = torch.clamp(torch.log(torch.clamp(wc, min=1e-30)), min=-60.0)
        Lc = torch.cumsum(logw, dim=1)                 # L_t = sum_{u<=t} log w_u
        Lprev = Lc - logw                              # L_{t-1}
        y_inter = torch.einsum("bthi,bhij->bthj", rc * torch.exp(Lprev), S)
        D = Lprev[:, :, None] - Lc[:, None, :]         # (B,C,C,H,n), <= 0 on tril
        E = torch.where(tri[None, :, :, None, None], torch.exp(D),
                        torch.zeros((), device=D.device))
        att = torch.einsum("bthi,bshi,btshi->btsh", rc, kc, E)
        y_intra = torch.einsum("btsh,bshj->bthj", att, vc)
        coeff = torch.einsum("bthi,hi,bthi->bth", rc, u, kc)
        ys.append(y_inter + y_intra + coeff[..., None] * vc)
        k_eff = kc * torch.exp(Lc[:, -1][:, None] - Lc)
        S = torch.exp(Lc[:, -1])[..., None] * S + \
            torch.einsum("bshi,bshj->bhij", k_eff, vc)
    return S, torch.cat(ys, dim=1)[:, :T]


def time_mix(cfg, p, x, state, *, wkv_chunk: int = 0):
    """x: (B, T, d); state: {'S': (B, H, n, n), 'x_prev': (B, d)}. Returns
    (out, new state)."""
    B, T, d = x.shape
    H, n = _n_heads(cfg), HEAD_DIM
    x_prev = torch.cat([state["x_prev"][:, None, :], x[:, :-1]], dim=1)
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev)
    r = (xr @ p["wr"]).reshape(B, T, H, n)
    k = (xk @ p["wk"]).reshape(B, T, H, n)
    v = (xv @ p["wv"]).reshape(B, T, H, n)
    g = F.silu((xg @ p["wg"]).float())
    w_log = p["w_base"].float() + \
        (torch.tanh(xw @ p["w_lora_down"]) @ p["w_lora_up"]).float()
    w = torch.exp(-torch.exp(w_log)).reshape(B, T, H, n)            # in (0, 1)
    u = p["u"].float()
    rf, kf, vf = (t.float() for t in (r, k, v))
    S0 = state["S"].float()
    if wkv_chunk and T > 1:
        S, ys = _wkv_chunked(rf, kf, vf, w, u, S0, wkv_chunk)
    else:
        S, ys = _wkv_scan(rf, kf, vf, w, u, S0)
    # per-head group norm (the population variance, as jnp.var)
    mu = torch.mean(ys, dim=-1, keepdim=True)
    var = torch.var(ys, dim=-1, keepdim=True, correction=0)
    y = ((ys - mu) * torch.rsqrt(var + 64e-5)).reshape(B, T, d) \
        * p["ln_x"].float()
    out = (y * g).to(x.dtype) @ p["wo"]
    return out, {"S": S.to(state["S"].dtype), "x_prev": x[:, -1, :]}


def channel_mix(p, x, state):
    x_prev = torch.cat([state[:, None, :], x[:, :-1]], dim=1)
    xk = x + (x_prev - x) * p["cm_mu"][0][None, None, :]
    xr = x + (x_prev - x) * p["cm_mu"][1][None, None, :]
    k = F.relu((xk @ p["cm_wk"]).float())
    k = (k * k).to(x.dtype)
    return torch.sigmoid((xr @ p["cm_wr"]).float()).to(x.dtype) \
        * (k @ p["cm_wv"]), x[:, -1, :]


def block_apply(cfg, p, x, state, *, wkv_chunk: int = 0):
    h = LY.layer_norm(x, p["ln1_w"], p["ln1_b"])
    a, tm = time_mix(cfg, p, h, {"S": state["S"], "x_prev": state["tm_x"]},
                     wkv_chunk=wkv_chunk)
    x = x + a
    c, cm_x = channel_mix(p, LY.layer_norm(x, p["ln2_w"], p["ln2_b"]),
                          state["cm_x"])
    return x + c, {"S": tm["S"], "tm_x": tm["x_prev"], "cm_x": cm_x}


def init_state(cfg, batch: int, device="cuda") -> Dict[str, torch.Tensor]:
    """The recurrent state: S (L, batch, H, n, n) in FP32, the two token
    shifts in the model's dtype, and the tokens seen, `length`."""
    H, n, d, L = _n_heads(cfg), HEAD_DIM, cfg.d_model, cfg.n_layers
    device = resolve_device(device)
    dt = LY.dtype_of(cfg)
    return {"S": torch.zeros((L, batch, H, n, n), dtype=torch.float32,
                             device=device),
            "tm_x": torch.zeros((L, batch, d), dtype=dt, device=device),
            "cm_x": torch.zeros((L, batch, d), dtype=dt, device=device),
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}


def forward(cfg, params, tokens, *, state=None, wkv_chunk: int = 0,
            remat: bool = False, **_):
    """Full-sequence forward. Returns (logits (B, S, V), new state, {}).
    `remat` checkpoints each layer (``layers.remat_call``)."""
    B, S = tokens.shape
    x = LY.embed(cfg, params["embed"], tokens.long(),
                 torch.arange(S, device=tokens.device))
    if state is None:
        state = init_state(cfg, B, device=tokens.device)
    outs = []
    for l in range(cfg.n_layers):
        x, st = LY.remat_call(remat, block_apply, cfg,
                              layer_params(params["blocks"], l), x,
                              {k: state[k][l] for k in ("S", "tm_x", "cm_x")},
                              wkv_chunk=wkv_chunk)
        outs.append(st)
    x = LY.layer_norm(x, params["lnf_w"], params["lnf_b"])
    new_state = {k: torch.stack([o[k] for o in outs])
                 for k in ("S", "tm_x", "cm_x")}
    new_state["length"] = state["length"] + S
    return LY.unembed(cfg, params["embed"], x), new_state, {}


def loss_fn(cfg, params, batch, *, remat: bool = True, wkv_chunk: int = 0,
            **_):
    """Next-token cross entropy, on the step scan (on the chunked
    recurrence at `wkv_chunk` > 0). Returns (loss, metrics)."""
    logits, _, aux = forward(cfg, params, batch["tokens"], remat=remat,
                             wkv_chunk=wkv_chunk)
    loss = next_token_nll(logits, batch["tokens"])
    return loss, {"loss": loss, **aux}


def prefill(cfg, params, tokens, state=None, **_):
    """The prompt through the chunked recurrence at PREFILL_CHUNK: (last
    logits (B, 1, V), state)."""
    logits, state, _ = forward(cfg, params, tokens, state=state,
                               wkv_chunk=PREFILL_CHUNK)
    return logits[:, -1:], state


def decode_step(cfg, params, state, tokens, **_):
    """tokens (B, 1): one recurrence step a layer, in constant memory."""
    logits, state, _ = forward(cfg, params, tokens, state=state)
    return logits, state
