"""Decoder-only transformer (dense / MoE / GPT-2 / LLaVA backbone): the
full-sequence forward of the paper's evaluation, the static KV-cache stack,
the paged serving steps and the shadow audit's forward (port of
``repro/models/transformer.py``).

Parameters are a dictionary with the JAX package's layout: every block
tensor is stacked with a leading (L,) axis, and the layer ``lax.scan``
becomes a Python loop over those stacks. The paged KV arena is a pair of
(L, n_blocks, block_size, Hkv, hd) tensors; block 0 is the null block that
padding points at and writes into.

The MoE family's FFN is ``models.moe``: the window steps dispatch with
capacity over the whole (B, W) bucket, padding included, as the JAX
package's do; `paged_decode_step` is dropless unless asked otherwise.

Window steps (`paged_mixed_step`, `paged_prefill_window`,
`paged_verify_window`) attend through
``kernels.paged_attention.paged_mixed_attention``; the single-token
`paged_decode_step` of the split step and the speculative draft through
``paged_decode_attention`` (``layers.paged_attention_decode_sublayer``).
Each is the hand-written CUDA kernel for tensors on the card and its plain
gather version for tensors on the CPU. Every step takes `kernel`, the
attention path (the JAX package's `kernel` argument): "cuda" calls those
wrappers, "gather" their plain versions by name, on any device.
`paged_audit_window`, the shadow audit's forward, always runs the gather
path (``core.attention``), as the JAX package's does.

`forward` runs whole sequences through ``layers.attention_sublayer``
(plain PyTorch over materialized or chunked logits, as the JAX package's
full-sequence path is plain XLA): the paper's experiment, which compares
its logits under a LAMP policy with the FP32 model's, and `loss_fn`.

The static KV-cache stack (`init_cache`, `prefill`, `decode_step`; port of
``repro/models/transformer.py:156-305``) serves ``runtime.serve_loop``: a
dense (L, B, max_len, Hkv, hd) cache written in place, prefill through the
same full-sequence attention, decode through ``decode_attention_lamp``,
plain PyTorch as the JAX path is plain XLA. It also runs llava, whose stub
frontend's image embeddings are projected by `mm_proj` and prepended; the
paged engine serves `FAMILIES` only, as the JAX engine does.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.core import tree as T
from repro_torch.core.policy import LampSite
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as SH

from . import layers as LY
from . import moe as MOE
from .layers import KERNELS, check_kernel  # noqa: F401 (the engine's, the CLI's)

# the families the paged engine serves (the JAX engine's,
# ``repro/serving/engine.py:79``); the whole-sequence forward and the static
# KV-cache stack also run llava, the dense backbone behind a stub image
# frontend
FAMILIES = ("dense", "moe", "gpt2")
DENSE_FAMILIES = FAMILIES + ("llava",)


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; CUDA asked for and absent is an error,
    never a quiet fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on CUDA unless device='cpu' is passed, and no "
            "CUDA device is available")
    return dev


def init_params(cfg, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random weights drawn from a seeded CPU generator (so every device
    gets the same values), with the JAX package's shapes and scales, then
    moved to `device`. Not the JAX package's random bits: tests that need
    both packages on one set of weights use ``convert.params_from_jax``.
    The llava family adds the stub frontend's projector `mm_proj`."""
    check_family(cfg)
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    L, d = cfg.n_layers, cfg.d_model
    blocks: Dict[str, Any] = {"attn": LY.attn_params(cfg, gen, lead=(L,))}
    if cfg.family == "moe":
        blocks["moe"] = MOE.moe_params(cfg, gen, lead=(L,))
    else:
        blocks["mlp"] = LY.mlp_params(cfg, gen, lead=(L,))
    params: Dict[str, Any] = {"embed": LY.embed_params(cfg, gen),
                              "blocks": blocks}
    if cfg.norm == "layernorm":
        for n in ("ln1", "ln2"):
            blocks[f"{n}_w"], blocks[f"{n}_b"] = torch.ones((L, d)), torch.zeros((L, d))
        params["lnf_w"], params["lnf_b"] = torch.ones((d,)), torch.zeros((d,))
    else:
        blocks["ln1_w"], blocks["ln2_w"] = torch.zeros((L, d)), torch.zeros((L, d))
        params["lnf_w"] = torch.zeros((d,))
    if cfg.family == "llava":
        params["mm_proj"] = LY.normal(gen, (d, d), d ** -0.5)
    dt = LY.dtype_of(cfg)
    params = T.map(lambda t: t.to(device=device, dtype=dt), params)
    if cfg.family == "moe":
        # the router stays FP32 in every model dtype, as in the JAX package
        params["blocks"]["moe"]["router"] = blocks["moe"]["router"].to(device)
    return params


def layer_params(blocks: Dict[str, Any], l: int) -> Dict[str, Any]:
    """Layer l's slice of the stacked block parameters (views, no copy)."""
    return T.map(lambda t: t[l], blocks)


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
    return _serving_site(LY.kq_site(cfg, use_lamp))


def _router_site(cfg, use_lamp: bool) -> LampSite:
    """The MoE router's site: on with LAMP, off without (the FP32 rung),
    as the JAX package's `_ctx` has it."""
    r = cfg.lamp.router
    return r if use_lamp and r.enabled else LampSite(enabled=False)


def _ffn(cfg, p_l, h, r_site: LampSite, *, dropless: bool = False,
         num_groups: int = 1):
    """The block's FFN: the MoE dispatch over the whole bucket `h` (in
    `num_groups` dispatch groups) for the MoE family, the MLP for the
    others."""
    if cfg.family == "moe":
        m, _ = MOE.moe_dispatch(cfg, p_l["moe"], h, lamp_site=r_site,
                                num_groups=num_groups, dropless=dropless)
        return m
    return LY.mlp_apply(cfg, p_l["mlp"], h)


class BlockCtx(NamedTuple):
    positions: torch.Tensor
    lamp_kq: LampSite
    lamp_router: LampSite
    attn_impl: str
    moe_groups: int


def block_apply(cfg, p, x, ctx: BlockCtx):
    """One residual block over whole sequences: (x, aux) with aux the
    layer's KQ recompute rate and, for the MoE family, its router metrics."""
    h = LY.apply_norm(cfg, x, p, "ln1")
    a, rate = LY.attention_sublayer(
        cfg, p["attn"], h, positions=ctx.positions, lamp_site=ctx.lamp_kq,
        attn_impl=ctx.attn_impl)
    x = x + a
    h = LY.apply_norm(cfg, x, p, "ln2")
    if cfg.family == "moe":
        m, metrics = MOE.moe_dispatch(cfg, p["moe"], h,
                                      lamp_site=ctx.lamp_router,
                                      num_groups=ctx.moe_groups)
        aux = {"attn_lamp_rate": rate, **metrics}
    else:
        m = LY.mlp_apply(cfg, p["mlp"], h)
        aux = {"attn_lamp_rate": rate}
    return x + m, aux


def scan_blocks(cfg, blocks, x, ctx: BlockCtx, *, remat: bool = False):
    """The layer stack: each aux metric averaged over the layers. With
    `remat` each layer is checkpointed (``layers.remat_call``)."""
    auxes = []
    for l in range(cfg.n_layers):
        x, aux = LY.remat_call(remat, block_apply, cfg,
                               layer_params(blocks, l), x, ctx)
        auxes.append(aux)
    return x, {k: torch.mean(torch.stack([a[k] for a in auxes]))
               for k in auxes[0]}


def _ctx(cfg, positions, use_lamp: bool, attn_impl: str,
         moe_groups: int = 1) -> BlockCtx:
    return BlockCtx(positions=positions, lamp_kq=LY.kq_site(cfg, use_lamp),
                    lamp_router=_router_site(cfg, use_lamp),
                    attn_impl=attn_impl, moe_groups=moe_groups)


def _embed_inputs(cfg, params, tokens: torch.Tensor, image_embeds):
    """(x (B, P + S, d), positions (P + S,)): the token embeddings, after
    the llava family's projected image rows (P = 0 for the others)."""
    S = tokens.shape[1]
    dev = tokens.device
    if cfg.family != "llava":
        positions = torch.arange(S, device=dev)
        return LY.embed(cfg, params["embed"], tokens.long(), positions), positions
    if image_embeds is None:
        raise ValueError("llava forward requires image_embeds")
    P = image_embeds.shape[1]
    img = image_embeds.to(LY.dtype_of(cfg)) @ params["mm_proj"]
    positions = torch.arange(P + S, device=dev)
    x = LY.embed(cfg, params["embed"], tokens.long(), positions[P:])
    return torch.cat([img, x], dim=1), positions


def _final_norm(cfg, params, x):
    return LY.apply_norm(cfg, x, {"lnf_w": params["lnf_w"],
                                  "lnf_b": params.get("lnf_b")}, "lnf")


def check_family(cfg) -> None:
    if cfg.family not in DENSE_FAMILIES:
        raise ValueError(f"the transformer runs the {DENSE_FAMILIES} "
                         f"families, got {cfg.family!r}")


def forward(cfg, params, tokens: torch.Tensor, *,
            image_embeds: Optional[torch.Tensor] = None,
            use_lamp: bool = False, attn_impl: str = "auto",
            remat: bool = False, moe_groups: int = 1):
    """tokens: (B, S) -> (logits (B, P + S, vocab) float32, aux) on the
    tokens' device; for llava the stub frontend's `image_embeds` (B, P, d)
    are projected and prepended (P = 0 for the other families). `use_lamp`
    applies `cfg.lamp`'s KQ site (and, for the MoE family, its router
    site; ``moe.moe_dispatch`` in `moe_groups` groups); `attn_impl` is
    ``layers.attention_sublayer``'s. aux holds the per-layer metrics
    averaged over the layers (`attn_lamp_rate`, and the MoE's
    `router_lamp_rate`, `kept_frac`, `moe_aux_loss`). `remat`
    checkpoints each layer for the backward (``scan_blocks``)."""
    check_family(cfg)
    x, positions = _embed_inputs(cfg, params, tokens, image_embeds)
    ctx = _ctx(cfg, positions, use_lamp, attn_impl, moe_groups)
    x, aux = scan_blocks(cfg, params["blocks"], x, ctx, remat=remat)
    return LY.unembed(cfg, params["embed"], _final_norm(cfg, params, x)), aux


def loss_fn(cfg, params, batch: Dict[str, torch.Tensor], *,
            use_lamp: bool = False, attn_impl: str = "auto",
            remat: bool = True, moe_groups: int = 1):
    """Next-token cross entropy, differentiable by autograd. batch: {tokens
    (B, S), [image_embeds]}. Returns (loss, metrics): the MoE family adds
    0.01 x its load-balancing loss. `remat` (on by default, as in the JAX
    package) checkpoints each layer."""
    tokens = batch["tokens"]
    logits, aux = forward(cfg, params, tokens,
                          image_embeds=batch.get("image_embeds"),
                          use_lamp=use_lamp, attn_impl=attn_impl, remat=remat,
                          moe_groups=moe_groups)
    if cfg.family == "llava":
        logits = logits[:, batch["image_embeds"].shape[1]:]
    loss = next_token_nll(logits, tokens)
    if cfg.family == "moe":
        loss = loss + 0.01 * aux["moe_aux_loss"]
    return loss, {"loss": loss, **aux}


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The mean NLL of tokens[:, 1:] under logits[:, :-1]."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:].long()
    return -torch.mean(torch.gather(logp, -1, tgt[..., None]))


# ---------------------------------------------------------------------------
# KV-cache serving (the static batch loop, ``runtime.serve_loop``)
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda") -> Dict[str, torch.Tensor]:
    """A dense cache: k, v (L, batch, max_len, Hkv, hd) and the fill
    `length` (batch,) int32."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}


def prefill(cfg, params, tokens: torch.Tensor, cache: Dict[str, Any], *,
            image_embeds: Optional[torch.Tensor] = None, use_lamp: bool = True,
            attn_impl: str = "auto", moe_groups: int = 1):
    """Run the whole prompt (behind llava's image rows), write its K/V at
    positions 0 .. T - 1 of the cache in place, and return (last-position
    logits (B, 1, V), cache) with length T. `attn_impl` "auto" is "full" up
    to 2048 positions, else "chunked" (the relaxed rule, the site's
    `onepass`). The MoE dispatch takes the capacity of the whole prompt in
    `moe_groups` dispatch groups."""
    check_family(cfg)
    B = tokens.shape[0]
    x, positions = _embed_inputs(cfg, params, tokens, image_embeds)
    T = x.shape[1]
    ctx = _ctx(cfg, positions, use_lamp, attn_impl)
    for l in range(cfg.n_layers):
        p_l = layer_params(params["blocks"], l)
        h = LY.apply_norm(cfg, x, p_l, "ln1")
        q, k, v = LY._project_qkv(cfg, p_l["attn"], h, positions)
        cache["k"][l, :, :T] = k.to(cache["k"].dtype)
        cache["v"][l, :, :T] = v.to(cache["v"].dtype)
        a, _ = LY.attention_out(cfg, p_l["attn"], q, k, v, ctx.lamp_kq,
                                attn_impl=attn_impl)
        x = x + a
        h = LY.apply_norm(cfg, x, p_l, "ln2")
        x = x + _ffn(cfg, p_l, h, ctx.lamp_router, num_groups=moe_groups)
    cache = {"k": cache["k"], "v": cache["v"],
             "length": torch.full((B,), T, dtype=torch.int32, device=x.device)}
    x = _final_norm(cfg, params, x[:, -1:])
    return LY.unembed(cfg, params["embed"], x), cache


def decode_step(cfg, params, cache: Dict[str, Any], tokens: torch.Tensor, *,
                use_lamp: bool = True, moe_dropless: bool = True,
                moe_groups: int = 1):
    """One decode step. tokens: (B, 1). Writes the new K/V at `length` in
    place and returns (logits (B, 1, V), cache with length + 1). The MoE
    dispatch is dropless by default, else at capacity, in `moe_groups`
    dispatch groups (both ignored on the expert-parallel path).

    Under an ambient mesh (``distributed.sharding.set_mesh``) every rank
    calls it with the same tokens and a cache whose k / v are DTensors laid
    out by ``sharding.cache_specs`` (`length` whole or replicated): the rank
    runs its batch rows (``sharding.batch_rows``) against its cache shard
    (``layers.attention_decode_sublayer``), and the logits come back as a
    DTensor sharded over the batch axes."""
    check_family(cfg)
    mesh = SH.current_mesh()
    B = tokens.shape[0]
    rows = SH.batch_rows(mesh, B) if mesh is not None else slice(None)
    length = SH.to_local(cache["length"])[rows]
    x = LY.embed(cfg, params["embed"], tokens[rows].long(),
                 length.long()[:, None])
    site = LY.kq_site(cfg, use_lamp)
    r_site = _router_site(cfg, use_lamp)
    for l in range(cfg.n_layers):
        p_l = layer_params(params["blocks"], l)
        h = LY.apply_norm(cfg, x, p_l, "ln1")
        a, _, _, _ = LY.attention_decode_sublayer(
            cfg, p_l["attn"], h, cache_k=cache["k"][l], cache_v=cache["v"][l],
            length=length, lamp_site=site)
        x = x + a
        h = LY.apply_norm(cfg, x, p_l, "ln2")
        x = x + _ffn(cfg, p_l, h, r_site, dropless=moe_dropless,
                     num_groups=moe_groups)
    x = _final_norm(cfg, params, x)
    logits = LY.unembed(cfg, params["embed"], x)
    if mesh is not None:
        logits = SH.from_rows(logits, mesh, B)
    return logits, {"k": cache["k"], "v": cache["v"],
                    "length": cache["length"] + 1}


# ---------------------------------------------------------------------------
# tensor parallelism over `model` (``launch.steps``' sharded steps): the
# rank's shards of the params with their specs (``sharding.spec_of``),
# each layer's leaves taken as ``layers``' *_tp functions need them
# ---------------------------------------------------------------------------

def _layer_specs(specs):
    """The block specs without the stacked layer axis."""
    return T.map(lambda sp: tuple(sp[1:]), specs["blocks"])


def expert_parallel(cfg, tp: LY.TensorParallel, rows_split: bool) -> bool:
    """Whether the MoE runs expert-parallel (``moe.moe_apply_ep``), as the
    JAX package's `moe_dispatch` decides under a mesh: `model` > 1 divides
    the experts and the batch is split over the batch axes."""
    return (cfg.family == "moe" and tp.n > 1 and
            cfg.n_experts % tp.n == 0 and rows_split)


def _ffn_tp(cfg, tp, p, sp, h, r_site: LampSite, ep: bool, *,
            dropless: bool = False, num_groups: int = 1):
    """(the block's FFN on the rank's share, the MoE's metrics): the MLP
    split over `model`; the MoE expert-parallel on the rank's experts, or
    else whole on every rank of `model`."""
    if cfg.family != "moe":
        return LY.mlp_apply_tp(cfg, tp, p["mlp"], sp["mlp"], h), {}
    p, sp, mesh = p["moe"], sp["moe"], tp.mesh
    if ep:
        E_l = cfg.n_experts // tp.n
        own = [(tp.rank * E_l, (tp.rank + 1) * E_l)]
        w = {"router": C.take(p["router"], sp["router"], mesh),
             "we_in": C.take(p["we_in"], sp["we_in"], mesh, dim=0,
                             ranges=own),
             "we_out": C.take(p["we_out"], sp["we_out"], mesh, dim=0,
                              ranges=own)}
        return MOE.moe_apply_ep(cfg, w, h, lamp_site=r_site, mesh=mesh,
                                local_experts=True)
    w = {k: C.take(p[k], sp[k], mesh, redundant=True) for k in p}
    return MOE.moe_apply(cfg, w, h, lamp_site=r_site, num_groups=num_groups,
                         dropless=dropless)


def _norms(tp, p, sp):
    return {k: C.take(p[k], sp[k], tp.mesh, redundant=True)
            for k in p if k.startswith("ln")}


def block_apply_tp(cfg, tp, p, sp, x, ctx: BlockCtx, ep: bool):
    """`block_apply` on the rank's share of layer leaves p (specs sp)."""
    norms = _norms(tp, p, sp)
    h = LY.apply_norm(cfg, x, norms, "ln1")
    a, rate = LY.attention_sublayer_tp(
        cfg, tp, p["attn"], sp["attn"], h, positions=ctx.positions,
        lamp_site=ctx.lamp_kq, attn_impl=ctx.attn_impl)
    x = x + a
    h = LY.apply_norm(cfg, x, norms, "ln2")
    m, metrics = _ffn_tp(cfg, tp, p, sp, h, ctx.lamp_router, ep,
                         num_groups=ctx.moe_groups)
    return x + m, {"attn_lamp_rate": rate, **metrics}


def _embed_inputs_tp(cfg, tp, params, specs, tokens, image_embeds):
    """`_embed_inputs` on the rank's shards: llava's `mm_proj`
    column-parallel, its outputs gathered over `model`."""
    S, dev, mesh = tokens.shape[1], tokens.device, tp.mesh
    if cfg.family != "llava":
        positions = torch.arange(S, device=dev)
        return LY.embed_tp(cfg, tp, params["embed"], specs["embed"],
                           tokens.long(), positions), positions
    if image_embeds is None:
        raise ValueError("llava forward requires image_embeds")
    P = image_embeds.shape[1]
    w, sp = params["mm_proj"], specs["mm_proj"]
    img = image_embeds.to(LY.dtype_of(cfg))
    if LY.split_over_model(sp, 1, mesh):
        size = cfg.d_model // tp.n
        w = C.take(w, sp, mesh, dim=1,
                   ranges=[(tp.rank * size, (tp.rank + 1) * size)])
        img = C.gather_over_axis(img @ w, mesh, "model", 2, redundant=True)
    else:
        img = img @ C.take(w, sp, mesh, redundant=True)
    positions = torch.arange(P + S, device=dev)
    x = LY.embed_tp(cfg, tp, params["embed"], specs["embed"], tokens.long(),
                    positions[P:])
    return torch.cat([img, x], dim=1), positions


def _final_norm_tp(cfg, tp, params, specs, x):
    top = {k: params[k] for k in ("lnf_w", "lnf_b") if k in params}
    return LY.apply_norm(cfg, x, _norms(tp, top, specs), "lnf")


def forward_tp(cfg, tp: LY.TensorParallel, params, specs, tokens, *,
               image_embeds=None, use_lamp: bool = False,
               attn_impl: str = "auto", remat: bool = False,
               moe_groups: int = 1):
    """`forward` on the rank's shards of the params (DTensors' local
    tensors, placed as `specs` say) and its batch rows, with every layer's
    leaves taken inside the (checkpointed) layer, so only one layer is
    whole over `data` at a time. Returns (FP32 logits of the rank's
    vocabulary columns, the first of them, aux): all columns from 0 where
    the table is not split by vocabulary. aux is the rank's rows' (the
    attention recompute rate summed over `model` from each rank's heads'
    share)."""
    check_family(cfg)
    x, positions = _embed_inputs_tp(cfg, tp, params, specs, tokens,
                                    image_embeds)
    ctx = _ctx(cfg, positions, use_lamp, attn_impl, moe_groups)
    ep = expert_parallel(cfg, tp, True)
    lsp = _layer_specs(specs)
    auxes = []
    for l in range(cfg.n_layers):
        x, aux = LY.remat_call(remat, block_apply_tp, cfg, tp,
                               layer_params(params["blocks"], l), lsp, x,
                               ctx, ep)
        auxes.append(aux)
    aux = {k: torch.mean(torch.stack([a[k] for a in auxes])) for k in auxes[0]}
    logits, v0 = LY.unembed_tp(cfg, tp, params["embed"], specs["embed"],
                               _final_norm_tp(cfg, tp, params, specs, x))
    aux["attn_lamp_rate"] = C.reduce_over_axis(
        aux["attn_lamp_rate"].detach(), tp.mesh, "model")
    return logits, v0, aux


def loss_fn_tp(cfg, tp: LY.TensorParallel, params, specs, batch, *,
               use_lamp: bool = False, attn_impl: str = "auto",
               remat: bool = True, moe_groups: int = 1):
    """`loss_fn` on the rank's shards and batch rows: the vocabulary-
    parallel cross entropy (``collectives.vocab_parallel_nll``) where the
    logits are split by vocabulary. Returns (the rank's loss, metrics
    averaged over the batch axes); the step averages the loss over them."""
    tokens = batch["tokens"]
    logits, v0, aux = forward_tp(cfg, tp, params, specs, tokens,
                                 image_embeds=batch.get("image_embeds"),
                                 use_lamp=use_lamp, attn_impl=attn_impl,
                                 remat=remat, moe_groups=moe_groups)
    if cfg.family == "llava":
        logits = logits[:, batch["image_embeds"].shape[1]:]
    if logits.shape[-1] < cfg.vocab:
        loss = C.vocab_parallel_nll(logits[:, :-1], tokens[:, 1:], v0,
                                    tp.mesh)
    else:
        loss = next_token_nll(logits, tokens)
    del logits
    if cfg.family == "moe":
        loss = loss + 0.01 * aux["moe_aux_loss"]
    baxes = SH.batch_axes(tp.mesh)
    return loss, {k: C.axis_mean(v, tp.mesh, baxes)
                  for k, v in {"loss": loss, **aux}.items()}


def _logits_tp(cfg, tp, params, specs, x):
    """The final norm and the logits of x, the vocabulary gathered over
    `model` (no gradient)."""
    logits, _ = LY.unembed_tp(cfg, tp, params["embed"], specs["embed"],
                              _final_norm_tp(cfg, tp, params, specs, x))
    if logits.shape[-1] < cfg.vocab:
        logits = C.all_gather(logits, tp.mesh, "model", -1)
    return logits


def prefill_tp(cfg, tp: LY.TensorParallel, params, specs, tokens, cache_k,
               cache_v, *, first: int, rows_split: bool,
               image_embeds=None, use_lamp: bool = True,
               attn_impl: str = "auto", moe_groups: int = 1):
    """`prefill` on the rank's shards, batch rows and cache shards cache_k
    / cache_v (L, B_r, S_l, Hkv, hd) holding positions first .. first +
    S_l: each layer's K/V heads are gathered over `model` and the rank
    writes the prompt's positions in its slice, in place. Returns the
    last position's logits (B_r, 1, V), the vocabulary gathered."""
    check_family(cfg)
    x, positions = _embed_inputs_tp(cfg, tp, params, specs, tokens,
                                    image_embeds)
    T_, S_l, mesh = x.shape[1], cache_k.shape[2], tp.mesh
    n_w = min(max(T_ - first, 0), S_l)
    site, r_site = LY.kq_site(cfg, use_lamp), _router_site(cfg, use_lamp)
    ep = expert_parallel(cfg, tp, rows_split)
    lsp = _layer_specs(specs)
    for l in range(cfg.n_layers):
        p_l = layer_params(params["blocks"], l)
        norms = _norms(tp, p_l, lsp)
        h = LY.apply_norm(cfg, x, norms, "ln1")
        q, k, v = LY.project_qkv_tp(cfg, tp, p_l["attn"], lsp["attn"], h,
                                    positions)
        for c, t in ((cache_k, k), (cache_v, v)):
            whole = C.gather_parts(t, mesh, 2, tp.kv)
            c[l, :, :n_w] = whole[:, first:first + n_w].to(c.dtype)
        out, _ = LY.attend(cfg, q, k, v, site, attn_impl=attn_impl,
                           kv_index=LY.kv_index(tp, cfg, x.device))
        x = x + LY.out_proj_tp(tp, cfg, p_l["attn"], lsp["attn"], out)
        h = LY.apply_norm(cfg, x, norms, "ln2")
        m, _ = _ffn_tp(cfg, tp, p_l, lsp, h, r_site, ep,
                       num_groups=moe_groups)
        x = x + m
    return _logits_tp(cfg, tp, params, specs, x[:, -1:])


def decode_step_tp(cfg, tp: LY.TensorParallel, params, specs, cache_k,
                   cache_v, length, tokens, *, seq_split: bool,
                   use_lamp: bool = True, moe_dropless: bool = True,
                   moe_groups: int = 1):
    """`decode_step` on the rank's shards, batch rows (tokens (B_r, 1),
    length (B_r,)) and cache shards (L, B_r, S_l, Hkv, hd), written in
    place (``layers.attention_decode_tp``; `seq_split`: the sequence split
    over `model`). The MoE runs expert-parallel where `model` divides the
    experts (its expert leaves gathered over `data` a layer at a time).
    Returns the logits (B_r, 1, V), the vocabulary gathered."""
    check_family(cfg)
    x = LY.embed_tp(cfg, tp, params["embed"], specs["embed"], tokens.long(),
                    length.long()[:, None])
    site, r_site = LY.kq_site(cfg, use_lamp), _router_site(cfg, use_lamp)
    ep = expert_parallel(cfg, tp, True)
    lsp = _layer_specs(specs)
    for l in range(cfg.n_layers):
        p_l = layer_params(params["blocks"], l)
        norms = _norms(tp, p_l, lsp)
        h = LY.apply_norm(cfg, x, norms, "ln1")
        x = x + LY.attention_decode_tp(
            cfg, tp, p_l["attn"], lsp["attn"], h, cache_k=cache_k[l],
            cache_v=cache_v[l], length=length, lamp_site=site,
            seq_split=seq_split)
        h = LY.apply_norm(cfg, x, norms, "ln2")
        m, _ = _ffn_tp(cfg, tp, p_l, lsp, h, r_site, ep,
                       dropless=moe_dropless, num_groups=moe_groups)
        x = x + m
    return _logits_tp(cfg, tp, params, specs, x)


def _last_pad(valid_tok: torch.Tensor):
    """(whether any token of the (B, W) window is padding, the B-major flat
    index of the last padded token), both on the device, with no sync.
    Every padded token writes the null block's slot 0; the JAX package's
    scatter leaves the last of them there, and the MoE family routes
    padded tokens (a pad row attends to that slot), so for that family
    the port writes that one last explicitly (a write with duplicate
    indices picks no winner on the card). The other families' padded
    outputs are discarded, and they skip it."""
    pad = ~valid_tok.reshape(-1)
    flipped = torch.flip(pad, (0,)).to(torch.int32)
    return pad.any(), pad.numel() - 1 - torch.argmax(flipped)


def paged_prefill(cfg, params, tokens, arena, block_tables, lengths, *,
                  use_lamp: bool = True, per_layer: bool = False, taus=None,
                  kernel: str = "cuda"):
    """Prefill a padded batch of whole prompts into the paged arena: the
    degenerate window of `paged_prefill_window` with every row starting at
    position 0, so whole-prompt and chunked prefill share one computation.
    tokens: (B, S) left-aligned prompts; lengths: (B,) true prompt lengths
    (padded rows use 1 and a null block table)."""
    starts = torch.zeros_like(lengths)
    return paged_prefill_window(cfg, params, tokens, arena, block_tables,
                                starts, lengths, use_lamp=use_lamp,
                                per_layer=per_layer, taus=taus, kernel=kernel)


def paged_prefill_window(cfg, params, tokens, arena, block_tables, starts,
                         lengths, *, use_lamp: bool = True,
                         per_layer: bool = False, taus=None,
                         kernel: str = "cuda"):
    """Prefill a window of each prompt against its block table: logits at
    each row's last valid window position. See ``paged_mixed_step``."""
    return paged_mixed_step(cfg, params, tokens, arena, block_tables, starts,
                            lengths, use_lamp=use_lamp, per_layer=per_layer,
                            taus=taus, all_logits=False, kernel=kernel)


def paged_verify_window(cfg, params, tokens, arena, block_tables, starts,
                        lengths, *, use_lamp: bool = True,
                        per_layer: bool = False, taus=None,
                        kernel: str = "cuda"):
    """The speculative verifier: row b runs `tokens` at absolute positions
    starts[b] .. starts[b] + lengths[b] - 1, (re)writing their K/V, and
    returns logits for every window position, (B, W, V) -- position j's are
    what a plain decode step at that position would give. Logits past
    lengths[b] are padding. See ``paged_mixed_step``."""
    return paged_mixed_step(cfg, params, tokens, arena, block_tables, starts,
                            lengths, use_lamp=use_lamp, per_layer=per_layer,
                            taus=taus, all_logits=True, kernel=kernel)


def paged_decode_step(cfg, params, arena, block_tables, lengths, tokens, *,
                      use_lamp: bool = True, per_layer: bool = False,
                      taus: Optional[torch.Tensor] = None,
                      kernel: str = "cuda", moe_dropless: bool = True):
    """One continuous-batch decode step over the paged arena.

    tokens: (R, 1) last sampled token per row; lengths: (R,) int32 cache
    fill (the new token's K/V land at position lengths[r]; padded rows use
    length 0 and a null block table). `taus` ((L,) float32 on the device)
    carries the per-layer KQ thresholds; the LAMP rule comes from `cfg` (the
    speculative draft passes its draft config). Writes the arena in place
    and returns (logits (R, 1, V), arena, (n_selected, n_valid)): counts
    (R,), or (L, R) with `per_layer`. `kernel`: the attention path. The MoE
    dispatch is dropless unless `moe_dropless` is False (then the bucket's
    width-1 capacity, ``moe.capacity``)."""
    check_kernel(kernel)
    L = cfg.n_layers
    dev = tokens.device
    x = LY.embed(cfg, params["embed"], tokens.long(), lengths.long()[:, None])
    site = _kq_site(cfg, use_lamp)
    r_site = _router_site(cfg, use_lamp)
    if taus is None:
        taus = torch.full((L,), float(site.tau), dtype=torch.float32, device=dev)
    nsel_l, nval_l = [], []
    for l in range(L):
        p_l = layer_params(params["blocks"], l)
        h = LY.apply_norm(cfg, x, p_l, "ln1")
        a, nsel, nval = LY.paged_attention_decode_sublayer(
            cfg, p_l["attn"], h, arena_k=arena["k"][l], arena_v=arena["v"][l],
            block_tables=block_tables, lengths=lengths, lamp_site=site,
            tau=taus[l], kernel=kernel)
        x = x + a
        h = LY.apply_norm(cfg, x, p_l, "ln2")
        x = x + _ffn(cfg, p_l, h, r_site, dropless=moe_dropless)
        nsel_l.append(nsel)
        nval_l.append(nval)
    x = _final_norm(cfg, params, x)
    nsel, nval = torch.stack(nsel_l), torch.stack(nval_l)
    if not per_layer:
        nsel, nval = nsel.sum(dim=0), nval.sum(dim=0)
    return LY.unembed(cfg, params["embed"], x), arena, (nsel, nval)


def paged_mixed_step(cfg, params, tokens, arena, block_tables, starts,
                     lengths, *, use_lamp: bool = True,
                     per_layer: bool = False, taus=None,
                     all_logits: bool = False, kernel: str = "cuda"):
    """One fused serving step over a mixed row batch.

    tokens: (B, W) window tokens left-aligned per row, padded to the bucket
    width W; starts: (B,) tokens already cached per row; lengths: (B,) live
    tokens in this window (1 for a decode row, the chunk width for a
    prefill row; padded rows use starts 0, lengths 1 and a null block
    table). All index tensors live on the parameters' device.

    Writes the window's K/V into `arena` in place and returns (logits,
    arena, (n_selected, n_valid)): logits (B, 1, V) at each row's last
    valid position, or (B, W, V) with `all_logits`; counts (B,), or (L, B)
    with `per_layer`. `kernel`: the attention path (module docstring).

    The MoE dispatch runs with capacity over the whole (B, W) bucket, pad
    rows and pad slots included, so its routing depends on the bucket's
    composition, as in the JAX package. For that family the attention computes every window
    position (the kernel is given qlens W), so the padded tokens' hidden
    states, which take capacity, are the gather path's on both paths."""
    B = tokens.shape[0]
    x, arena, counts = _paged_window_apply(
        cfg, params, tokens, arena, block_tables, starts, lengths,
        use_lamp=use_lamp, per_layer=per_layer, taus=taus, kernel=kernel)
    if not all_logits:
        last = torch.clamp(lengths.long(), min=1) - 1
        x = x[torch.arange(B, device=x.device), last][:, None]
    return LY.unembed(cfg, params["embed"], x), arena, counts


def _paged_window_apply(cfg, params, tokens, arena, block_tables, starts,
                        lengths, *, use_lamp: bool, per_layer: bool = False,
                        taus: Optional[torch.Tensor] = None,
                        kernel: str = "cuda"):
    """The layer stack over one window per row: the final-norm hidden
    states (B, W, d), the arena (updated in place), and per-row LAMP
    (n_selected, n_valid). `taus` ((L,) float32 on the device) carries the
    per-layer KQ thresholds; layer l's kernel reads taus[l] from device
    memory. The query heads reach attention in FP32, whatever the model's
    dtype (the JAX kernels widen them inside; the CUDA kernel takes FP32).
    A bfloat16 or float16 arena is written by casting (round to nearest
    even, as JAX's `astype`) and read widened to FP32: by the kernel as it
    stages K and V, by the plain versions after their gather."""
    attend, _ = LY.paged_attention_fns(kernel)
    B, W = tokens.shape
    dev = tokens.device
    n_max = block_tables.shape[1]
    bs = arena["k"].shape[2]
    L, H = cfg.n_layers, cfg.n_heads
    starts_l = starts.long()
    positions = starts_l[:, None] + torch.arange(W, device=dev)[None, :]  # (B, W)
    x = LY.embed(cfg, params["embed"], tokens.long(), positions)
    site = _kq_site(cfg, use_lamp)
    r_site = _router_site(cfg, use_lamp)
    valid_tok = torch.arange(W, device=dev)[None, :] < lengths[:, None]
    blk_idx = torch.clamp(positions // bs, 0, n_max - 1)
    blk = torch.where(valid_tok, torch.gather(block_tables.long(), 1, blk_idx), 0)
    off = torch.where(valid_tok, positions % bs, 0)
    qmask = valid_tok.to(torch.float32)
    moe = cfg.family == "moe"
    if moe:
        has_pad, last_pad = _last_pad(valid_tok)
    # the MoE family routes every window position, padding included, so
    # attention computes them all, as the gather path does (the kernel
    # writes zeros past the live queries it is given)
    attn_lens = torch.full_like(lengths, W) if moe else lengths
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
        # tokens all write the null block's slot 0 (for the MoE family the
        # last of them last)
        ck[blk, off] = k.to(ck.dtype)
        cv[blk, off] = v.to(cv.dtype)
        for c, new in ((ck, k), (cv, v)) if moe else ():
            c[0, 0] = torch.where(has_pad, new.reshape(B * W, *new.shape[2:])
                                  [last_pad].to(c.dtype), c[0, 0])
        qh = q.transpose(1, 2).float().contiguous()
        o, nsel_rows = attend(
            qh, ck, cv, block_tables, starts, attn_lens, site, tau=taus[l],
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
        x = x + _ffn(cfg, p_l, h, r_site)
    x = _final_norm(cfg, params, x)
    nsel, nval = torch.stack(nsel_l), torch.stack(nval_l)
    if not per_layer:
        nsel, nval = nsel.sum(dim=0), nval.sum(dim=0)
    return x, arena, (nsel, nval)


def paged_audit_window(cfg, params, tokens, arena, block_tables, starts,
                       lengths, row_mask, *, taus=None, top_k: int = 5
                       ) -> Dict[str, torch.Tensor]:
    """Shadow-audit forward: the LAMP serving arm and the FP32 reference arm
    in lockstep over one window batch; only error telemetry comes back,
    never logits to sample from and never a written arena.

    Row b replays tokens at absolute positions starts[b] .. starts[b] +
    lengths[b] - 1 against its block table, as `paged_mixed_step` does:
    decode rows ride as width-1 windows, speculative rows as their
    pre-draft width-1 window, prefill rows as their chunk. Three streams a
    layer:

      * lamp:   the serving computation (LAMP attention at the live
                `taus`), carried through the stack;
      * ref:    LAMP off (`attention_reference`, uniform FP32), carried
                separately;
      * shadow: LAMP attention on the ref stream's own q/k/v, against the
                ref attention on them: layer l's local KQ-site error,
                free of what the layers below passed up. For the MoE
                family also the router at its LAMP site on the ref
                stream's FFN input, against the ref stream's router:
                layer l's local router-site error.

    The lamp stream's router takes the router site when its KQ site is
    on, the ref stream's never; every MoE dispatch is over the whole
    bucket with capacity, as in the window steps.

    Attention runs the gather path (``core.attention`` in the order
    "dot_ps", the order held against the JAX package) on every device and
    whatever the engine's attention path, as the JAX package's audit does:
    on a card that is the plain versions, by name. The served step still
    runs the kernels, each call of which equals its plain version on the
    same inputs (outputs to rtol 2e-5 / atol 2e-6, counts exact).

    The served arena is only read. Each stream gathers each row's
    block-table span into a copy of its own (B x n_max * block_size keys a
    layer, not the whole arena) and writes the window's K/V into that copy
    at flat index = absolute position, cast to the arena's dtype as the
    serving step writes it, and for the MoE family the stream's last
    padded token's K/V at every span position that is the null block's
    slot 0 (as the JAX package's write of the whole window leaves it);
    the span is then widened to FP32.

    `row_mask` (B,) zeroes padded bucket rows out of every reduction.
    Returns float32 tensors on the device:
      kq_err / router_err / cum_err : (L,) mean per-token relative L2 error
        (local KQ site, local router site -- 0 for the dense families and
        with the router site off -- and cumulative hidden-state drift);
      logit_rel / logit_max_abs : (B,) final-position logit error;
      flip : (B,) 1.0 where the greedy argmax token differs;
      topk : (B,) |top-k(lamp) & top-k(ref)| / k.
    Per-row entries of padded rows are garbage; callers slice the live
    prefix."""
    from repro_torch.core import attention as CA

    B, W = tokens.shape
    dev = tokens.device
    n_max = block_tables.shape[1]
    bs = arena["k"].shape[2]
    L, H, Hkv, hd = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    S = n_max * bs
    positions = starts.long()[:, None] + torch.arange(W, device=dev)[None, :]
    site = _kq_site(cfg, True)
    r_site = _router_site(cfg, True)
    off = LampSite(enabled=False)
    audit_router = cfg.family == "moe" and r_site.enabled
    valid_tok = torch.arange(W, device=dev)[None, :] < lengths[:, None]
    # the window's live tokens: (row, window slot) and their flat index in
    # the row's gathered span, which is their absolute position
    rows_i, cols_i = torch.nonzero(valid_tok, as_tuple=True)
    flat_i = positions[rows_i, cols_i]
    bt = block_tables.long()
    if taus is None:
        taus = torch.full((L,), float(site.tau), dtype=torch.float32, device=dev)

    w = valid_tok.to(torch.float32) * row_mask.to(torch.float32)[:, None]
    wsum = torch.clamp(torch.sum(w), min=1.0)

    def werr(a, b):
        # per-token relative L2 error over the feature axis, averaged over
        # the live tokens of live rows, in FP32
        af, bf = a.to(torch.float32), b.to(torch.float32)
        num = torch.sqrt(torch.sum((af - bf) ** 2, dim=-1))
        den = torch.sqrt(torch.sum(bf ** 2, dim=-1)) + 1e-30
        return torch.sum((num / den) * w) / wsum

    # for the MoE family, span positions that are the null block's slot 0,
    # where the stream's last padded token lands (``_last_pad``)
    if cfg.family == "moe":
        has_pad, last_pad = _last_pad(valid_tok)
        null0 = ((bt.repeat_interleave(bs, dim=1) == 0)
                 & (torch.arange(S, device=dev) % bs == 0)[None, :]) & has_pad

    def span(arena_l, new):
        # the rows' block-table spans, copied, with this stream's window
        # written at its positions; widened to FP32 as (B, H, S, hd)
        t = arena_l[bt].reshape(B, S, Hkv, hd)
        t[rows_i, flat_i] = new[rows_i, cols_i].to(t.dtype)
        if cfg.family == "moe":
            pad_kv = new.reshape(B * W, Hkv, hd)[last_pad].to(t.dtype)
            t = torch.where(null0[:, :, None, None], pad_kv, t)
        t = t.to(torch.float32).transpose(1, 2)
        return t.repeat_interleave(H // Hkv, dim=1) if H != Hkv else t

    def flat(o):
        # (B, H, W, hd) attention layout -> (B, W, H * hd) feature rows
        return o.transpose(1, 2).reshape(B, W, -1)

    def attn(qh, kh, vh, lamp_site, tau_l):
        if lamp_site.enabled:
            o, _ = CA.attention_lamp(qh, kh, vh, lamp_site, causal=True,
                                     window=cfg.window, offset=starts,
                                     reduce=False, tau=tau_l)
            return o
        return CA.attention_reference(qh, kh, vh, causal=True,
                                      window=cfg.window, offset=starts)

    def arm(xc, p_l, l, lamp_site, tau_l):
        # one residual block of one stream: the new carry and the
        # intermediates the shadow computation needs
        h = LY.apply_norm(cfg, xc, p_l, "ln1")
        q, k, v = LY._project_qkv(cfg, p_l["attn"], h, positions)
        qh = q.transpose(1, 2)
        kh, vh = span(arena["k"][l], k), span(arena["v"][l], v)
        o = attn(qh, kh, vh, lamp_site, tau_l)
        xc = xc + flat(o).to(xc.dtype) @ p_l["attn"]["wo"]
        h2 = LY.apply_norm(cfg, xc, p_l, "ln2")
        m = _ffn(cfg, p_l, h2, r_site if lamp_site.enabled else off)
        return xc + m, (qh, kh, vh, o, h2, m)

    x0 = LY.embed(cfg, params["embed"], tokens.long(), positions)
    x_l = x_r = x0
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    kq_err, router_err, cum_err = [], [], []
    for l in range(L):
        p_l = layer_params(params["blocks"], l)
        x_l, _ = arm(x_l, p_l, l, site, taus[l])
        x_r, (qh_r, kh_r, vh_r, o_r, h2_r, m_r) = arm(x_r, p_l, l, off,
                                                      taus[l])
        o_s = attn(qh_r, kh_r, vh_r, site, taus[l])
        kq_err.append(werr(flat(o_s), flat(o_r)))
        if audit_router:
            # the ref stream's own FFN output is the router-off arm
            m_s = _ffn(cfg, p_l, h2_r, r_site)
            router_err.append(werr(m_s, m_r))
        else:
            router_err.append(zero)
        cum_err.append(werr(x_l, x_r))

    last = torch.clamp(lengths.long(), min=1) - 1
    rows = torch.arange(B, device=dev)

    def final(x):
        x = _final_norm(cfg, params, x)
        x = x[rows, last][:, None]
        return LY.unembed(cfg, params["embed"], x)[:, 0].to(torch.float32)

    lg_l, lg_r = final(x_l), final(x_r)                               # (B, V)
    diff = lg_l - lg_r
    logit_rel = (torch.sqrt(torch.sum(diff ** 2, dim=-1))
                 / (torch.sqrt(torch.sum(lg_r ** 2, dim=-1)) + 1e-30))
    logit_max_abs = torch.amax(torch.abs(diff), dim=-1)
    # torch.argmax, like jnp.argmax, returns the first maximum
    flip = (torch.argmax(lg_l, dim=-1)
            != torch.argmax(lg_r, dim=-1)).to(torch.float32)
    k = max(1, min(int(top_k), int(cfg.vocab)))

    def topk_idx(lg):
        # a stable descending sort keeps the lower index first on ties, as
        # lax.top_k does (torch.topk does not promise an order on ties)
        return torch.sort(lg, dim=-1, descending=True, stable=True)[1][:, :k]

    idx_l, idx_r = topk_idx(lg_l), topk_idx(lg_r)
    topk = torch.mean((idx_l[:, :, None] == idx_r[:, None, :]).any(-1)
                      .to(torch.float32), dim=-1)
    return {"kq_err": torch.stack(kq_err),
            "router_err": torch.stack(router_err),
            "cum_err": torch.stack(cum_err),
            "logit_rel": logit_rel, "logit_max_abs": logit_max_abs,
            "flip": flip, "topk": topk}
