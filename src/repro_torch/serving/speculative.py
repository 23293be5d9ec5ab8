"""LAMP self-draft speculative decoding over the paged KV pool (port of
``repro/serving/speculative.py``).

One set of weights plays both roles:

  draft   = the pure low-precision forward (LAMP rule "none": PS(mu) KQ
            products, nothing recomputed): `draft_len` paged decode steps
            per row, through the decode kernel, writing draft K/V into the
            row's own blocks.
  verify  = the LAMP selective-recompute pass (the engine's rule) over all
            draft_len + 1 positions in one window (`paged_verify_window`,
            the mixed kernel), which rewrites the drafted positions' K/V
            with verify-quality values.

Acceptance is the standard rule (Leviathan et al. '23): greedy rows accept
a draft while it equals the verifier's argmax, so their tokens are those
of plain decoding; sampled rows accept d ~ q with probability
min(1, p(d)/q(d)) and resample a rejection from norm(max(p - q, 0)).
Draws come from per-row generators keyed on (request seed, position,
salt), so sampled streams match the JAX engine's in distribution, not in
bits. Rows whose budget kd is below draft_len freeze their draft cursor:
frozen steps rewrite the same tail position with the same token, and the
verifier masks everything past kd + 1.

These are plain functions: PyTorch runs eagerly, so there is no step cache.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import transformer

from . import sampling as SM

@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """draft_len -- tokens drafted per row per round (k); the verify
                 window scores k + 1 positions (k drafts + the bonus)."""
    draft_len: int = 4

    def __post_init__(self):
        if self.draft_len < 1:
            raise ValueError(f"draft_len must be >= 1, got {self.draft_len}")

    @property
    def verify_width(self) -> int:
        """Verify-window bucket: next power of two >= draft_len + 1."""
        w = 1
        while w < self.draft_len + 1:
            w *= 2
        return w


def draft_model_config(cfg):
    """The drafter's config: same weights and mu, rule "none" at the KQ
    site (the pure low-precision forward)."""
    pol = cfg.lamp
    if not pol.kq.enabled or pol.kq.rule == "none":
        return cfg
    return cfg.replace(lamp=pol.replace(kq=pol.kq.replace(rule="none")))


def speculative_accept(verify_logits: torch.Tensor, draft_tokens: torch.Tensor,
                       draft_logits: torch.Tensor, kd: Sequence[int],
                       seeds: Sequence[int], counts: Sequence[int],
                       temps: Sequence[float], top_k=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Accept / reject and correction sampling (JAX ``speculative.py:105``).

    verify_logits (R, >= k+1, V): position j scores the token after draft
    prefix d_1..d_j; draft_tokens (R, k) (ignored past kd); draft_logits
    (R, k, V), the unfiltered logits each proposal was drawn from; kd,
    seeds, counts (tokens generated at round start), temps and top_k (None:
    no row filters) are host sequences of length R.

    Returns (emit (R, k+1) int64, n_accepted (R,) int64) on the logits'
    device: row r's tokens are emit[r, :n_accepted[r] + 1]."""
    R, k = draft_tokens.shape
    dev = verify_logits.device
    p_f, q_f = verify_logits[:, :k + 1], draft_logits
    if top_k is not None:
        p_f = SM.apply_top_k_rows(p_f, top_k)
        q_f = SM.apply_top_k_rows(q_f, top_k)
    d = draft_tokens.long()
    kd_t = torch.as_tensor(np.asarray(kd), device=dev).long()
    rows = torch.arange(R, device=dev)
    j = torch.arange(k, device=dev)[None, :]
    p_arg = torch.argmax(p_f, dim=-1)                      # (R, k+1)
    acc = p_arg[:, :k] == d
    sampled = [i for i in range(R) if float(temps[i]) > 0]
    if sampled:
        tsafe = torch.clamp(torch.as_tensor(np.asarray(temps, np.float32),
                                            device=dev), min=1e-6)[:, None, None]
        p_prob = torch.softmax(p_f / tsafe, dim=-1)
        q_prob = torch.softmax(q_f / tsafe, dim=-1)
        p_d = torch.gather(p_prob[:, :k], -1, d[..., None])[..., 0]
        q_d = torch.gather(q_prob, -1, d[..., None])[..., 0]
        srows = torch.as_tensor(sampled, device=dev)
        c0 = np.asarray(counts, np.int64)[sampled]
        u = SM.row_uniforms([seeds[i] for i in sampled],
                            c0[:, None] + np.arange(k)[None, :],
                            SM.SALT_ACCEPT, device=dev)
        acc[srows] = (u * q_d[srows]) <= p_d[srows]
    acc = acc & (j < kd_t[:, None])
    n_acc = torch.cumprod(acc.long(), dim=1).sum(dim=1)   # (R,) in [0, kd]
    corr = p_arg[rows, n_acc]
    if sampled:
        na = n_acc[srows]
        p_a = p_prob[srows, na]
        q_a = q_prob[srows, torch.clamp(na, max=k - 1)]
        # rejected at n_acc < kd: residual max(p - q, 0); all accepted: the
        # bonus position, sampled from p
        dist = torch.where((na < kd_t[srows])[:, None],
                           torch.clamp(p_a - q_a, min=0.0), p_a)
        # degenerate residual (p <= q up to roundoff): the target itself
        dist = torch.where(dist.sum(-1, keepdim=True) > 0, dist, p_a)
        g = SM.row_gumbel([seeds[i] for i in sampled],
                          c0 + na.cpu().numpy(), SM.SALT_RESIDUAL,
                          (dist.shape[-1],), device=dev)
        logd = torch.where(dist > 0, torch.log(dist),
                           torch.full_like(dist, float("-inf")))
        corr[srows] = torch.argmax(logd + g, dim=-1)
    emit = torch.where(j < n_acc[:, None], d, torch.zeros_like(d))
    emit = torch.cat([emit, torch.zeros((R, 1), dtype=emit.dtype, device=dev)], 1)
    emit[rows, n_acc] = corr
    return emit, n_acc


def draft(cfg, params, arena, block_tables: torch.Tensor,
          lengths: torch.Tensor, tok0: torch.Tensor, kd: Sequence[int],
          spec: SpecConfig, *, use_lamp: bool, seeds, counts, temps,
          top_k=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """`draft_len` low-precision paged decode steps (rule "none", through
    the decode kernel), each proposal drawn from the draft distribution
    with the SALT_DRAFT stream. Row r freezes at its budget kd[r]: step j
    writes position lengths + min(j, kd). block_tables, lengths (int32) and
    tok0 lie on the arena's device; kd, seeds, counts, temps and top_k are
    host sequences. Returns (draft_tokens (R, k) int64, draft_logits
    (R, k, V) float32)."""
    dcfg = draft_model_config(cfg) if use_lamp else cfg
    kd_t = torch.as_tensor(np.asarray(kd), device=lengths.device).to(lengths.dtype)
    counts = np.asarray(counts, np.int64)
    tok = tok0.long()
    toks, logs = [], []
    for j in range(spec.draft_len):
        len_j = lengths + torch.clamp(kd_t, max=j)
        logits, _, _ = transformer.paged_decode_step(
            dcfg, params, arena, block_tables, len_j, tok[:, None],
            use_lamp=use_lamp)
        lg = logits[:, -1]
        nxt = SM.sample_rows(lg, seeds, counts + j, temps, top_k,
                             salt=SM.SALT_DRAFT)
        tok = torch.where(j < kd_t, nxt, tok)
        toks.append(tok)
        logs.append(lg)
    return torch.stack(toks, dim=1), torch.stack(logs, dim=1)


def verify(cfg, params, arena, block_tables: torch.Tensor,
           lengths: torch.Tensor, tok0: torch.Tensor,
           draft_tokens: torch.Tensor, draft_logits: torch.Tensor,
           kd: Sequence[int], spec: SpecConfig, *, use_lamp: bool,
           taus: Optional[torch.Tensor], seeds, counts, temps, top_k=None):
    """One window [tok0, d_1..d_k], padded to `verify_width`, at positions
    lengths .. lengths + kd with the engine's LAMP rule (rewriting their
    K/V), then `speculative_accept`. Returns (emit, n_accepted, n_selected
    (L, R), n_valid (L, R))."""
    k = spec.draft_len
    R = tok0.shape[0]
    win = torch.zeros((R, spec.verify_width), dtype=torch.int32,
                      device=tok0.device)
    win[:, 0] = tok0
    win[:, 1:k + 1] = draft_tokens
    qlens = torch.as_tensor(np.asarray(kd) + 1, device=lengths.device
                            ).to(torch.int32)
    logits, _, (nsel, nval) = transformer.paged_verify_window(
        cfg, params, win, arena, block_tables, lengths, qlens,
        use_lamp=use_lamp, per_layer=True, taus=taus)
    emit, n_acc = speculative_accept(logits, draft_tokens, draft_logits, kd,
                                     seeds, counts, temps, top_k)
    return emit, n_acc, nsel, nval
