"""Gradient compression for bandwidth-bound data parallelism (port of
``repro/optim/compression.py``).

Two composable schemes:

  * top-k sparsification with error feedback (memory): each worker sends
    only the largest-|g| fraction of every leaf; the residual is added back
    into the next step's gradient. The error-feedback memory guarantees all
    mass is eventually applied.

  * int8 quantization with a per-leaf scale: linear quantization of the
    (already sparse or dense) gradient to int8 for the wire, dequantized
    after the all-reduce.

Pure functions over nested dicts of tensors, in JAX's leaf order
(``core.tree``); the quantized collective waits for the port's
``torch.distributed`` slice.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core import tree as T


def topk_compress(grads: Any, error: Any, frac: float) -> Tuple[Any, Any, Dict]:
    """Keep the top `frac` of entries per leaf (by |g|), carry the rest in
    the error-feedback memory. Returns (sparse_grads, new_error, stats).
    The threshold is the k-th largest |g| and every entry at or above it is
    kept, ties included, as the JAX package keeps them; a leaf of at most
    16 entries, or `frac` 1, passes whole."""
    if not 0.0 < frac <= 1.0:
        raise ValueError("frac in (0, 1]")

    def one(g, e):
        gf = g.float() + e
        if frac >= 1.0 or g.numel() <= 16:
            return gf, torch.zeros_like(gf)
        k = max(1, int(g.numel() * frac))
        thr = torch.topk(torch.abs(gf).reshape(-1), k, sorted=True)[0][-1]
        mask = torch.abs(gf) >= thr
        sent = torch.where(mask, gf, torch.zeros_like(gf))
        return sent, gf - sent

    outs = [one(g, e) for g, e in zip(T.leaves(grads), T.leaves(error))]
    sent = T.unflatten(grads, [o[0] for o in outs])
    new_err = T.unflatten(grads, [o[1] for o in outs])
    density = sum(float(torch.mean((s != 0).float()) * s.numel())
                  for s in T.leaves(sent))
    total = sum(s.numel() for s in T.leaves(sent))
    return sent, new_err, {"density": density / max(total, 1)}


def init_error(params: Any) -> Any:
    return T.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), params)


def quantize_int8(tree: Any) -> Tuple[Any, Any]:
    """Per-leaf symmetric int8 quantization. Returns (q_tree, scales).
    Halves round to even (``torch.round``, as ``jnp.round``)."""
    def one(g):
        gf = g.float()
        scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        return q, scale
    outs = [one(g) for g in T.leaves(tree)]
    return (T.unflatten(tree, [o[0] for o in outs]),
            T.unflatten(tree, [o[1] for o in outs]))


def dequantize_int8(q_tree: Any, scales: Any) -> Any:
    return T.map(lambda q, s: q.float() * s, q_tree, scales)


def compressed_wire_bytes(tree: Any, frac: float) -> int:
    """Estimated wire bytes for topk(frac)+int8 vs dense f32 (for logging)."""
    n = sum(x.numel() for x in T.leaves(tree))
    k = int(n * frac)
    return k * (1 + 4)  # int8 payload + int32 index per surviving entry
