"""Roofline terms of a dry-run cell on the H100 (port of
``repro/launch/roofline.py``).

Terms, per rank, from the H100 SXM data-sheet constants of ``launch.mesh``:

    compute_s    = bf16/fp16 flops / PEAK_FLOPS_BF16
                   + FP32 flops / PEAK_FLOPS_FP32
    memory_s     = bytes / HBM_BW
    collective_s = collective bytes / NVLINK_BW_PER_LINK

The counts come from ``launch.op_cost``. FP32 matmuls (the LAMP recompute
arm, an FP32 config) run on the CUDA cores, since the port turns TF32
off. The collective term is the JAX package's first-order proxy: the
result-shape bytes of every collective over one link's rate (a ring
all-reduce really moves about twice that, and a collective spreads over
many links). These are readings of counts against data-sheet peaks, not
measurements.
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.core import tree as T

from .mesh import HBM_BW, NVLINK_BW_PER_LINK, PEAK_FLOPS_BF16, PEAK_FLOPS_FP32


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float,
                   fp32_flops_per_dev: float = 0.0) -> Dict[str, Any]:
    """`flops_per_dev` counts every flop, `fp32_flops_per_dev` the share of
    them that runs in FP32."""
    compute_s = ((flops_per_dev - fp32_flops_per_dev) / PEAK_FLOPS_BF16
                 + fp32_flops_per_dev / PEAK_FLOPS_FP32)
    memory_s = bytes_per_dev / HBM_BW
    collective_s = coll_bytes_per_dev / NVLINK_BW_PER_LINK
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    total = sum(terms.values())
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        # if the terms overlap fully, step time = max(terms): the dominant
        # term over their sum (1.0 = all on one roof)
        "overlap_efficiency": bound / total if total else 0.0,
    }


def active_params(p_shape, cfg) -> Dict[str, float]:
    """Total and active (MoE-discounted) parameter counts from shapes."""
    total = 0
    expert = 0
    for path, leaf in T.flatten_with_path(p_shape):
        n = 1
        for d in leaf.shape:
            n *= d
        total += n
        if "we_in" in "/".join(path) or "we_out" in "/".join(path):
            expert += n
    active = total - expert
    if cfg.n_experts:
        active += expert * cfg.top_k / cfg.n_experts
    return {"n_params": float(total), "n_active": float(active)}


def model_flops(cfg, p_shape, kind: str, batch: int, seq: int) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference forward), N = active."""
    n = active_params(p_shape, cfg)["n_active"]
    tokens = batch * (seq if kind in ("train", "prefill") else 1)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens
