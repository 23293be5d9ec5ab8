"""Shape-only stand-ins for every (arch x input-shape) cell (port of
``repro/launch/specs.py``).

The JAX package takes shapes from ``jax.eval_shape`` over the real
initializer. Here every tree is made of fake tensors
(``torch._subclasses.fake_tensor``) under one ``FakeTensorMode``, the
counterpart of ``eval_shape``: the real initializers run, and nothing is
allocated or drawn. The dry run runs its steps on them under the same mode.
Fake tensors sit on the CPU device: the dry run is a host tool.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs import SHAPES, InputShape, ModelConfig, get_config
from repro_torch.models import api
from repro_torch.optim import adamw


def fake_mode():
    """A new ``FakeTensorMode`` for one cell's trees and step (real
    tensors made outside it, such as a module's constants, may enter)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def params_shape(cfg: ModelConfig, mode):
    with mode:
        return api.init_params(cfg, 0, device="cpu")


def opt_shape(p_shape, mode):
    with mode:
        return adamw.init_state(p_shape)


def batch_specs_for(cfg: ModelConfig, batch: int, seq: int,
                    mode) -> Dict[str, Any]:
    """Training / prefill batch: tokens + stub modality inputs."""
    with mode:
        b: Dict[str, Any] = {"tokens": torch.empty((batch, seq),
                                                   dtype=torch.int32)}
        if cfg.family == "whisper":
            b["frames"] = torch.empty((batch, cfg.enc_seq, cfg.d_model),
                                      dtype=torch.bfloat16)
        if cfg.family == "llava":
            b["image_embeds"] = torch.empty((batch, cfg.n_patches, cfg.d_model),
                                            dtype=torch.bfloat16)
    return b


def cache_shape(cfg: ModelConfig, batch: int, max_len: int, mode):
    with mode:
        return api.init_cache(cfg, batch, max_len, torch.bfloat16,
                              device="cpu")


def input_specs(arch: str, shape_name: str) -> Dict[str, Any]:
    """Everything the dry run needs for one cell (shapes only), and the
    mode its fake tensors belong to (`mode`)."""
    return cell_specs(get_config(arch), SHAPES[shape_name])


def cell_specs(cfg: ModelConfig, shp: InputShape) -> Dict[str, Any]:
    """`input_specs` of any config and shape."""
    mode = fake_mode()
    out: Dict[str, Any] = {"cfg": cfg, "shape": shp, "mode": mode}
    p_shape = params_shape(cfg, mode)
    out["params"] = p_shape
    if shp.kind == "train":
        out["batch"] = batch_specs_for(cfg, shp.global_batch, shp.seq_len,
                                       mode)
        out["opt"] = opt_shape(p_shape, mode)
    elif shp.kind == "prefill":
        out["batch"] = batch_specs_for(cfg, shp.global_batch, shp.seq_len,
                                       mode)
        out["cache"] = cache_shape(cfg, shp.global_batch,
                                   shp.seq_len + cfg.n_patches, mode)
    elif shp.kind == "decode":
        with mode:
            out["tokens"] = torch.empty((shp.global_batch, 1),
                                        dtype=torch.int32)
        out["cache"] = cache_shape(cfg, shp.global_batch,
                                   shp.seq_len + cfg.n_patches, mode)
    return out
