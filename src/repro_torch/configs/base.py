"""Config system: model configs, input shapes, and the arch registry."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.policy import LampPolicy


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config object for every architecture family.

    Family selects the block structure:
      dense   -- decoder-only transformer (GQA + MLP)
      moe     -- decoder-only with MoE FFN (top-k router)
      gpt2    -- GPT-2 (LayerNorm, learned pos, MHA) for the paper repro
      llava   -- dense backbone + patch-embedding frontend stub
      whisper -- encoder-decoder + frame-embedding frontend stub
      hymba   -- hybrid: parallel attention (SWA) + Mamba heads per layer
      rwkv6   -- attention-free RWKV-6 "Finch"
    """
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    act: str = "swiglu"              # gelu | geglu | swiglu | relu2
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    pos: str = "rope"                # rope | learned | none
    rope_theta: float = 1e4
    rope_fraction: float = 1.0       # glm4 applies RoPE to half the head dim
    qk_norm: bool = False            # qwen3/olmoe RMS-norm on q,k heads
    tie_embeddings: bool = False
    scale_embed: bool = False        # gemma: embeddings * sqrt(d)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    window: Optional[int] = None     # sliding-window attention
    n_meta_tokens: int = 0           # hymba learnable meta tokens
    # encoder-decoder
    n_enc_layers: int = 0
    enc_seq: int = 0                 # whisper: 1500 frame embeddings (stub)
    # vlm
    n_patches: int = 0               # llava: patch tokens from the stub frontend
    max_seq: int = 8192              # learned-pos table size
    dtype: str = "bfloat16"
    lamp: LampPolicy = dataclasses.field(default_factory=LampPolicy.deployment)
    source: str = ""                 # provenance note

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "rwkv6"

    @property
    def subquadratic(self) -> bool:
        """Can this arch serve 500k-token contexts? (SSM / hybrid-SWA only)"""
        return self.family in ("rwkv6", "hymba")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """(runnable, reason-if-not). long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: 500k-token KV cache/attention is "
                       "quadratic -- skipped per assignment (DESIGN.md Sec 6)")
    return True, ""


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    return sorted(_REGISTRY)


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
            vocab: int = 512) -> ModelConfig:
    """Shrink a config to CPU-smoke scale, preserving family features."""
    heads = max(2, min(cfg.n_heads, 4))
    kv = max(1, min(cfg.n_kv_heads, heads))
    hd = max(8, d_model // heads)
    kw = dict(
        n_layers=min(cfg.n_layers, layers),
        d_model=d_model,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=hd,
        d_ff=d_model * 2,
        vocab=vocab,
        max_seq=512,
        dtype="float32",
    )
    if cfg.n_experts:
        kw.update(n_experts=min(cfg.n_experts, 8), top_k=min(cfg.top_k, 2))
    if cfg.n_enc_layers:
        kw.update(n_enc_layers=min(cfg.n_enc_layers, layers))
    if cfg.enc_seq:
        kw.update(enc_seq=16)
    if cfg.n_patches:
        kw.update(n_patches=8)
    if cfg.window:
        kw.update(window=32)
    if cfg.n_meta_tokens:
        kw.update(n_meta_tokens=4)
    return cfg.replace(name=cfg.name + "-reduced", **kw)
