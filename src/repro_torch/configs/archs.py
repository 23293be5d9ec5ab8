"""The 10 assigned architectures (exact published dims) + GPT-2 family."""

from repro_torch.core.policy import LampPolicy

from .base import ModelConfig, register


@register("whisper-medium")
def whisper_medium() -> ModelConfig:
    # [arXiv:2212.04356; unverified] enc-dec, conv frontend stubbed.
    return ModelConfig(
        name="whisper-medium", family="whisper",
        n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab=51865, act="gelu", norm="layernorm", pos="learned",
        enc_seq=1500, max_seq=33792,
        source="arXiv:2212.04356",
    )


@register("qwen3-moe-30b-a3b")
def qwen3_moe() -> ModelConfig:
    # [hf:Qwen/Qwen3-30B-A3B; hf] 128 experts top-8, GQA kv=4, qk-norm.
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=768, vocab=151936, act="swiglu", norm="rmsnorm", pos="rope",
        rope_theta=1e6, qk_norm=True, n_experts=128, top_k=8,
        max_seq=40960, source="hf:Qwen/Qwen3-30B-A3B",
    )


@register("olmoe-1b-7b")
def olmoe() -> ModelConfig:
    # [arXiv:2409.02060; hf] 64 experts top-8.
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab=50304, act="swiglu", norm="rmsnorm", pos="rope",
        qk_norm=True, n_experts=64, top_k=8,
        max_seq=4096, source="arXiv:2409.02060",
    )


@register("gemma-7b")
def gemma_7b() -> ModelConfig:
    # [arXiv:2403.08295; hf] GeGLU, head_dim=256, tied + scaled embeddings.
    return ModelConfig(
        name="gemma-7b", family="dense",
        n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
        d_ff=24576, vocab=256000, act="geglu", norm="rmsnorm", pos="rope",
        tie_embeddings=True, scale_embed=True,
        max_seq=8192, source="arXiv:2403.08295",
    )


@register("starcoder2-15b")
def starcoder2() -> ModelConfig:
    # [arXiv:2402.19173; hf] GQA kv=4, RoPE, LayerNorm + GELU.
    return ModelConfig(
        name="starcoder2-15b", family="dense",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
        d_ff=24576, vocab=49152, act="gelu", norm="layernorm", pos="rope",
        rope_theta=1e5, max_seq=16384, source="arXiv:2402.19173",
    )


@register("glm4-9b")
def glm4() -> ModelConfig:
    # [hf:THUDM/glm-4-9b; hf] GQA kv=2, partial rotary (0.5).
    return ModelConfig(
        name="glm4-9b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab=151552, act="swiglu", norm="rmsnorm", pos="rope",
        rope_fraction=0.5, max_seq=131072, source="hf:THUDM/glm-4-9b",
    )


@register("mistral-large-123b")
def mistral_large() -> ModelConfig:
    # [hf:mistralai/Mistral-Large-Instruct-2407; unverified] GQA kv=8.
    return ModelConfig(
        name="mistral-large-123b", family="dense",
        n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
        d_ff=28672, vocab=32768, act="swiglu", norm="rmsnorm", pos="rope",
        rope_theta=1e6, max_seq=131072,
        source="hf:mistralai/Mistral-Large-Instruct-2407",
    )


@register("llava-next-mistral-7b")
def llava_next() -> ModelConfig:
    # [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] anyres tiling
    # stubbed: input_specs() supplies 576 base-grid patch embeddings.
    return ModelConfig(
        name="llava-next-mistral-7b", family="llava",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=32000, act="swiglu", norm="rmsnorm", pos="rope",
        n_patches=576, max_seq=32768,
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    )


@register("hymba-1.5b")
def hymba_15b() -> ModelConfig:
    # [arXiv:2411.13676; hf] parallel attn+mamba heads, SWA, meta tokens.
    return ModelConfig(
        name="hymba-1.5b", family="hymba",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
        d_ff=5504, vocab=32001, act="swiglu", norm="rmsnorm", pos="rope",
        ssm_state=16, window=1024, n_meta_tokens=128,
        max_seq=8192, source="arXiv:2411.13676",
    )


@register("rwkv6-7b")
def rwkv6() -> ModelConfig:
    # [arXiv:2404.05892; hf] Finch: attention-free, data-dependent decay.
    return ModelConfig(
        name="rwkv6-7b", family="rwkv6",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
        d_ff=14336, vocab=65536, act="relu2", norm="layernorm", pos="none",
        lamp=LampPolicy.disabled(),  # KQ-LAMP inapplicable (DESIGN.md Sec 6)
        max_seq=4096, source="arXiv:2404.05892",
    )


# --- GPT-2 family for the paper's own experiments (Sec 4, App C) -----------

@register("gpt2")
def gpt2() -> ModelConfig:
    """Alias for the paper's default GPT-2 small setting."""
    return gpt2_small().replace(name="gpt2")


@register("gpt2-small")
def gpt2_small() -> ModelConfig:
    return ModelConfig(
        name="gpt2-small", family="gpt2",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab=50257, act="gelu", norm="layernorm", pos="learned",
        tie_embeddings=True, max_seq=1024, dtype="float32",
        lamp=LampPolicy.paper_default(), source="gpt2",
    )


@register("gpt2-xl")
def gpt2_xl() -> ModelConfig:
    return ModelConfig(
        name="gpt2-xl", family="gpt2",
        n_layers=48, d_model=1600, n_heads=25, n_kv_heads=25,
        d_ff=6400, vocab=50257, act="gelu", norm="layernorm", pos="learned",
        tie_embeddings=True, max_seq=1024, dtype="float32",
        lamp=LampPolicy.paper_default(), source="gpt2",
    )
