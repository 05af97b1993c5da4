"""llama-3.2-vision-90b [vlm]: 100L d=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — 80 self-attention + 20 cross-attention layers (every 5th
layer cross-attends to image embeddings). The vision frontend is a STUB:
input_specs provides precomputed patch embeddings (B, 1600, d).
[hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.models.transformer import LayerSpec, ModelConfig

IMAGE_TOKENS = 1600

_PATTERN = (LayerSpec(),) * 4 + (LayerSpec(mixer="cross_attn", causal=False),)


def full() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", d_model=8192, n_layers=100, n_heads=64,
        n_kv_heads=8, d_ff=28672, vocab=128256,
        pattern=_PATTERN, mlp_kind="swiglu",
        rope_theta=500_000.0, attn_chunk=512, dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-smoke", d_model=64, n_layers=5, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=512,
        pattern=_PATTERN, mlp_kind="swiglu", attn_chunk=16,
        dtype="float32",
    )
