"""jamba-1.5-large-398b [hybrid]: 72L d=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2 — Mamba:attention 1:7 interleave (one attention
layer per 8-layer block), MoE on every other layer. [arXiv:2403.19887]"""
from repro_torch.models.transformer import LayerSpec, ModelConfig

_PATTERN = (
    LayerSpec(mixer="mamba"),
    LayerSpec(mixer="mamba", ffn="moe"),
    LayerSpec(mixer="mamba"),
    LayerSpec(mixer="mamba", ffn="moe"),
    LayerSpec(mixer="attn"),
    LayerSpec(mixer="mamba", ffn="moe"),
    LayerSpec(mixer="mamba"),
    LayerSpec(mixer="mamba", ffn="moe"),
)


def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", d_model=8192, n_layers=72, n_heads=64,
        n_kv_heads=8, d_ff=24576, vocab=65536,
        pattern=_PATTERN, mlp_kind="swiglu",
        n_experts=16, topk=2, moe_d_ff=24576,
        mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
        attn_chunk=512, dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-smoke", d_model=64, n_layers=8, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=512,
        pattern=_PATTERN, mlp_kind="swiglu",
        n_experts=4, topk=2, moe_d_ff=128,
        mamba_d_state=4, mamba_d_conv=4, mamba_expand=2,
        attn_chunk=16, dtype="float32",
    )
