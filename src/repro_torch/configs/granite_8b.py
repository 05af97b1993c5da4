"""granite-8b [dense]: 36L d=4096 32H (GQA kv=8) d_ff=14336 vocab=49152 —
llama-architecture (swiglu, RMSNorm, RoPE), code model. [arXiv:2405.04324]"""
from repro_torch.models.transformer import LayerSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-8b", d_model=4096, n_layers=36, n_heads=32,
        n_kv_heads=8, d_ff=14336, vocab=49152,
        pattern=(LayerSpec(),), mlp_kind="swiglu",
        rope_theta=10_000_000.0, attn_chunk=512, dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-8b-smoke", d_model=64, n_layers=2, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=512,
        pattern=(LayerSpec(),), mlp_kind="swiglu", attn_chunk=16,
        dtype="float32",
    )
