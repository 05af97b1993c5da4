"""phi3.5-moe-42b-a6.6b [moe]: 32L d=4096 32H (GQA kv=8) d_ff=6400(expert)
vocab=32064, 16 experts top-2. [hf:microsoft/Phi-3.5-MoE-instruct]"""
from repro_torch.models.transformer import LayerSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b", d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, d_ff=6400, vocab=32064,
        pattern=(LayerSpec(ffn="moe"),),
        mlp_kind="swiglu", n_experts=16, topk=2, moe_d_ff=6400,
        attn_chunk=512, dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-smoke", d_model=64, n_layers=2, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=512,
        pattern=(LayerSpec(ffn="moe"),),
        mlp_kind="swiglu", n_experts=4, topk=2, moe_d_ff=128,
        attn_chunk=16, dtype="float32",
    )
