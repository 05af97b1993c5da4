"""deepseek-v2-lite-16b [moe]: 27L d=2048 16H d_ff=1408(expert), MoE
64 routed + 2 shared, top-6; MLA kv_lora=512, qk_nope=128, qk_rope=64,
v_head=128, vocab=102400. [arXiv:2405.04434]

Assignment-line conflict ("64e top-6" vs "160 routed"): we follow the
published V2-Lite config — 64 routed + 2 shared — matching the "MoE 64e
top-6" clause (see DESIGN.md §6). All 27 layers are MoE (the real model's
single dense first layer is folded into the cyclic pattern; noted)."""
from repro_torch.models.transformer import LayerSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", d_model=2048, n_layers=27, n_heads=16,
        n_kv_heads=16, d_ff=1408, vocab=102400,
        pattern=(LayerSpec(mixer="mla", ffn="moe"),),
        mlp_kind="swiglu",
        n_experts=64, topk=6, moe_d_ff=1408, n_shared_experts=2,
        kv_lora=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        attn_chunk=512, dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke", d_model=64, n_layers=2, n_heads=4,
        n_kv_heads=4, d_ff=32, vocab=512,
        pattern=(LayerSpec(mixer="mla", ffn="moe"),),
        mlp_kind="swiglu",
        n_experts=8, topk=3, moe_d_ff=32, n_shared_experts=2,
        kv_lora=16, qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8,
        attn_chunk=16, dtype="float32",
    )
