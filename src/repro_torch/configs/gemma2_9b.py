"""gemma2-9b [dense]: 42L d=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.
Local(4096-window)+global alternating, attn softcap 50 / final logit softcap
30, sandwich norms, (1+w) RMSNorm, sqrt(d) embedding scale.
[arXiv:2408.00118; hf]"""
from repro_torch.models.transformer import LayerSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b", d_model=3584, n_layers=42, n_heads=16,
        n_kv_heads=8, head_dim=256, d_ff=14336, vocab=256000,
        pattern=(LayerSpec(window=4096, attn_softcap=50.0),
                 LayerSpec(attn_softcap=50.0)),
        mlp_kind="geglu", post_norm=True, norm_offset=1.0, emb_scale=True,
        final_softcap=30.0, attn_chunk=512, dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b-smoke", d_model=64, n_layers=4, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
        pattern=(LayerSpec(window=8, attn_softcap=50.0),
                 LayerSpec(attn_softcap=50.0)),
        mlp_kind="geglu", post_norm=True, norm_offset=1.0, emb_scale=True,
        final_softcap=30.0, attn_chunk=16, dtype="float32",
    )
