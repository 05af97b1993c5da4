"""nemotron-4-340b [dense]: 96L d=18432 96H (GQA kv=8) d_ff=73728
vocab=256000 — squared-ReLU MLP (no GLU). [arXiv:2402.16819]"""
from repro_torch.models.transformer import LayerSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b", d_model=18432, n_layers=96, n_heads=96,
        n_kv_heads=8, d_ff=73728, vocab=256000,
        pattern=(LayerSpec(),), mlp_kind="squared_relu",
        attn_chunk=512, dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b-smoke", d_model=96, n_layers=2, n_heads=6,
        n_kv_heads=2, d_ff=256, vocab=512,
        pattern=(LayerSpec(),), mlp_kind="squared_relu",
        attn_chunk=16, dtype="float32",
    )
