"""rwkv6-7b [ssm]: 32L d=4096 (attention-free) d_ff=14336 vocab=65536 —
Finch: data-dependent per-channel decay, RWKV channel-mix FFN.
[arXiv:2404.05892]

Deviation note (DESIGN.md): the decay LoRA is implemented as a full (d,d)
projection and decays are clamped to exp(-8)..exp(-1e-4) so the chunked
(matmul-parallel) prefill stays f32-stable."""
from repro_torch.models.transformer import LayerSpec, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", d_model=4096, n_layers=32, n_heads=64,
        n_kv_heads=64, d_ff=14336, vocab=65536,
        pattern=(LayerSpec(mixer="rwkv6", ffn="rwkv_cm"),),
        rwkv_head_dim=64, rwkv_chunk=128,
        dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b-smoke", d_model=64, n_layers=2, n_heads=8,
        n_kv_heads=8, d_ff=128, vocab=512,
        pattern=(LayerSpec(mixer="rwkv6", ffn="rwkv_cm"),),
        rwkv_head_dim=8, rwkv_chunk=8, dtype="float32",
    )
