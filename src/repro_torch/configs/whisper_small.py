"""whisper-small [audio]: 12L d=768 12H d_ff=3072 vocab=51865 —
encoder-decoder; conv frontend is a STUB (input_specs provides precomputed
frame embeddings (B, S_enc, 768)); decoder layers = self-attn + cross-attn +
gelu MLP, LayerNorm + biases, learned absolute positions.
[arXiv:2212.04356]"""
from repro_torch.models.transformer import EncoderConfig, LayerSpec, ModelConfig

# encoder memory length for serving shapes (whisper's 30 s window = 1500)
ENCODER_LEN = 1500


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", d_model=768, n_layers=12, n_heads=12,
        n_kv_heads=12, d_ff=3072, vocab=51865,
        pattern=(LayerSpec(cross=True),),
        mlp_kind="gelu", norm_kind="ln", use_bias=True,
        use_abs_pos=True, max_pos=32768,  # sized for the decode_32k cell
        encoder=EncoderConfig(n_layers=12, n_heads=12, d_ff=3072),
        attn_chunk=512, dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-smoke", d_model=64, n_layers=2, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=512,
        pattern=(LayerSpec(cross=True),),
        mlp_kind="gelu", norm_kind="ln", use_bias=True,
        use_abs_pos=True, max_pos=64,
        encoder=EncoderConfig(n_layers=2, n_heads=4, d_ff=128),
        attn_chunk=16, dtype="float32",
    )
