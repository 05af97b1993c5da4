"""gemma3-1b [dense]: 26L d=1152 4H (GQA kv=1 = MQA) d_ff=6912 vocab=262144,
5:1 local:global (window 512), 128k-ready rope. [hf:google/gemma-3-1b-pt]

26 layers is not a multiple of the 6-layer (5 local + 1 global) period; we
use a 13-layer pattern × 2 cycles — [5×local, global, 5×local, global,
local] — which keeps the 5:1 ratio at 22 local / 4 global exactly as the
checkpoint has (globals shift by ≤1 position; noted deviation)."""
from repro_torch.models.transformer import LayerSpec, ModelConfig

_L = LayerSpec(window=512)
_G = LayerSpec()
_PATTERN = (_L,) * 5 + (_G,) + (_L,) * 5 + (_G,) + (_L,)


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", d_model=1152, n_layers=26, n_heads=4,
        n_kv_heads=1, head_dim=256, d_ff=6912, vocab=262144,
        pattern=_PATTERN, mlp_kind="geglu",
        post_norm=True, norm_offset=1.0, emb_scale=True,
        rope_theta=1_000_000.0, attn_chunk=512, dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b-smoke", d_model=48, n_layers=13, n_heads=4,
        n_kv_heads=1, head_dim=12, d_ff=96, vocab=512,
        pattern=tuple(LayerSpec(window=8) if s.window else LayerSpec()
                      for s in _PATTERN),
        mlp_kind="geglu", post_norm=True, norm_offset=1.0, emb_scale=True,
        attn_chunk=16, dtype="float32",
    )
