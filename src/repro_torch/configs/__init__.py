"""repro_torch.configs — the paper's CP configuration as API presets
(:mod:`repro_torch.configs.amped_paper`) and the architecture registry:
``get_config(name, variant)``.

The registry is the port's copy of the reference package's
``configs/__init__.py``, and each architecture module a copy of the
reference's, field for field:
``variant="full"`` — the exact assigned configuration;
``variant="smoke"`` — reduced same-family config for CPU tests (small width,
few layers/experts, tiny vocab), exercising the identical block structure.
"""
from __future__ import annotations

import importlib

from repro_torch.models.transformer import ModelConfig

ARCH_IDS = [
    "gemma2_9b",
    "nemotron4_340b",
    "granite_8b",
    "gemma3_1b",
    "jamba15_large",
    "rwkv6_7b",
    "whisper_small",
    "deepseek_v2_lite",
    "phi35_moe",
    "llama32_vision_90b",
]

_ALIASES = {
    "gemma2-9b": "gemma2_9b",
    "nemotron-4-340b": "nemotron4_340b",
    "granite-8b": "granite_8b",
    "gemma3-1b": "gemma3_1b",
    "jamba-1.5-large-398b": "jamba15_large",
    "rwkv6-7b": "rwkv6_7b",
    "whisper-small": "whisper_small",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "llama-3.2-vision-90b": "llama32_vision_90b",
}


def get_config(name: str, variant: str = "full") -> ModelConfig:
    key = _ALIASES.get(name, name).replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return getattr(mod, variant)()


def all_configs(variant: str = "full") -> dict[str, ModelConfig]:
    return {a: get_config(a, variant) for a in ARCH_IDS}
