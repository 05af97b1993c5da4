"""repro_torch.configs — the paper's CP configuration as API presets."""
