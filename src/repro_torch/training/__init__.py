"""repro_torch.training — checkpointing (the CP-ALS solver's and LM
training's), and LM training: ``train_step``, ``optimizer``, ``data`` and
``compression`` (imported on use)."""
from repro_torch.training.checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
