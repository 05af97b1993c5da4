"""repro_torch.training — checkpointing for the port's CP-ALS solver."""
from repro_torch.training.checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
