"""Checkpointing (``repro.ckpt``): atomic save/restore, keep-k retention,
an asynchronous writer."""

from repro_torch.ckpt.checkpoint import CheckpointManager, restore, save  # noqa: F401
