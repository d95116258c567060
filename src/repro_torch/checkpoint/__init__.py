"""Checkpointing: atomic, async, in the JAX package's format."""

from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
