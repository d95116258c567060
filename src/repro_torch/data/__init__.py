"""Deterministic synthetic data for the LM stack."""

from repro_torch.data.pipeline import DataConfig, synthetic_batch

__all__ = ["DataConfig", "synthetic_batch"]
