"""Deterministic synthetic data for the LM stack."""

from repro_torch.data.pipeline import DataConfig, data_iterator, synthetic_batch

__all__ = ["DataConfig", "data_iterator", "synthetic_batch"]
