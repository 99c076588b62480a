"""The synthetic LM data pipeline (``pipeline``), copied from
``repro.data``."""
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM

__all__ = ["DataConfig", "Prefetcher", "SyntheticLM"]
