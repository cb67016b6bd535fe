"""The synthetic data pipeline of the port (``repro.data``'s counterpart)."""
from .pipeline import DataConfig, Prefetcher, SyntheticLM, make_pipeline

__all__ = ["DataConfig", "SyntheticLM", "Prefetcher", "make_pipeline"]
