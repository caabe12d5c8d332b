"""Run configuration and the synthetic dataset."""

from .config import SlamConfig, load_config
from .synthetic import SyntheticDataset

__all__ = ["SlamConfig", "load_config", "SyntheticDataset"]
