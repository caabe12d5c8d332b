"""Run configuration, the datasets (synthetic and on disk), PNG and PLY files."""

from .config import SlamConfig, load_config
from .dataset import ICLDataset, SevenScenesDataset, make_dataset
from .synthetic import SyntheticDataset

__all__ = ["SlamConfig", "load_config", "ICLDataset", "SevenScenesDataset", "SyntheticDataset", "make_dataset"]
