"""Dual-number (CSFD) core over PyTorch tensors."""

from . import single, vec3
from .single import CSFD, lift

__all__ = ["single", "vec3", "CSFD", "lift"]
