"""Timing, trajectory evaluation, state conversion, checkpoints and debug
checks."""

from . import evaluation, timers
from .timers import Timer

__all__ = ["timers", "evaluation", "Timer"]
