"""Camera and pose geometry over dual numbers."""

from . import se3
from .intrinsics import ICL_INTRINSICS, SEVEN_SCENES_INTRINSICS, Intrinsics

__all__ = ["se3", "Intrinsics", "ICL_INTRINSICS", "SEVEN_SCENES_INTRINSICS"]
