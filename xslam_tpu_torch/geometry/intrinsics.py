"""Pinhole camera intrinsics with pyramid-level scaling.

Reference: struct ``Intr`` with per-level ``operator()(level)`` division by
``2^level`` (``XKinectFusion/include/Internal.h:49-59``).

Own copy of ``xslam_tpu/geometry/intrinsics.py``: the port imports nothing of
``xslam_tpu``, whose package imports load JAX.
"""

from __future__ import annotations

from typing import NamedTuple


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def level(self, i: int) -> "Intrinsics":
        div = 1 << i
        return Intrinsics(
            self.fx / div, self.fy / div, self.cx / div, self.cy / div,
            self.width >> i, self.height >> i,
        )


# canonical ICL-NUIM intrinsics (ICL_traj2.yaml:36-41); note negative fy.
ICL_INTRINSICS = Intrinsics(fx=481.20, fy=-480.00, cx=319.50, cy=239.50, width=640, height=480)

# 7-Scenes (Kinect) intrinsics per the dataset's standard calibration.
SEVEN_SCENES_INTRINSICS = Intrinsics(fx=585.0, fy=585.0, cx=320.0, cy=240.0, width=640, height=480)
