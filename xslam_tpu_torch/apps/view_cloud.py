"""Offline point-cloud viewer: render a PLY to PNG.

Port of ``apps/view_cloud.py``. The reference's GL viewer is not
open-sourced or buildable (Visualization.h references unreleased
CMesh/Shader and <Windows.h>; SURVEY.md C3). This is the headless stand-in:
orthographic scatter renders of an exported cloud from three axes, normals
as colour ((n + 1) / 2, the reference's colour convention,
KinectFusionReconstruction.cpp:361-363). Needs matplotlib, imported when the
app runs; the port's other modules do not.

Usage: python -m xslam_tpu_torch.apps.view_cloud cloud.ply [out.png]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..io.ply import read_ply

MAX_POINTS = 200_000  # a larger cloud is drawn from a seeded sample of this many points


def main(argv=None) -> int:
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("view_cloud renders with matplotlib, which is not installed") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    argv = sys.argv[1:] if argv is None else list(argv)
    src = argv[0]
    dst = argv[1] if len(argv) > 1 else os.path.splitext(src)[0] + ".png"
    pts, nrm = read_ply(src)
    color = np.clip((nrm + 1.0) / 2.0, 0.0, 1.0)

    if len(pts) > MAX_POINTS:
        sel = np.random.default_rng(0).choice(len(pts), MAX_POINTS, replace=False)
        pts, color = pts[sel], color[sel]

    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    views = [("x", "y", 0, 1), ("x", "z", 0, 2), ("z", "y", 2, 1)]
    for ax, (xl, yl, i, j) in zip(axes, views):
        ax.scatter(pts[:, i], pts[:, j], s=0.3, c=color, linewidths=0)
        ax.set_xlabel(xl)
        ax.set_ylabel(yl)
        ax.set_aspect("equal")
        ax.invert_yaxis()
    fig.suptitle(f"{os.path.basename(src)} — {len(pts)} points")
    fig.tight_layout()
    fig.savefig(dst, dpi=130)
    plt.close(fig)
    print(f"wrote {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
