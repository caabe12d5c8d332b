"""ASCII PLY point-cloud and mesh export, and point-cloud import.

Port of ``xslam_tpu/io/ply.py`` (its numpy writer; the JAX package's native
writer is not ported): format-compatible with the reference's
``CPointCloud::exportPly/readPly`` (``Visualization/src/CPointCloud.cpp:16-67``),
11 header lines, properties ``x y z nx ny nz``. A file written by either
package reads back in the other.
"""

from __future__ import annotations

import numpy as np

_HEADER = (
    "ply\n"
    "format ascii 1.0\n"
    "comment Created by xslam_tpu\n"
    "element vertex {n}\n"
    "property float x\n"
    "property float y\n"
    "property float z\n"
    "property float nx\n"
    "property float ny\n"
    "property float nz\n"
    "end_header\n"
)


def export_ply(path: str, points: np.ndarray, normals: np.ndarray) -> None:
    points = np.asarray(points, np.float32).reshape(-1, 3)
    normals = np.asarray(normals, np.float32).reshape(-1, 3)
    if points.shape != normals.shape:
        raise ValueError(f"points {points.shape} and normals {normals.shape} differ in shape")
    with open(path, "w") as f:
        f.write(_HEADER.format(n=len(points)))
        np.savetxt(f, np.hstack([points, normals]), fmt="%.6g")


def export_ply_mesh(path: str, triangles: np.ndarray) -> None:
    """ASCII PLY with faces from a (T, 3, 3) triangle soup (vertices are
    written per-triangle; viewers weld duplicates)."""
    tris = np.asarray(triangles, np.float32).reshape(-1, 3, 3)
    n_v = 3 * len(tris)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\ncomment Created by xslam_tpu\n"
            f"element vertex {n_v}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(tris)}\n"
            "property list uchar int vertex_indices\n"
            "end_header\n"
        )
        np.savetxt(f, tris.reshape(-1, 3), fmt="%.6g")
        idx = np.arange(n_v).reshape(-1, 3)
        faces = np.hstack([np.full((len(tris), 1), 3), idx])
        np.savetxt(f, faces, fmt="%d")


def read_ply(path: str):
    with open(path) as f:
        n = 0
        for line in f:
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line.strip() == "end_header":
                break
        data = np.loadtxt(f, dtype=np.float32, max_rows=n)
    data = data.reshape(-1, 6)
    return data[:, :3], data[:, 3:]
