"""Gather primitives with the reference's out-of-bounds fill semantics.

Port of ``gather2d``/``gather3d`` from ``xslam_tpu/ops/sampling.py``.
"""

from __future__ import annotations

import torch

_INDEX_LIMIT = 1 << 30


def to_index(x: torch.Tensor) -> torch.Tensor:
    """Integer index of an already floored or rounded float tensor.

    NaN becomes -1 and magnitudes beyond 2^30 are clamped, so every such
    index lands out of bounds, as under XLA's saturating float-to-int convert;
    a plain cast of NaN or of an out-of-range float is undefined in C++."""
    x = torch.nan_to_num(x, nan=-1.0).clamp(-_INDEX_LIMIT, _INDEX_LIMIT)
    return x.to(torch.int64)


def gather2d(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor, fill=0.0) -> torch.Tensor:
    """``img[iy, ix]`` with out-of-bounds -> ``fill``. Any index shape."""
    H, W = img.shape
    ok = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
    flat = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
    vals = torch.take(img, flat)
    return torch.where(ok, vals, fill)


def gather3d(vol: torch.Tensor, ix, iy, iz, fill=0.0) -> torch.Tensor:
    """``vol[ix, iy, iz]`` from an (X, Y, Z) volume, out-of-bounds -> ``fill``."""
    X, Y, Z = vol.shape
    ok = (ix >= 0) & (ix < X) & (iy >= 0) & (iy < Y) & (iz >= 0) & (iz < Z)
    flat = (ix.clamp(0, X - 1) * Y + iy.clamp(0, Y - 1)) * Z + iz.clamp(0, Z - 1)
    vals = torch.take(vol, flat)
    return torch.where(ok, vals, fill)
