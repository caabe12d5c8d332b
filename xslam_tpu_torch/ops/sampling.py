"""Gather primitives with the reference's out-of-bounds fill semantics, and
the bilinear depth sample of fusion.

Port of ``gather2d``, ``gather3d`` and ``bilinear_depth_sample`` from
``xslam_tpu/ops/sampling.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..csfd.single import CSFD, lift

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


def bilinear_depth_sample(depth: torch.Tensor, image_x: CSFD, image_y: CSFD,
                          threshold: float) -> Tuple[CSFD, torch.Tensor]:
    """Depth lookup of TSDF fusion's bilinear branch (``TsdfFusion.cu:120-143``):
    bilinear interpolation in DUAL image coordinates (the derivative flows
    through the weights), gated by a discontinuity test: where the 2x2
    block's spread is not below ``threshold`` or a corner is 0, the nearest
    depth with no derivative. Returns (the sampled depth as a CSFD, the
    in-bounds mask): the block's corner ``(floor(x - 0.5), floor(y - 0.5))``
    must lie in [2, W-2) x [2, H-2). The threshold is compared in float32.
    Corner names are the JAX function's: ``d10`` is ``(cy, cx + 1)``. Each
    product is a dual product with the corner lifted to a constant, summed
    left to right, so kernel B11 (``csrc/fusion.cuh::bilinear_depth``)
    repeats it bit for bit on the card."""
    H, W = depth.shape
    cxf = torch.floor(image_x.v - 0.5)
    cyf = torch.floor(image_y.v - 0.5)
    cx, cy = to_index(cxf), to_index(cyf)
    in_bounds = (cx > 1) & (cy > 1) & (cx < W - 1) & (cy < H - 1)

    d00 = gather2d(depth, cy, cx)
    d10 = gather2d(depth, cy, cx + 1)
    d01 = gather2d(depth, cy + 1, cx)
    d11 = gather2d(depth, cy + 1, cx + 1)
    d_near = gather2d(depth, to_index(torch.round(image_y.v)), to_index(torch.round(image_x.v)))

    spread = torch.maximum(torch.maximum(d00, d01), torch.maximum(d10, d11)) - torch.minimum(
        torch.minimum(d00, d01), torch.minimum(d10, d11))
    all_valid = (d00 != 0.0) & (d01 != 0.0) & (d10 != 0.0) & (d11 != 0.0)
    use_interp = (spread < float(np.float32(threshold))) & all_valid

    a = image_x - (cx.to(torch.float32) + 0.5)
    b = image_y - (cy.to(torch.float32) + 0.5)
    one = lift(1.0)
    interp = (
        ((one - a) * (one - b)) * d00
        + (a * (one - b)) * d10
        + ((one - a) * b) * d01
        + (a * b) * d11
    )
    out = CSFD(torch.where(use_interp, interp.v, d_near), torch.where(use_interp, interp.g, 0.0))
    return out, in_bounds
