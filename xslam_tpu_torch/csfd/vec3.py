"""3-vector / 3x3-matrix helpers over CSFD dual numbers.

Port of ``xslam_tpu/csfd/vec3.py``. A "vec3" is a CSFD whose tensors have a
leading axis of length 3 (trailing axes keep image/volume layout); a "mat33"
is a CSFD of (3, 3[, ...]) tensors.
"""

from __future__ import annotations

import torch

from .single import CSFD, lift, sqrt, where


def vec3(x: CSFD, y: CSFD, z: CSFD) -> CSFD:
    x, y, z = lift(x), lift(y), lift(z)
    return CSFD(torch.stack([x.v, y.v, z.v]), torch.stack([x.g, y.g, z.g]))


def comp(v: CSFD, i: int) -> CSFD:
    return CSFD(v.v[i], v.g[i])


def dot(a: CSFD, b: CSFD) -> CSFD:
    # Internal.h:75-79
    return comp(a, 0) * comp(b, 0) + comp(a, 1) * comp(b, 1) + comp(a, 2) * comp(b, 2)


def cross(a: CSFD, b: CSFD) -> CSFD:
    # Internal.h:139-142
    ax, ay, az = (comp(a, i) for i in range(3))
    bx, by, bz = (comp(b, i) for i in range(3))
    return vec3(ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def norm(v: CSFD) -> CSFD:
    # Internal.h:124-127
    return sqrt(dot(v, v))


def squarednorm(v: CSFD) -> CSFD:
    return dot(v, v)


def normalized(v: CSFD) -> CSFD:
    n = norm(v)
    return CSFD(v.v / n.v, (v.g * n.v - v.v * n.g) / (n.v * n.v))


def matvec(m: CSFD, v: CSFD) -> CSFD:
    """(3,3[,...]) matrix times (3[,...]) vector, batched over trailing axes.

    Unrolled into elementwise products (Internal.h:150-154) in the reference's
    summation order, so the rounding matches ``xslam_tpu`` and no matmul
    precision setting can reach it."""

    def vrow(i):
        mv, mg = m.v, m.g
        val = mv[i, 0] * v.v[0] + mv[i, 1] * v.v[1] + mv[i, 2] * v.v[2]
        grd = (
            mg[i, 0] * v.v[0] + mg[i, 1] * v.v[1] + mg[i, 2] * v.v[2]
            + mv[i, 0] * v.g[0] + mv[i, 1] * v.g[1] + mv[i, 2] * v.g[2]
        )
        return val, grd

    rows = [vrow(i) for i in range(3)]
    return CSFD(torch.stack([r[0] for r in rows]), torch.stack([r[1] for r in rows]))


def where3(pred, a: CSFD, b: CSFD) -> CSFD:
    """Elementwise select with ``pred`` broadcast over the leading 3-axis."""
    return where(pred[None], a, b)
