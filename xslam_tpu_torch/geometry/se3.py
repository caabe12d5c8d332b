"""SE(3) utilities over first-order dual (CSFD) scalars.

Port of the first-order lane of ``xslam_tpu/geometry/se3.py``: pose matrices
are CSFDs of shape ``(4, 4[, ...])`` and all math goes through the dual
operator overloads, element by element, in the reference's order.
"""

from __future__ import annotations

import torch

from ..csfd import single as cs
from ..csfd.single import CSFD


def _stack(rows) -> CSFD:
    """Stack a list-of-lists of same-shaped dual scalars into a (R, C, ...) dual."""
    flat = [e for row in rows for e in row]
    n_r, n_c = len(rows), len(rows[0])
    shape = (n_r, n_c) + tuple(flat[0].v.shape)
    return CSFD(
        torch.stack([e.v for e in flat]).reshape(shape),
        torch.stack([e.g for e in flat]).reshape(shape),
    )


def elem(m: CSFD, i, j) -> CSFD:
    return CSFD(m.v[i, j], m.g[i, j])


def matmul(a: CSFD, b: CSFD) -> CSFD:
    """Dense dual matmul over small matrices (4x4 / 3x3), unrolled."""
    n, k, m = a.v.shape[0], b.v.shape[0], b.v.shape[1]
    rows = []
    for i in range(n):
        r = []
        for j in range(m):
            acc = elem(a, i, 0) * elem(b, 0, j)
            for l in range(1, k):
                acc = acc + elem(a, i, l) * elem(b, l, j)
            r.append(acc)
        rows.append(r)
    return _stack(rows)


def matvec(a: CSFD, x: CSFD) -> CSFD:
    n, k = a.v.shape[0], a.v.shape[1]
    out = []
    for i in range(n):
        acc = elem(a, i, 0) * CSFD(x.v[0], x.g[0])
        for l in range(1, k):
            acc = acc + elem(a, i, l) * CSFD(x.v[l], x.g[l])
        out.append([acc])
    m = _stack(out)
    return CSFD(m.v[:, 0], m.g[:, 0])


def euler_xyz_increment(alpha, beta, gamma, tx, ty, tz) -> CSFD:
    """Incremental transform ``Rinc = Rz(gamma) Ry(beta) Rx(alpha)`` plus
    translation, as applied per ICP iteration
    (KinectFusionReconstruction.cpp:212-224)."""
    one = cs.lift(torch.ones_like(alpha.v))
    zero = cs.lift(torch.zeros_like(one.v))
    ca, sa = cs.cos(alpha), cs.sin(alpha)
    cb, sb = cs.cos(beta), cs.sin(beta)
    cg, sg = cs.cos(gamma), cs.sin(gamma)
    Rx = _stack([[one, zero, zero], [zero, ca, -sa], [zero, sa, ca]])
    Ry = _stack([[cb, zero, sb], [zero, one, zero], [-sb, zero, cb]])
    Rz = _stack([[cg, -sg, zero], [sg, cg, zero], [zero, zero, one]])
    R = matmul(Rz, matmul(Ry, Rx))
    rows = [[elem(R, i, 0), elem(R, i, 1), elem(R, i, 2), [tx, ty, tz][i]] for i in range(3)]
    rows.append([zero, zero, zero, one])
    return _stack(rows)


def inverse(T: CSFD) -> CSFD:
    """Inverse of a dual SE(3) matrix: ``[R^T, -R^T t]``."""
    rows = []
    for i in range(3):
        r = [elem(T, j, i) for j in range(3)]
        ti = -(r[0] * elem(T, 0, 3) + r[1] * elem(T, 1, 3) + r[2] * elem(T, 2, 3))
        rows.append(r + [ti])
    e = elem(T, 0, 0)
    one = CSFD(torch.ones_like(e.v), torch.ones_like(e.g))
    zero = CSFD(torch.zeros_like(e.v), torch.zeros_like(e.g))
    rows.append([zero, zero, zero, one])
    return _stack(rows)


def rotation(T: CSFD) -> CSFD:
    return CSFD(T.v[:3, :3], T.g[:3, :3])


def translation(T: CSFD) -> CSFD:
    return CSFD(T.v[:3, 3], T.g[:3, 3])
