"""SE(3) utilities over dual (CSFD) and hyper-dual (DCSFD) scalars.

Port of ``xslam_tpu/geometry/se3.py``: pose matrices are duals of shape
``(4, 4[, ...])`` of either scalar module (:mod:`..csfd.single`,
:mod:`..csfd.double`; ``mod=`` picks one where nothing else says which) and
all math goes through the dual operator overloads, element by element, in
the reference's order. Trailing axes batch: a pose of shape ``(4, 4, P)``
is P poses, each computed with the same operations.

Real-valued helpers (``exp_real``, ``log_real``, ``inverse_real``) handle
ground-truth poses; ``log_real`` runs on the host (numpy and scipy).
"""

from __future__ import annotations

import numpy as np
import torch

from ..csfd import double as dc
from ..csfd import single as cs
from ..csfd.single import CSFD


def _lanes(x, f):
    """Apply ``f`` to every lane of a dual, keeping its type."""
    return type(x)(*(f(a) for a in x))


def _stack(rows):
    """Stack a list-of-lists of same-shaped dual scalars into a (R, C, ...) dual."""
    flat = [e for row in rows for e in row]
    n_r, n_c = len(rows), len(rows[0])
    shape = (n_r, n_c) + tuple(flat[0].v.shape)
    return type(flat[0])(*(torch.stack(list(lane)).reshape(shape) for lane in zip(*flat)))


def elem(m, i, j):
    return _lanes(m, lambda a: a[i, j])


def row(m, i):
    return _lanes(m, lambda a: a[i])


def matmul(a, b):
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


def matvec(a, x):
    n, k = a.v.shape[0], a.v.shape[1]
    out = []
    for i in range(n):
        acc = elem(a, i, 0) * row(x, 0)
        for l in range(1, k):
            acc = acc + elem(a, i, l) * row(x, l)
        out.append([acc])
    return _lanes(_stack(out), lambda t: t[:, 0])


def _mod_for(x):
    return dc if isinstance(x, dc.DCSFD) else cs


def identity(mod=cs, batch=(), device=None):
    one = mod.lift(torch.ones(batch, dtype=torch.float32, device=device))
    zero = mod.lift(torch.zeros(batch, dtype=torch.float32, device=device))
    return _stack(
        [
            [one, zero, zero, zero],
            [zero, one, zero, zero],
            [zero, zero, one, zero],
            [zero, zero, zero, one],
        ]
    )


def from_real(mat, mod=cs):
    """Lift a real (4,4) or (3,3) matrix (tensor or array) to a constant dual matrix."""
    return mod.lift(torch.as_tensor(np.asarray(mat, np.float32) if not isinstance(mat, torch.Tensor) else mat,
                                    dtype=torch.float32))


def exp(xi, mod=None):
    """SE(3) exponential of a 6-dual-vector ``xi = (v, omega)``.

    Mirrors ``KinectFusionReconstruction::se3Exp``
    (KinectFusionReconstruction.h:176-219): Rodrigues with
    ``A = sin(t)/t, B = (1-cos t)/t^2, C = (t - sin t)/t^3``, with a series
    fallback for small angles (branchless: ``where`` on the value lane, the
    derivative lanes selected with it; ``sqrt`` of 1 there, so no lane sees
    ``sqrt(0)``)."""
    if mod is None:
        mod = _mod_for(xi)
    v = [row(xi, 0), row(xi, 1), row(xi, 2)]
    w = [row(xi, 3), row(xi, 4), row(xi, 5)]

    zero = _lanes(v[0], torch.zeros_like)
    theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    small = theta2.v < 1e-12
    theta = mod.sqrt(mod.where(small, mod.lift(1.0), theta2))
    s, c = mod.sin(theta), mod.cos(theta)
    A = mod.where(small, mod.lift(1.0) - theta2 / 6.0, s / theta)
    B = mod.where(small, mod.lift(0.5) - theta2 / 24.0, (mod.lift(1.0) - c) / theta2)
    C = mod.where(small, mod.lift(1.0 / 6.0) - theta2 / 120.0, (theta - s) / (theta2 * theta))

    wx, wy, wz = w
    what = _stack([[zero, -wz, wy], [wz, zero, -wx], [-wy, wx, zero]])
    what2 = matmul(what, what)

    one_s = mod.lift(torch.ones_like(zero.v))
    eye3 = _stack([[one_s, zero, zero], [zero, one_s, zero], [zero, zero, one_s]])
    R = _mat_add(eye3, _mat_scale(what, A), _mat_scale(what2, B))
    V = _mat_add(eye3, _mat_scale(what, B), _mat_scale(what2, C))
    t = _matvec_scalars(V, v)

    rows = [[elem(R, i, 0), elem(R, i, 1), elem(R, i, 2), t[i]] for i in range(3)]
    one = mod.lift(torch.ones_like(zero.v))
    zr = mod.lift(torch.zeros_like(one.v))
    rows.append([zr, zr, zr, one])
    return _stack(rows)


def _matvec_scalars(M, xs):
    """Multiply a dual matrix by a list of dual scalars; returns a list."""
    out = []
    for i in range(M.v.shape[0]):
        acc = elem(M, i, 0) * xs[0]
        for l in range(1, len(xs)):
            acc = acc + elem(M, i, l) * xs[l]
        out.append(acc)
    return out


def _mat_scale(m, s):
    """Scale a dual matrix by a dual scalar (broadcast over (R,C))."""
    n, k = m.v.shape[0], m.v.shape[1]
    return _stack([[elem(m, i, j) * s for j in range(k)] for i in range(n)])


def _mat_add(*ms):
    out = ms[0]
    for m in ms[1:]:
        out = type(out)(*(a + b for a, b in zip(out, m)))
    return out


def euler_xyz_increment(alpha, beta, gamma, tx, ty, tz, mod=cs):
    """Incremental transform ``Rinc = Rz(gamma) Ry(beta) Rx(alpha)`` plus
    translation, as applied per ICP iteration
    (KinectFusionReconstruction.cpp:212-224)."""
    one = mod.lift(torch.ones_like(alpha.v))
    zero = mod.lift(torch.zeros_like(one.v))
    ca, sa = mod.cos(alpha), mod.sin(alpha)
    cb, sb = mod.cos(beta), mod.sin(beta)
    cg, sg = mod.cos(gamma), mod.sin(gamma)
    Rx = _stack([[one, zero, zero], [zero, ca, -sa], [zero, sa, ca]])
    Ry = _stack([[cb, zero, sb], [zero, one, zero], [-sb, zero, cb]])
    Rz = _stack([[cg, -sg, zero], [sg, cg, zero], [zero, zero, one]])
    R = matmul(Rz, matmul(Ry, Rx))
    rows = [[elem(R, i, 0), elem(R, i, 1), elem(R, i, 2), [tx, ty, tz][i]] for i in range(3)]
    rows.append([zero, zero, zero, one])
    return _stack(rows)


def inverse(T):
    """Inverse of a dual SE(3) matrix: ``[R^T, -R^T t]``. As in the JAX
    package, the homogeneous corner has every lane 1 (``1 + 1ε`` for a
    CSFD), not ``1 + 0ε``: its derivative lane reads 1 there, so a ``matmul``
    whose right operand is an inverse adds the left operand's translation
    value to the product's translation derivative (no value changes)."""
    rows = []
    for i in range(3):
        r = [elem(T, j, i) for j in range(3)]
        ti = -(r[0] * elem(T, 0, 3) + r[1] * elem(T, 1, 3) + r[2] * elem(T, 2, 3))
        rows.append(r + [ti])
    e = elem(T, 0, 0)
    rows.append([_lanes(e, torch.zeros_like)] * 3 + [_lanes(e, torch.ones_like)])
    return _stack(rows)


def rotation(T):
    return _lanes(T, lambda a: a[:3, :3])


def translation(T):
    return _lanes(T, lambda a: a[:3, 3])


def compose(a, b):
    return matmul(a, b)


def from_rotation_translation(r: CSFD, t: CSFD) -> CSFD:
    """The (4, 4) dual pose ``[R t; 0 0 0 1]``, assembled by slices."""
    def lane(rot, trans, corner):
        m = rot.new_zeros((4, 4))
        m[:3, :3] = rot
        m[:3, 3] = trans
        m[3, 3] = corner
        return m

    return CSFD(lane(r.v, t.v, 1.0), lane(r.g, t.g, 0.0))


# ----------------------------------------------------------------- real-only
def exp_real(xi) -> torch.Tensor:
    """Real-valued SE(3) exp for ground-truth pose handling."""
    if not isinstance(xi, torch.Tensor):
        xi = np.asarray(xi, np.float32)
    return exp(cs.lift(torch.as_tensor(xi, dtype=torch.float32))).v


def log_real(T) -> np.ndarray:
    """SE(3) log (inverse of :func:`exp`): T -> xi = (v, omega), numpy."""
    from scipy.spatial.transform import Rotation

    if isinstance(T, torch.Tensor):
        T = T.detach().cpu().numpy()
    T = np.asarray(T, np.float64)
    R = T[:3, :3]
    w = Rotation.from_matrix(R).as_rotvec()  # robust incl. theta ~ pi
    th = np.linalg.norm(w)
    if th < 1e-8:
        Vinv = np.eye(3)
    else:
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        A = np.sin(th) / th
        B = (1 - np.cos(th)) / th**2
        Vinv = np.eye(3) - 0.5 * K + (1 / th**2) * (1 - A / (2 * B)) * (K @ K)
    v = Vinv @ T[:3, 3]
    return np.concatenate([v, w]).astype(np.float32)


def inverse_real(T: torch.Tensor) -> torch.Tensor:
    """``[R^T, -R^T t]`` of a real (4, 4) pose; ``-R^T t`` is a matrix
    product, as in the JAX package."""
    R = T[:3, :3]
    t = T[:3, 3]
    out = torch.eye(4, dtype=T.dtype, device=T.device)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t
    return out
