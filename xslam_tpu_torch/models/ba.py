"""Keyframe pose-graph refinement and Schur-complement bundle adjustment.

Port of ``xslam_tpu/models/ba.py``. The reference (X-SLAM) has no backend:
it tracks frame to model and keeps a pose history. Keyframes and map anchor
points are optimized jointly; the anchor blocks are eliminated by Schur
complement, their 3x3 inverses independent of one another.

* :func:`pose_graph_gn`: relative-pose factors between keyframes (odometry
  and loop closures), Gauss-Newton on the dense 6K system.
* :func:`pose_graph_cg`: the same factors, matrix-free preconditioned CG on
  the normal equations, O(K + E) memory.
* :func:`schur_ba`: depth-reprojection factors between keyframes and 3-D
  anchors, Schur-complement reduction to the camera system solved densely
  (``Hcc (K, K, 6, 6)``, ``Hcl (K, L, 6, 3)``): the oracle for small
  problems.
* :func:`schur_ba_cg`: matrix-free CG on the reduced camera system,
  O(N + K + L) memory, for real keyframe counts.

The Jacobians are forward-mode dual numbers, as the JAX package's
``jax.jacfwd``: ``se3.exp`` of each keyframe's ``xi`` with one derivative
direction seeded per column, batched on a trailing axis, once a keyframe;
the residuals' chain rule is applied to those six lanes (for an observation,
``R^T (p - t) - meas`` is linear in the lanes of ``R`` and ``t``). The same
function as ``jacfwd``'s, with other rounding.

Nothing inside a Gauss-Newton or CG loop reads a value back to the host:
JAX's ``lax.scan`` is a Python loop whose tensors stay on the device, CG's
step sizes are ``torch.where``, the small inverses and solves are
``inv_ex``/``solve_ex``. The sums over edges and observations by keyframe or
anchor (JAX's ``.at[].add``) are in an order fixed by the problem
(:class:`_Segments`): two calls on the same inputs give the same bits on the
card, where ``index_add_`` would add with atomics in no fixed order.

The sharded forms (``axis_name``, observations split over devices with the
blocks summed across them) are not ported: ``axis_name`` must be ``None``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..csfd import single as cs
from ..geometry import se3

# rows of a block of the prefix sums (_prefix): the scan's rows are short and many
_BLOCK = 256


def _exp(xi) -> torch.Tensor:
    """Real (4, 4) SE(3) exponential of a (6,) ``xi`` (value lane of ``se3.exp``)."""
    return se3.exp_real(xi)


def _exp_lanes(xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(T, dT)`` of (K, 6) poses: ``T`` (K, 4, 4) their exponentials,
    ``dT`` (K, 6, 4, 4) the derivative along each component of ``xi``: one
    ``se3.exp`` of duals whose derivative lanes are the six unit directions
    (a trailing axis of 6)."""
    K = xi.shape[0]
    eye = torch.eye(6, dtype=torch.float32, device=xi.device)
    v = xi.to(torch.float32).T[:, :, None].expand(6, K, 6)
    T = se3.exp(cs.CSFD(v, eye[:, None, :].expand(6, K, 6)), mod=cs)
    return T.v[..., 0].permute(2, 0, 1), T.g.permute(2, 3, 0, 1)


def _inv_rt(T: torch.Tensor, dT: Optional[torch.Tensor] = None):
    """``[R^T, -R^T t; 0 0 0 1]`` of (..., 4, 4) poses, and with ``dT``
    (..., D, 4, 4) derivative lanes its derivative lanes (corner 0)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = T[..., :3, 3:]
    out = torch.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt @ t)[..., 0]
    out[..., 3, 3] = 1.0
    if dT is None:
        return out
    dRt = dT[..., :3, :3].transpose(-1, -2)
    d_out = torch.zeros_like(dT)
    d_out[..., :3, :3] = dRt
    d_out[..., :3, 3] = -((dRt @ t[..., None, :, :]) + (Rt[..., None, :, :] @ dT[..., :3, 3:]))[..., 0]
    return out, d_out


def _vee(E: torch.Tensor) -> torch.Tensor:
    """(..., 6) residual of a (..., 4, 4) error: translation, then the
    skew part of the rotation."""
    rot = torch.stack([E[..., 2, 1] - E[..., 1, 2], E[..., 0, 2] - E[..., 2, 0], E[..., 1, 0] - E[..., 0, 1]], -1) * 0.5
    return torch.cat([E[..., :3, 3], rot], -1)


def _rel_residual(xi_i, xi_j, T_meas_inv) -> torch.Tensor:
    """r = vee-approx of T_meas^-1 (T_i^-1 T_j) for small errors (6,)."""
    E = torch.as_tensor(T_meas_inv, dtype=torch.float32) @ (_inv_rt(_exp(xi_i)) @ _exp(xi_j))
    return _vee(E)


def _rel_terms(poses: torch.Tensor, ei: torch.Tensor, ej: torch.Tensor, rel_inv: torch.Tensor):
    """Each edge's residual (E, 6) and Jacobians ``Ji``, ``Jj`` (E, 6, 6)
    (``J[e, r, c]``: residual row r, pose component c) of
    :func:`_rel_residual`."""
    T, dT = _exp_lanes(poses)
    Ti, dTi = T[ei], dT[ei]
    Tj, dTj = T[ej], dT[ej]
    Ti_inv, dTi_inv = _inv_rt(Ti, dTi)
    r = _vee(rel_inv @ (Ti_inv @ Tj))
    m = rel_inv[:, None]
    Ji = _vee(m @ (dTi_inv @ Tj[:, None])).transpose(1, 2)
    Jj = _vee(m @ (Ti_inv[:, None] @ dTj)).transpose(1, 2)
    return r, Ji, Jj


# ---------------------------------------------------------------------------
def _prefix(x: torch.Tensor) -> torch.Tensor:
    """(M, C) float64 rows -> (M + 1, C) inclusive prefix sums after a zero
    row, in a fixed order: within blocks of ``_BLOCK`` rows, then over the
    blocks' totals (two short scans along the last axis of a contiguous
    tensor: no atomics, no order that depends on timing)."""
    M, C = x.shape
    nb = -(-M // _BLOCK)
    pad = x.new_zeros((nb * _BLOCK - M, C))
    blocks = torch.cat([x, pad]).reshape(nb, _BLOCK, C).permute(2, 0, 1).contiguous()
    inner = torch.cumsum(blocks, dim=2)
    totals = torch.cumsum(inner[:, :, -1], dim=1)
    offsets = torch.cat([x.new_zeros((C, 1)), totals[:, :-1]], dim=1)
    rows = (inner + offsets[:, :, None]).permute(1, 2, 0).reshape(nb * _BLOCK, C)[:M]
    return torch.cat([x.new_zeros((1, C)), rows])


class _Segments:
    """Sums of rows by key (JAX's ``zeros((n, ...)).at[keys].add(rows)``) in
    an order fixed by the keys alone: the rows sorted by key once (a stable
    sort), prefix sums in float64 (:func:`_prefix`), and each segment's sum
    the difference of the prefix at its ends, rounded to float32. Keys
    outside ``[0, n)`` add nothing, as JAX drops them. No host read."""

    def __init__(self, keys: torch.Tensor, n: int):
        self.n = n
        self.order = torch.argsort(keys, stable=True)
        sorted_keys = keys[self.order].contiguous()
        seg = torch.arange(n, dtype=sorted_keys.dtype, device=keys.device)
        self.start = torch.searchsorted(sorted_keys, seg)
        self.end = torch.searchsorted(sorted_keys, seg, right=True)

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        shape = rows.shape[1:]
        prefix = _prefix(rows[self.order].reshape(rows.shape[0], -1).to(torch.float64))
        return (prefix[self.end] - prefix[self.start]).to(torch.float32).reshape((self.n,) + shape)


def _outer(J: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """``einsum("nri,nrj->nij", J, K)`` as a product and a sum (float32)."""
    return (J[..., :, None] * K[..., None, :]).sum(-3)


def _jT(J: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``einsum("nri,nr->ni", J, u)``."""
    return (J * u[..., None]).sum(-2)


def _j(J: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``einsum("nri,ni->nr", J, x)``."""
    return (J * x[..., None, :]).sum(-1)


def _block_solve(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``einsum("kij,kj->ki", M, v)``."""
    return (M * v[..., None, :]).sum(-1)


def _gauge(K: int, device) -> torch.Tensor:
    """(K, 6) mask: keyframe 0 fixed, the others free."""
    g = torch.ones((K, 6), dtype=torch.float32, device=device)
    g[0] = 0.0
    return g


def _no_axis(axis_name):
    if axis_name is not None:
        raise NotImplementedError("observation-sharded BA (axis_name) is not ported")


def _pcg(matvec, precond, b: torch.Tensor, cg_iters: int) -> torch.Tensor:
    """Fixed-trip-count preconditioned CG from 0 (JAX's scan of
    ``cg_step``): ``alpha`` and ``beta`` by ``torch.where``, no host read."""
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(cg_iters):
        sp = matvec(p)
        psp = torch.sum(p * sp)
        alpha = torch.where(psp > 0.0, rz / torch.clamp(psp, min=1e-30), 0.0)
        x = x + alpha * p
        r = r - alpha * sp
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(rz > 0.0, rz_new / torch.clamp(rz, min=1e-30), 0.0)
        p = z + beta * p
        rz = rz_new
    return x


# ---------------------------------------------------------------------------
class PoseGraphResult(NamedTuple):
    poses: torch.Tensor  # (K, 6)
    residual_history: torch.Tensor


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _edges(edges, device) -> Tuple[torch.Tensor, torch.Tensor]:
    e = torch.as_tensor(edges, device=device).to(torch.int64)
    return e[:, 0], e[:, 1]


def pose_graph_gn(
    poses_init: torch.Tensor,
    edges: torch.Tensor,
    rel_meas: torch.Tensor,
    iters: int = 10,
    damping: float = 1e-6,
) -> PoseGraphResult:
    """Gauss-Newton over relative-pose factors; keyframe 0 is gauge-fixed.

    poses_init: (K, 6) se(3); edges: (E, 2) int32 (i, j); rel_meas: (E, 4, 4)
    measured T_i^-1 T_j. The dense Jacobian (6E, 6K) is laid out from the
    edges' blocks by one-hot products (no scatter)."""
    poses = _f32(poses_init)
    dev = poses.device
    K = poses.shape[0]
    ei, ej = _edges(edges, dev)
    E = ei.shape[0]
    rel_inv = torch.linalg.inv_ex(_f32(rel_meas, dev))[0]
    keys = torch.arange(K, device=dev)
    hot_i = (ei[:, None] == keys).to(torch.float32)[:, None, :, None]
    hot_j = (ej[:, None] == keys).to(torch.float32)[:, None, :, None]
    eye = torch.eye(6 * K, dtype=torch.float32, device=dev)
    free = torch.ones(6 * K, dtype=torch.float32, device=dev)
    free[:6] = 0.0
    hist = []
    for _ in range(iters):
        r, Ji, Jj = _rel_terms(poses, ei, ej, rel_inv)
        r = r.reshape(-1)
        # gauge fix: zero out keyframe 0's columns
        J = (Ji[:, :, None, :] * hot_i + Jj[:, :, None, :] * hot_j).reshape(6 * E, 6 * K) * free
        H = J.T @ J + damping * eye
        g = J.T @ r
        delta = -torch.linalg.solve_ex(H, g)[0] * free
        poses = (poses.reshape(-1) + delta).reshape(K, 6)
        hist.append(torch.sum(r * r))
    return PoseGraphResult(poses=poses, residual_history=_history(hist, dev))


def _history(hist, device) -> torch.Tensor:
    return torch.stack(hist) if hist else torch.zeros(0, dtype=torch.float32, device=device)


def pose_graph_cg(
    poses_init: torch.Tensor,
    edges: torch.Tensor,
    rel_meas: torch.Tensor,
    iters: int = 10,
    damping: float = 1e-6,
    cg_iters: int = 50,
) -> PoseGraphResult:
    """Scalable pose-graph Gauss-Newton: edge-wise Jacobians + matrix-free
    preconditioned CG on the normal equations — O(K + E) memory.

    Only the per-edge 6x6 Jacobian blocks ``(Ji, Jj)`` are kept, and
    ``H @ x`` is two segment sums over the edges (:class:`_Segments`).
    Keyframe 0 is gauge-fixed; Jacobi 6x6 block preconditioner. The
    production path of ``RecoveringEngine.refine_keyframes``."""
    poses = _f32(poses_init)
    dev = poses.device
    K = poses.shape[0]
    ei, ej = _edges(edges, dev)
    rel_inv = torch.linalg.inv_ex(_f32(rel_meas, dev))[0]
    gauge = _gauge(K, dev)
    seg = _Segments(torch.cat([ei, ej]), K)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def scat(contrib_i, contrib_j):  # (E, ...) x2 -> (K, ...)
        return seg(torch.cat([contrib_i, contrib_j]))

    hist = []
    for _ in range(iters):
        rs, Jis, Jjs = _rel_terms(poses, ei, ej, rel_inv)
        g = scat(_jT(Jis, rs), _jT(Jjs, rs)) * gauge
        # Jacobi block preconditioner from the H block diagonal
        Hd = scat(_outer(Jis, Jis), _outer(Jjs, Jjs))
        M_inv = torch.linalg.inv_ex(Hd + (damping + 1e-8) * eye6)[0]

        def matvec(x):
            x = x * gauge
            u = _j(Jis, x[ei]) + _j(Jjs, x[ej])
            return (scat(_jT(Jis, u), _jT(Jjs, u)) + damping * x) * gauge

        def precond(r):
            return _block_solve(M_inv, r) * gauge

        dx = _pcg(matvec, precond, -g, cg_iters)
        poses = poses + dx * gauge
        hist.append(torch.sum(rs * rs))
    return PoseGraphResult(poses=poses, residual_history=_history(hist, dev))


# ---------------------------------------------------------------------------
def build_ba_problem(
    kf_c2w,
    kf_depths_u16,
    intr,
    stride: int = 8,
    match_dist: float = 0.15,
    min_obs: int = 2,
    z_range: Tuple[float, float] = (0.2, 5.0),
    device=None,
):
    """Derive a depth-reprojection :class:`BAProblem` from LIVE keyframe
    sensor data — the bridge between the SLAM front end and the backend.

    Anchors: every ``stride``-th valid depth pixel of every keyframe,
    back-projected to world at the keyframe's (estimated) pose. Observations:
    keyframe ``j`` observes anchor ``a`` if the anchor projects inside
    ``j``'s image onto a valid depth pixel whose back-projection lies within
    ``match_dist`` of the anchor in camera space (projective data
    association, ICP.cu:196-244, applied keyframe to keyframe). Only anchors
    seen from >= ``min_obs`` keyframes survive.

    Host-side numpy, the JAX package's own code; the problem's tensors are
    made on ``device`` (the CPU by default). Returns ``(problem,
    anchors_init)``, anchors a float32 numpy array, or ``(None, None)`` if no
    multi-view anchors exist.
    """
    K = len(kf_c2w)
    fx, fy, cx, cy = intr.fx, intr.fy, intr.cx, intr.cy
    H, W = np.asarray(kf_depths_u16[0]).shape

    def backproject(depth_m, us, vs):
        z = depth_m[vs, us]
        return np.stack(
            [z * (us - cx) / fx, z * (vs - cy) / fy, z], axis=-1
        )

    depths_m = []
    for d in kf_depths_u16:
        d = np.asarray(d, np.float32)
        m = d / 1000.0
        m[(m < z_range[0]) | (m > z_range[1])] = 0.0
        depths_m.append(m)

    # camera-space vertex + normal maps (numpy twin of preprocess.create_vmap/
    # create_nmap) — normals feed the point-to-plane residuals
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    normal_maps = []
    for m in depths_m:
        vm = np.stack([m * (uu - cx) / fx, m * (vv - cy) / fy, m], axis=-1)
        vm[m == 0] = np.nan
        a = np.full_like(vm, np.nan)
        b = np.full_like(vm, np.nan)
        a[:, :-1] = vm[:, 1:] - vm[:, :-1]  # right neighbour
        b[:-1, :] = vm[1:, :] - vm[:-1, :]  # down neighbour
        n = np.cross(a, b)
        norm = np.linalg.norm(n, axis=-1, keepdims=True)
        with np.errstate(invalid="ignore"):
            n = n / norm
        normal_maps.append(n)

    # candidate anchors from each keyframe's subsampled vertex map
    anchors_world = []
    anchor_src = []  # keyframe that spawned the anchor
    vs_g, us_g = np.mgrid[stride // 2:H:stride, stride // 2:W:stride]
    us_g, vs_g = us_g.ravel(), vs_g.ravel()
    for k in range(K):
        z = depths_m[k][vs_g, us_g]
        ok = z > 0
        pc = backproject(depths_m[k], us_g[ok], vs_g[ok])  # (n, 3) cam
        T = np.asarray(kf_c2w[k], np.float64)
        pw = pc @ T[:3, :3].T + T[:3, 3]
        anchors_world.append(pw)
        anchor_src.append(np.full(pw.shape[0], k))
    anchors_world = np.concatenate(anchors_world, axis=0)
    anchor_src = np.concatenate(anchor_src, axis=0)
    A = anchors_world.shape[0]
    if A == 0:
        return None, None

    # observations: project every anchor into every keyframe, associate
    # against the measured depth
    obs_frame, obs_anchor, obs_meas, obs_normal = [], [], [], []
    for j in range(K):
        T = np.asarray(kf_c2w[j], np.float64)
        Rw2c, tw2c = T[:3, :3].T, -T[:3, :3].T @ T[:3, 3]
        pc = anchors_world @ Rw2c.T + tw2c  # (A, 3) in cam j
        z = pc[:, 2]
        ok = z > z_range[0]
        u = np.full(A, -1.0)
        v = np.full(A, -1.0)
        u[ok] = pc[ok, 0] * fx / z[ok] + cx
        v[ok] = pc[ok, 1] * fy / z[ok] + cy
        ui = np.round(u).astype(np.int64)
        vi = np.round(v).astype(np.int64)
        ok &= (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        ui, vi = np.clip(ui, 0, W - 1), np.clip(vi, 0, H - 1)
        meas = backproject(depths_m[j], ui, vi)  # measured surface point
        ok &= meas[:, 2] > 0
        ok &= np.linalg.norm(meas - pc, axis=-1) < match_dist
        nrm = normal_maps[j][vi, ui]
        ok &= np.isfinite(nrm).all(axis=-1)
        idx = np.nonzero(ok)[0]
        obs_frame.append(np.full(idx.shape[0], j))
        obs_anchor.append(idx)
        obs_meas.append(meas[idx])
        obs_normal.append(nrm[idx])
    obs_frame = np.concatenate(obs_frame)
    obs_anchor = np.concatenate(obs_anchor)
    obs_meas = np.concatenate(obs_meas, axis=0)
    obs_normal = np.concatenate(obs_normal, axis=0)

    # keep anchors observed from >= min_obs DISTINCT keyframes
    counts = np.bincount(obs_anchor, minlength=A)
    keep = counts >= min_obs
    if not keep.any():
        return None, None
    remap = -np.ones(A, np.int64)
    remap[keep] = np.arange(int(keep.sum()))
    sel = keep[obs_anchor]
    problem = BAProblem(
        frame_idx=torch.as_tensor(obs_frame[sel].astype(np.int32), device=device),
        anchor_idx=torch.as_tensor(remap[obs_anchor[sel]].astype(np.int32), device=device),
        meas_cam=torch.as_tensor(obs_meas[sel].astype(np.float32), device=device),
        meas_normal=torch.as_tensor(obs_normal[sel].astype(np.float32), device=device),
    )
    return problem, anchors_world[keep].astype(np.float32)


class BAProblem(NamedTuple):
    """Depth-reprojection BA: observation o says anchor ``anchor_idx[o]``
    seen from keyframe ``frame_idx[o]`` at camera-space position
    ``meas_cam[o]`` (back-projected measured depth). When ``meas_normal``
    is present (camera-space surface normal at the measured pixel) the
    residual is point-to-plane + a down-weighted point-to-point term —
    insensitive to the half-pixel lateral association error that floors
    pure point-to-point on projective associations (ICP.cu:256-259)."""

    frame_idx: torch.Tensor  # (N,) int32
    anchor_idx: torch.Tensor  # (N,) int32
    meas_cam: torch.Tensor  # (N, 3)
    meas_normal: Optional[torch.Tensor] = None  # (N, 3) or None
    # per-observation weight (None = all ones). Weight-0 rows are inert: they
    # pad problems to a fixed bucket size across re-association rounds
    obs_weight: Optional[torch.Tensor] = None  # (N,)


def pad_problem(problem: BAProblem, bucket: int) -> BAProblem:
    """Pad a :class:`BAProblem` with zero-weight observations up to
    ``bucket`` rows (shape-stable across re-association rounds)."""
    N = int(problem.frame_idx.shape[0])
    if N > bucket:
        raise ValueError(f"problem has {N} observations > bucket {bucket}")
    pad = bucket - N
    w = (
        problem.obs_weight
        if problem.obs_weight is not None
        else torch.ones((N,), dtype=torch.float32, device=problem.frame_idx.device)
    )
    if pad == 0:
        return problem._replace(obs_weight=w)

    def zpad(a, val=0):
        return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), val, dtype=a.dtype, device=a.device)])

    return BAProblem(
        frame_idx=zpad(problem.frame_idx),
        anchor_idx=zpad(problem.anchor_idx),
        meas_cam=zpad(problem.meas_cam),
        meas_normal=(
            None if problem.meas_normal is None else zpad(problem.meas_normal)
        ),
        obs_weight=zpad(w),
    )


class BAResult(NamedTuple):
    poses: torch.Tensor  # (K, 6)
    anchors: torch.Tensor  # (L, 3)
    residual_history: torch.Tensor


def _obs_residual(xi, p, meas_cam) -> torch.Tensor:
    """3-D residual: anchor transformed to camera minus measurement."""
    T = _exp(xi)
    w2c_R = T[:3, :3].T
    w2c_t = -w2c_R @ T[:3, 3]
    return w2c_R @ _f32(p) + w2c_t - _f32(meas_cam)


# down-weight of the point-to-point regularizer in the plane residual: the
# plane term carries the pose information; the point term only keeps each
# anchor's tangential position observable (Hll would be rank-1 per
# observation otherwise)
_POINT_WEIGHT = 0.2


def _obs_residual_plane(xi, p, meas_cam, meas_normal) -> torch.Tensor:
    """(4,) residual: point-to-plane distance + down-weighted point term."""
    d = _obs_residual(xi, p, meas_cam)
    return torch.cat([torch.sum(_f32(meas_normal) * d)[None], _POINT_WEIGHT * d])


def _residual_fn(problem: BAProblem):
    """The residual of observation ``o`` at pose ``xi`` and anchor ``p``,
    scaled by its weight where the problem has weights (weight-0 rows are
    inert: the residual and its Jacobians scale by w)."""
    if problem.meas_normal is None:
        base = lambda xi, p, o: _obs_residual(xi, p, problem.meas_cam[o])  # noqa: E731
    else:
        base = lambda xi, p, o: _obs_residual_plane(  # noqa: E731
            xi, p, problem.meas_cam[o], problem.meas_normal[o]
        )
    if problem.obs_weight is None:
        return base
    return lambda xi, p, o: problem.obs_weight[o] * base(xi, p, o)


def _obs_terms(poses: torch.Tensor, anchors: torch.Tensor, problem: BAProblem, ks: torch.Tensor,
               ls: torch.Tensor):
    """Every observation's residual of :func:`_residual_fn` (N, R) and its
    Jacobians ``Jc`` (N, R, 6) and ``Jl`` (N, R, 3), R = 4 with normals and 3
    without. The world-to-camera pose ``(R^T, -R^T t)`` and its six
    derivative lanes are made once a keyframe; an observation's residual is
    linear in them."""
    T, dT = _exp_lanes(poses)
    w2c_R = T[:, :3, :3].transpose(1, 2)
    w2c_t = -(w2c_R @ T[:, :3, 3:])[..., 0]
    d_R = dT[:, :, :3, :3].transpose(2, 3)  # (K, 6, 3, 3)
    d_t = -((d_R @ T[:, None, :3, 3:]) + (w2c_R[:, None] @ dT[:, :, :3, 3:]))[..., 0]  # (K, 6, 3)
    p = anchors[ls]
    R_o = w2c_R[ks]
    d = _j(R_o, p) + w2c_t[ks] - problem.meas_cam
    Jc = (_j(d_R[ks], p[:, None, :]) + d_t[ks]).transpose(1, 2)  # (N, 3, 6)
    Jl = R_o
    if problem.meas_normal is not None:
        n = problem.meas_normal
        d = torch.cat([torch.sum(n * d, -1, keepdim=True), _POINT_WEIGHT * d], -1)
        Jc = torch.cat([_jT(Jc, n)[:, None], _POINT_WEIGHT * Jc], 1)
        Jl = torch.cat([_jT(Jl, n)[:, None], _POINT_WEIGHT * Jl], 1)
    if problem.obs_weight is not None:
        w = problem.obs_weight
        d, Jc, Jl = w[:, None] * d, w[:, None, None] * Jc, w[:, None, None] * Jl
    return d, Jc, Jl


def _indices(problem: BAProblem):
    return problem.frame_idx.to(torch.int64), problem.anchor_idx.to(torch.int64)


def schur_ba(
    poses_init: torch.Tensor,
    anchors_init: torch.Tensor,
    problem: BAProblem,
    iters: int = 8,
    damping: float = 1e-4,
    axis_name: Optional[str] = None,
) -> BAResult:
    """Gauss-Newton with Schur elimination of the anchor blocks.

    Per iteration: per-observation Jacobians (6 pose, 3 anchor) -> blocks
    ``Hcc (6K,6K)``, ``Hll (L,3,3)``, ``Hcl (K,L,6,3)``, gradients — then the
    reduced camera system ``(Hcc - Hcl Hll^-1 Hlc) dc = -(gc - Hcl Hll^-1 gl)``,
    solved densely. Keyframe 0 is gauge-fixed. The oracle that
    :func:`schur_ba_cg` is tested against; ``axis_name`` must be ``None``."""
    _no_axis(axis_name)
    poses = _f32(poses_init)
    dev = poses.device
    anchors = _f32(anchors_init, dev)
    K, L = poses.shape[0], anchors.shape[0]
    ks, ls = _indices(problem)
    seg_k, seg_l, seg_kl = _Segments(ks, K), _Segments(ls, L), _Segments(ks * L + ls, K * L)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    eye6k = torch.eye(6 * K, dtype=torch.float32, device=dev)
    mask = torch.ones(6 * K, dtype=torch.float32, device=dev)
    mask[:6] = 0.0
    diag = torch.arange(K, device=dev)
    hist = []
    for _ in range(iters):
        rs, Jcs, Jls = _obs_terms(poses, anchors, problem, ks, ls)
        Hcc = torch.zeros((K, K, 6, 6), dtype=torch.float32, device=dev)
        Hcc[diag, diag] = seg_k(_outer(Jcs, Jcs))
        Hll = seg_l(_outer(Jls, Jls))
        Hcl = seg_kl(_outer(Jcs, Jls)).reshape(K, L, 6, 3)
        gc = seg_k(_jT(Jcs, rs))
        gl = seg_l(_jT(Jls, rs))
        sq = torch.sum(rs * rs)

        Hll_inv = torch.linalg.inv_ex(Hll + damping * eye3)[0]  # (L,3,3) parallel
        # S = Hcc - Hcl Hll^-1 Hlc  (camera-block Schur complement)
        tmp = torch.einsum("klij,ljm->klim", Hcl, Hll_inv)  # (K,L,6,3)
        S = Hcc - torch.einsum("klim,qlnm->kqin", tmp, Hcl)
        b = gc - torch.einsum("klim,lm->ki", tmp, gl)

        Sd = S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K) + damping * eye6k
        bd = b.reshape(6 * K)
        # gauge fix keyframe 0
        Sd = Sd * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
        bd = bd * mask
        dc = -torch.linalg.solve_ex(Sd, bd)[0]
        # back-substitute anchors: dl = -Hll^-1 (gl + Hlc dc)
        dc_k = dc.reshape(K, 6)
        hlc_dc = torch.einsum("klim,ki->lm", Hcl, dc_k)
        dl = -_block_solve(Hll_inv, gl + hlc_dc)
        poses, anchors = poses + dc_k, anchors + dl
        hist.append(sq)
    return BAResult(poses=poses, anchors=anchors, residual_history=_history(hist, dev))


def schur_ba_cg(
    poses_init: torch.Tensor,
    anchors_init: torch.Tensor,
    problem: BAProblem,
    iters: int = 8,
    damping: float = 1e-4,
    cg_iters: int = 40,
    axis_name: Optional[str] = None,
) -> BAResult:
    """Scalable Schur-complement BA: matrix-free CG on the reduced camera
    system — the production path for real keyframe counts.

    Never forms ``Hcc`` or ``Hcl``. Each Gauss-Newton iteration keeps the
    per-observation Jacobians (``Jc (N,R,6)``, ``Jl (N,R,3)``) and the
    block-diagonal ``Hll (L,3,3)``, and solves ``S dc = -(gc - Hcl Hll^-1
    gl)`` by conjugate gradients where every ``S @ x`` is two segment sums
    over the observations (:class:`_Segments`, the order fixed by the
    problem):

        u = Jc x[k]                  (N,R)   per observation
        Hcc x   = sum_k Jc^T u               (K,6)
        v       = sum_l Jl^T u               (L,3)
        w       = Hll^-1 v                   (L,3)   block-diagonal
        Hcl w   = sum_k Jc^T (Jl w[l])       (K,6)
        S x     = Hcc x - Hcl w + damping*x

    O(N + K + L) memory, O(cg_iters * N) work per GN step. Preconditioner:
    inverse block diagonal of Hcc (6x6 per keyframe). Keyframe 0 is
    gauge-fixed. ``axis_name`` must be ``None`` (no sharded form).
    """
    _no_axis(axis_name)
    poses = _f32(poses_init)
    dev = poses.device
    anchors = _f32(anchors_init, dev)
    K, L = poses.shape[0], anchors.shape[0]
    ks, ls = _indices(problem)
    gauge = _gauge(K, dev)
    seg_k, seg_l = _Segments(ks, K), _Segments(ls, L)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    hist = []
    for _ in range(iters):
        rs, Jcs, Jls = _obs_terms(poses, anchors, problem, ks, ls)
        # gc with Hcc's block diagonal, gl with Hll: one ordered sum each
        by_k = seg_k(torch.cat([_jT(Jcs, rs), _outer(Jcs, Jcs).reshape(-1, 36)], 1))
        by_l = seg_l(torch.cat([_jT(Jls, rs), _outer(Jls, Jls).reshape(-1, 9)], 1))
        gc, Hcc_diag = by_k[:, :6], by_k[:, 6:].reshape(K, 6, 6)
        gl, Hll = by_l[:, :3], by_l[:, 3:].reshape(L, 3, 3)
        Hll_inv = torch.linalg.inv_ex(Hll + damping * eye3)[0]
        # Jacobi block preconditioner from the Hcc block diagonal
        M_inv = torch.linalg.inv_ex(Hcc_diag + damping * eye6)[0]

        def matvec(x):  # (K,6) -> S x, gauge-masked
            x = x * gauge
            u = _j(Jcs, x[ks])  # (N,R)
            w = _block_solve(Hll_inv, seg_l(_jT(Jls, u)))
            z = _j(Jls, w[ls])  # (N,R)
            hz = seg_k(torch.cat([_jT(Jcs, u), _jT(Jcs, z)], 1))
            return (hz[:, :6] - hz[:, 6:] + damping * x) * gauge

        # rhs: b = -(gc - Hcl Hll^-1 gl)
        z0 = _j(Jls, _block_solve(Hll_inv, gl)[ls])
        b = -(gc - seg_k(_jT(Jcs, z0))) * gauge
        dc = _pcg(matvec, lambda r: _block_solve(M_inv, r) * gauge, b, cg_iters) * gauge

        # back-substitute anchors: dl = -Hll^-1 (gl + Hlc dc)
        hlc_dc = seg_l(_jT(Jls, _j(Jcs, dc[ks])))
        dl = -_block_solve(Hll_inv, gl + hlc_dc)
        hist.append(torch.sum(rs * rs))
        poses, anchors = poses + dc, anchors + dl
    return BAResult(poses=poses, anchors=anchors, residual_history=_history(hist, dev))
