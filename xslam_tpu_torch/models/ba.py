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

Every ``S @ x`` of :func:`schur_ba_cg` is B18 on the card
(``csrc/schur_cg.cu``): two launches, the sum by anchor and the sum by
keyframe (:func:`schur_cg_anchors`, :func:`schur_cg_keyframes`; plain
versions :func:`_anchors_plain`, :func:`_keyframes_plain`, whose products
are added in the kernel's order).

The observation-sharded forms (JAX's ``axis_name``): ``group``, a
:class:`~xslam_tpu_torch.parallel.mesh.SpaceGroup` whose ranks each pass
their own block of the observations (:func:`observation_block`); every block
and sum that JAX ``psum``s is summed by ``dist.all_reduce`` at the same point,
so every operand after it is replicated and CG's dot products need no
collective. ``group=None`` is the single form. As in the JAX package, no
entry point passes a group.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..csfd import single as cs
from ..geometry import se3
from ..ops import kernels
from ..parallel.mesh import SpaceGroup

# rows of a block of the prefix sums (_prefix): the scan's rows are short and many
_BLOCK = 256
CG_PER_THREAD = 4  # B18's sorted positions a thread (csrc/schur_cg.cu CG_PER_THREAD)
CG_CHUNK = 128 * CG_PER_THREAD  # its sorted positions a block of 128 threads (CG_CHUNK)


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
    outside ``[0, n)`` add nothing, as JAX drops them. No host read. The
    order, the sorted keys and each key's segment are int32, the form B18
    reads (the problems' indices are int32)."""

    def __init__(self, keys: torch.Tensor, n: int):
        self.n = n
        keys = keys.to(torch.int32)
        self.order = torch.argsort(keys, stable=True).to(torch.int32)
        self.sorted_keys = keys[self.order].contiguous()
        seg = torch.arange(n, dtype=torch.int32, device=keys.device)
        self.start = torch.searchsorted(self.sorted_keys, seg, out_int32=True)
        self.end = torch.searchsorted(self.sorted_keys, seg, right=True, out_int32=True)

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        shape = rows.shape[1:]
        # index_select takes the int32 tables as they are (advanced indexing would widen them a launch each)
        prefix = _prefix(rows.index_select(0, self.order).reshape(rows.shape[0], -1).to(torch.float64))
        ends = prefix.index_select(0, self.end) - prefix.index_select(0, self.start)
        return ends.to(torch.float32).reshape((self.n,) + shape)


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


def _summed(x: torch.Tensor, group: Optional[SpaceGroup]) -> torch.Tensor:
    """``x`` (a new contiguous tensor) summed over ``group``'s ranks in place
    (JAX's ``lax.psum``); ``x`` itself when ``group`` is None."""
    if group is not None:
        dist.all_reduce(x, group=group.group)
    return x


def _summed_all(xs, group: Optional[SpaceGroup]):
    """The tensors ``xs`` each summed over ``group``'s ranks, in one
    ``all_reduce`` of their concatenation; ``xs`` as they are when ``group``
    is None."""
    if group is None:
        return tuple(xs)
    flat = _summed(torch.cat([x.reshape(-1) for x in xs]), group)
    return tuple(part.view(x.shape) for part, x in zip(flat.split([x.numel() for x in xs]), xs))


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


def observation_block(problem: BAProblem, group: SpaceGroup) -> BAProblem:
    """This rank's block of the observations, as ``shard_map``'s
    ``P(SPACE_AXIS)`` splits the observation axis: the problem padded by
    :func:`pad_problem` to a multiple of the world size (weight-0 rows), then
    the rank's contiguous ``1 / world_size`` of its rows. The problem itself
    on one rank."""
    n = group.world_size
    if n == 1:
        return problem
    rows = int(problem.frame_idx.shape[0])
    padded = pad_problem(problem, -(-rows // n) * n)
    per = int(padded.frame_idx.shape[0]) // n
    lo = group.rank * per
    return BAProblem(*(None if a is None else a[lo:lo + per] for a in padded))


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


# ---------------------------------------------------------------------------
# B18: the two passes of S x in schur_ba_cg
def _dot(J: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``(J * y).sum(-1)`` with the products added in index order, as B18
    adds them (``csrc/schur_cg.cu``): each product and each sum rounded to
    float32 once, on every device."""
    acc = J[..., 0] * y[..., 0]
    for i in range(1, J.shape[-1]):
        acc = acc + J[..., i] * y[..., i]
    return acc


class _CgPass(NamedTuple):
    """One pass of B18 as the kernel reads it: the pass's :class:`_Segments`
    (its int32 order, sorted keys and segments), the observations' other
    index (int32), and its scratch: the chunks' first and last partial sums
    (float64) and the ticket of the block that sums the keys crossing a
    chunk."""

    seg: _Segments
    other: torch.Tensor
    first: torch.Tensor
    last: torch.Tensor
    ticket: torch.Tensor


def _cg_pass(seg: _Segments, other: torch.Tensor, width: int) -> _CgPass:
    dev = other.device
    chunks = -(-int(seg.order.shape[0]) // CG_CHUNK)
    return _CgPass(seg, other.to(torch.int32).contiguous(),
                   torch.empty((chunks, width), dtype=torch.float64, device=dev),
                   torch.empty((chunks, width), dtype=torch.float64, device=dev),
                   torch.zeros(1, dtype=torch.int32, device=dev))


class SchurCgPlan:
    """What the two passes of ``S x`` read for a whole :func:`schur_ba_cg`
    call: the observations' keyframes ``ks`` and anchors ``ls``, their
    :class:`_Segments` by keyframe and by anchor, and on the card each pass's
    :class:`_CgPass` (made once a call, no host read)."""

    def __init__(self, problem: BAProblem, K: int, L: int):
        self.ks, self.ls = _indices(problem)
        self.seg_k, self.seg_l = _Segments(self.ks, K), _Segments(self.ls, L)
        self.anchors = self.keyframes = None
        if self.ks.device.type == "cuda":
            self.anchors = _cg_pass(self.seg_l, problem.frame_idx, 3)
            self.keyframes = _cg_pass(self.seg_k, problem.anchor_idx, 12)


def _anchors_plain(plan: SchurCgPlan, Jc: torch.Tensor, Jl: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Pass L of ``S x``: ``v[l] = sum over l's observations of Jl^T (Jc x[k])``
    (L, 3), each anchor's sum ordered by :class:`_Segments`."""
    u = _dot(Jc, x[plan.ks][:, None, :])  # (N, R)
    return plan.seg_l(_dot(Jl.transpose(1, 2), u[:, None, :]))


def _keyframes_plain(plan: SchurCgPlan, Jc: torch.Tensor, Jl: torch.Tensor, Hll_inv: torch.Tensor,
                     v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Pass K of ``S x``: with ``u = Jc x[k]`` and ``z = Jl (Hll_inv v)[l]``,
    each keyframe's sums of ``Jc^T u`` and of ``Jc^T z`` side by side (K, 12),
    ordered by :class:`_Segments`."""
    u = _dot(Jc, x[plan.ks][:, None, :])
    w = _dot(Hll_inv, v[:, None, :])  # (L, 3)
    z = _dot(Jl, w[plan.ls][:, None, :])  # (N, R)
    jc_t = Jc.transpose(1, 2)
    return plan.seg_k(torch.cat([_dot(jc_t, u[:, None, :]), _dot(jc_t, z[:, None, :])], 1))


def _check_rows(Jc: torch.Tensor, Jl: torch.Tensor, x: torch.Tensor, plan: SchurCgPlan) -> None:
    N, R = Jc.shape[:2]
    if R not in (3, 4):
        raise ValueError(f"Jc: R must be 3 or 4, got {R}")
    kernels.check_tensor(Jc, "Jc", torch.float32, (N, R, 6))
    kernels.check_tensor(Jl, "Jl", torch.float32, (N, R, 3))
    kernels.check_tensor(x, "x", torch.float32, (plan.seg_k.n, 6))
    if Jc.data_ptr() % 16 or Jl.data_ptr() % 16:
        raise ValueError("Jc, Jl: B18 reads their rows as float4, the tensors must be 16-byte aligned")
    if plan.anchors is None or plan.ks.device != Jc.device:
        raise ValueError(f"the plan was made on {plan.ks.device}, the rows lie on {Jc.device}")


def schur_cg_anchors(plan: SchurCgPlan, Jc: torch.Tensor, Jl: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """B18's pass L (``xslam_tpu/models/ba.py:604-605``): each anchor's
    ``sum Jl^T (Jc x[k])`` over its observations, (L, 3) float32. ``Jc`` (N,
    R, 6), ``Jl`` (N, R, 3) contiguous, ``x`` (K, 6) gauge-masked. On CPU
    tensors :func:`_anchors_plain`; on the card one launch of
    ``csrc/schur_cg.cu``."""
    if kernels.on_cpu(Jc, Jl, x):
        return _anchors_plain(plan, Jc, Jl, x)
    _check_rows(Jc, Jl, x, plan)
    p, s = plan.anchors, plan.seg_l
    v = torch.empty((s.n, 3), dtype=torch.float32, device=Jc.device)
    kernels.launch("schur_cg_anchors", Jc.device, Jc, Jl, s.order, s.sorted_keys, s.start, s.end, p.other, x,
                   p.first, p.last, p.ticket, v)
    kernels.launch_counts["schur_cg_anchors"] += 1
    return v


def schur_cg_keyframes(plan: SchurCgPlan, Jc: torch.Tensor, Jl: torch.Tensor, Hll_inv: torch.Tensor,
                       v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """B18's pass K (``xslam_tpu/models/ba.py:606-608``): with ``v`` summed
    over the ranks, each keyframe's ``sum Jc^T (Jc x[k])`` and ``sum Jc^T (Jl
    (Hll_inv v)[l])`` side by side, (K, 12) float32; their difference is
    ``S x``'s. On CPU tensors :func:`_keyframes_plain`; on the card one launch
    of ``csrc/schur_cg.cu``."""
    if kernels.on_cpu(Jc, Jl, Hll_inv, v, x):
        return _keyframes_plain(plan, Jc, Jl, Hll_inv, v, x)
    _check_rows(Jc, Jl, x, plan)
    L = plan.seg_l.n
    kernels.check_tensor(Hll_inv, "Hll_inv", torch.float32, (L, 3, 3))
    kernels.check_tensor(v, "v", torch.float32, (L, 3))
    p, s = plan.keyframes, plan.seg_k
    hz = torch.empty((s.n, 12), dtype=torch.float32, device=Jc.device)
    kernels.launch("schur_cg_keyframes", Jc.device, Jc, Jl, s.order, s.sorted_keys, s.start, s.end, p.other, x,
                   Hll_inv, v, p.first, p.last, p.ticket, hz)
    kernels.launch_counts["schur_cg_keyframes"] += 1
    return hz


# ---------------------------------------------------------------------------
def schur_ba(
    poses_init: torch.Tensor,
    anchors_init: torch.Tensor,
    problem: BAProblem,
    iters: int = 8,
    damping: float = 1e-4,
    group: Optional[SpaceGroup] = None,
) -> BAResult:
    """Gauss-Newton with Schur elimination of the anchor blocks.

    Per iteration: per-observation Jacobians (6 pose, 3 anchor) -> blocks
    ``Hcc (6K,6K)``, ``Hll (L,3,3)``, ``Hcl (K,L,6,3)``, gradients — then the
    reduced camera system ``(Hcc - Hcl Hll^-1 Hlc) dc = -(gc - Hcl Hll^-1 gl)``,
    solved densely. Keyframe 0 is gauge-fixed. The oracle that
    :func:`schur_ba_cg` is tested against.

    With ``group`` each rank passes its block of the observations
    (:func:`observation_block`) and the blocks, gradients and squared
    residual are summed over the ranks (one ``all_reduce`` an iteration,
    ``xslam_tpu/models/ba.py:471``)."""
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
        Hcc, Hll, Hcl, gc, gl, sq = _summed_all((Hcc, Hll, Hcl, gc, gl, sq), group)

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
    group: Optional[SpaceGroup] = None,
) -> BAResult:
    """Scalable Schur-complement BA: matrix-free CG on the reduced camera
    system — the production path for real keyframe counts.

    Never forms ``Hcc`` or ``Hcl``. Each Gauss-Newton iteration keeps the
    per-observation Jacobians (``Jc (N,R,6)``, ``Jl (N,R,3)``) and the
    block-diagonal ``Hll (L,3,3)``, and solves ``S dc = -(gc - Hcl Hll^-1
    gl)`` by conjugate gradients where every ``S @ x`` is two segment sums
    over the observations (B18: :func:`schur_cg_anchors` and
    :func:`schur_cg_keyframes`, the order fixed by the problem):

        u = Jc x[k]                  (N,R)   per observation
        v       = sum_l Jl^T u               (L,3)   [summed over the ranks]
        w       = Hll^-1 v                   (L,3)   block-diagonal
        Hcc x   = sum_k Jc^T u               (K,6)
        Hcl w   = sum_k Jc^T (Jl w[l])       (K,6)
        S x     = Hcc x - Hcl w + damping*x          [the difference summed]

    O(N + K + L) memory, O(cg_iters * N) work per GN step. Preconditioner:
    inverse block diagonal of Hcc (6x6 per keyframe). Keyframe 0 is
    gauge-fixed.

    With ``group`` each rank passes its block of the observations
    (:func:`observation_block`); ``gc``, ``Hcc``'s diagonal, ``gl``, ``Hll``
    and the squared residual (one ``all_reduce`` an iteration), ``v`` and the
    difference of each ``S @ x``, the right-hand side's sum and the
    back-substitution's are summed over the ranks
    (``xslam_tpu/models/ba.py:583-654``): two small sums a CG step.
    """
    poses = _f32(poses_init)
    dev = poses.device
    anchors = _f32(anchors_init, dev)
    K, L = poses.shape[0], anchors.shape[0]
    plan = SchurCgPlan(problem, K, L)
    ks, ls = plan.ks, plan.ls
    gauge = _gauge(K, dev)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    hist = []
    for _ in range(iters):
        rs, Jcs, Jls = _obs_terms(poses, anchors, problem, ks, ls)
        jc_rows, jl_rows = Jcs.contiguous(), Jls.contiguous()  # B18's rows
        # gc with Hcc's block diagonal, gl with Hll: one ordered sum each; summed over the ranks with the residual
        by_k = plan.seg_k(torch.cat([_jT(Jcs, rs), _outer(Jcs, Jcs).reshape(-1, 36)], 1))
        by_l = plan.seg_l(torch.cat([_jT(Jls, rs), _outer(Jls, Jls).reshape(-1, 9)], 1))
        by_k, by_l, sq = _summed_all((by_k, by_l, torch.sum(rs * rs)), group)
        gc, Hcc_diag = by_k[:, :6], by_k[:, 6:].reshape(K, 6, 6)
        gl, Hll = by_l[:, :3], by_l[:, 3:].reshape(L, 3, 3)
        Hll_inv = torch.linalg.inv_ex(Hll + damping * eye3)[0]
        hll_rows = Hll_inv.contiguous()  # B18's (the card's inverse comes column-major)
        # Jacobi block preconditioner from the Hcc block diagonal
        M_inv = torch.linalg.inv_ex(Hcc_diag + damping * eye6)[0]

        def matvec(x):  # (K,6) -> S x, gauge-masked
            x = x * gauge
            v = _summed(schur_cg_anchors(plan, jc_rows, jl_rows, x), group)
            hz = schur_cg_keyframes(plan, jc_rows, jl_rows, hll_rows, v, x)
            return (_summed(hz[:, :6] - hz[:, 6:], group) + damping * x) * gauge

        # rhs: b = -(gc - Hcl Hll^-1 gl)
        z0 = _j(Jls, _block_solve(Hll_inv, gl)[ls])
        b = -(gc - _summed(plan.seg_k(_jT(Jcs, z0)), group)) * gauge
        dc = _pcg(matvec, lambda r: _block_solve(M_inv, r) * gauge, b, cg_iters) * gauge

        # back-substitute anchors: dl = -Hll^-1 (gl + Hlc dc)
        hlc_dc = _summed(plan.seg_l(_jT(Jls, _j(Jcs, dc[ks]))), group)
        dl = -_block_solve(Hll_inv, gl + hlc_dc)
        hist.append(sq)
        poses, anchors = poses + dc, anchors + dl
    return BAResult(poses=poses, anchors=anchors, residual_history=_history(hist, dev))
