"""Projective point-to-plane ICP: correspondence search + normal equations.

Port of ``xslam_tpu/ops/icp.py`` (reference ``ICP.cu``): ``associate``,
``build_system``, ``compute_optimize_matrix`` and ``solve_increment``, and of
the pose update of ``xslam_tpu/models/kinfu.py::_pose_estimate``. Per
pixel the dual row ``[cross(s,n), n | n·(d−s)]`` is built, and ``A = JᵀJ``,
``b = Jᵀr`` are reduced over all pixels; the 6x6 dual system is solved and
the pose moved by the Euler increment.

:func:`build_system`, :func:`icp_step`, :class:`IcpLoop` and
:func:`associate_index` are the wrappers of kernel K4 (``csrc/icp.cu``, two
entry points): on CUDA tensors they launch it, on CPU tensors they run
:func:`build_system_plain`, :func:`icp_step_plain` and
:func:`associate_index_plain`, its plain versions, and they never fall back
from one to the other. ``icp_system`` has two modes: :func:`build_system`
stops after ``A``, ``b`` and the inlier count; :func:`icp_step` and
:class:`IcpLoop` give it a pose output, and the kernel then also solves the
system and writes the next iteration's pose (its "tail"), so an ICP loop on
the card is one launch per iteration with nothing between them. The kernel
adds the rows in double and rounds once; the plain version reduces in
4096-row float32 blocks and then over the blocks, as the JAX package does
(its matmuls run in full float32: the package pins TF32 off at import).

The cached association (``SlamConfig.icp_fixed_assoc``) is an int32 (H, W)
map of the flat index of each pixel's target in the previous model, −1 where
the pixel does not project into the image. That is equivalent to the JAX
package's cache of the 12 gathered floats (:class:`Association`), because a
row is valid only where the pixel is in the image; :func:`build_system_plain`
takes either form. On the card the engine does not launch the association
on its own: the level's first ``icp_system`` launch, which runs at the pose
the association is made at and projects every pixel anyway, writes the map
(``IcpLoop.iterate(..., assoc_out=)``; −1 also where the current normal is
NaN, a pixel no iteration adds), and the level's later launches read it.

The sharded engine's iteration (B19d, :mod:`xslam_tpu_torch.parallel.sharded`)
is ``IcpLoop(pose, reduce=)``: each rank launches ``icp_system`` on its block
of the current maps' columns with the 55 double totals as output, the ranks
sum them (``reduce``, an ``all_reduce``), and :func:`icp_tail` (K4's tail as
a launch of its own) solves the summed system and moves the pose: on one
rank the fused launch's bits.

Nothing here reads a value back to the host, so the ICP loop queues on the
device without a sync; the per-step ``ok`` flags stay device booleans.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..csfd import vec3
from ..csfd.single import CSFD, lift, solve
from ..geometry import se3
from ..geometry.intrinsics import Intrinsics
from . import kernels
from .sampling import to_index

# csrc/icp.cu: the pixels one block of a launch takes (half a warp's tile of
# 32 pixels for each of its 8 warps: measured on the H100, more and smaller
# blocks beat fewer partial sums down to this size), the most blocks a
# launch uses (three for each of the 132 SMs, one wave), the doubles each
# block writes (54 sums and the inlier count) and the floats of the packed pose
ICP_PIXELS_PER_BLOCK = 128
ICP_MAX_BLOCKS = 396
ICP_SUMS = 55
POSE_FLOATS = 36


def icp_blocks(n_pixels: int) -> int:
    """The grid of an ``icp_system`` launch over ``n_pixels`` current pixels.
    It depends on the shape alone, and with it the order of the sums."""
    return max(1, min(ICP_MAX_BLOCKS, -(-n_pixels // ICP_PIXELS_PER_BLOCK)))


class IcpSystem(NamedTuple):
    A: CSFD  # (6, 6) dual normal matrix
    b: CSFD  # (6,) dual rhs
    inlier_count: torch.Tensor  # scalar


class IcpStep(NamedTuple):
    """One whole ICP iteration: the system, the pose after the step (the
    pose before it where the step failed), the increment and the flag."""

    system: IcpSystem
    r_curr: CSFD  # (3, 3)
    t_curr: CSFD  # (3,)
    x: CSFD  # (6,) [alpha beta gamma tx ty tz]
    ok: torch.Tensor  # bool scalar


class Association(NamedTuple):
    """Projective correspondences: the gathered previous-model vertices and
    normals, and the projection validity mask."""

    nprev_g: CSFD
    vprev_g: CSFD
    in_img: torch.Tensor


def _gather_prev_rows(vmap_g_prev: CSFD, nmap_g_prev: CSFD, iy, ix):
    """Fetch the previous model's 12 floats per pixel; out-of-image pixels
    get NaN values and zero derivatives."""
    H, W = vmap_g_prev.v.shape[-2:]
    ok = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
    flat = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(-1)
    r = _model_table(vmap_g_prev, nmap_g_prev)[:, flat].reshape(12, *iy.shape)
    vprev = CSFD(torch.where(ok, r[0:3], torch.nan), torch.where(ok, r[3:6], 0.0))
    nprev = CSFD(torch.where(ok, r[6:9], torch.nan), torch.where(ok, r[9:12], 0.0))
    return vprev, nprev


def _model_table(vmap_g_prev: CSFD, nmap_g_prev: CSFD) -> torch.Tensor:
    """The model's twelve planes as (12, H * W): v.v, v.g, n.v, n.g."""
    return torch.cat([vmap_g_prev.v, vmap_g_prev.g, nmap_g_prev.v, nmap_g_prev.g]).reshape(12, -1)


def pack_model_rows(vmap_g_prev: CSFD, nmap_g_prev: CSFD) -> torch.Tensor:
    """The model maps of one level as K4 reads them: (H * W, 12) float32, one
    48-byte row per pixel (v.v, v.g, n.v, n.g), packed once per frame."""
    return _model_table(vmap_g_prev, nmap_g_prev).t().contiguous()


def _project(r_curr: CSFD, t_curr: CSFD, vmap_curr, r_prev_inv: CSFD, t_prev: CSFD, intr: Intrinsics, H: int, W: int):
    """Pixel (row, column) of each current vertex in the previous camera's
    (H, W) image, and whether it lies in the image with ``z >= 0``
    (ICP.cu:196-217). Projection on the value lane, rounding half to even."""
    vcurr_g = _world_vertices(r_curr, t_curr, vmap_curr)
    diff = vcurr_g - CSFD(t_prev.v[:, None, None], t_prev.g[:, None, None])
    vcurr_cp = vec3.matvec(r_prev_inv, diff)  # prev camera space
    px = vcurr_cp.v[0] * intr.fx / vcurr_cp.v[2] + intr.cx
    py = vcurr_cp.v[1] * intr.fy / vcurr_cp.v[2] + intr.cy
    ux = to_index(torch.round(px))
    uy = to_index(torch.round(py))
    in_img = (ux >= 0) & (uy >= 0) & (ux < W) & (uy < H) & (vcurr_cp.v[2] >= 0)
    return uy, ux, in_img


def _world_vertices(r_curr: CSFD, t_curr: CSFD, vmap_curr: torch.Tensor) -> CSFD:
    return vec3.matvec(r_curr, lift(vmap_curr)) + CSFD(t_curr.v[:, None, None], t_curr.g[:, None, None])


def associate(
    r_curr: CSFD,
    t_curr: CSFD,
    vmap_curr: torch.Tensor,
    r_prev_inv: CSFD,
    t_prev: CSFD,
    intr: Intrinsics,
    vmap_g_prev: CSFD,
    nmap_g_prev: CSFD,
) -> Association:
    """Projective data association (ICP.cu:196-231): transform current
    vertices into the previous camera, project and gather the model maps.
    The projection bounds come from the previous maps, whose shape may be
    coarser than the current maps' (``model_map_level``)."""
    H, W = vmap_g_prev.v.shape[-2:]
    uy, ux, in_img = _project(r_curr, t_curr, vmap_curr, r_prev_inv, t_prev, intr, H, W)
    vprev_g, nprev_g = _gather_prev_rows(vmap_g_prev, nmap_g_prev, uy, ux)
    return Association(nprev_g=nprev_g, vprev_g=vprev_g, in_img=in_img)


def associate_index_plain(r_curr, t_curr, vmap_curr, r_prev_inv, t_prev, intr: Intrinsics, prev_shape) -> torch.Tensor:
    """Plain version of K4's association entry point: the int32 map of each
    pixel's flat target index in the ``prev_shape`` model maps, −1 where the
    pixel is not in the image."""
    H, W = prev_shape
    uy, ux, in_img = _project(r_curr, t_curr, vmap_curr, r_prev_inv, t_prev, intr, H, W)
    return torch.where(in_img, uy * W + ux, -1).to(torch.int32)


def _association_from_index(index: torch.Tensor, vmap_g_prev: CSFD, nmap_g_prev: CSFD) -> Association:
    W = vmap_g_prev.v.shape[-1]
    idx = index.long()
    iy = torch.where(idx >= 0, idx // W, -1)
    ix = torch.where(idx >= 0, idx % W, -1)
    vprev_g, nprev_g = _gather_prev_rows(vmap_g_prev, nmap_g_prev, iy, ix)
    return Association(nprev_g=nprev_g, vprev_g=vprev_g, in_img=idx >= 0)


def pack_pose(r_curr: CSFD, t_curr: CSFD, r_prev_inv: CSFD, t_prev: CSFD) -> torch.Tensor:
    """The 36 pose floats K4 reads, as one device tensor (no host read):
    R_curr.v, R_curr.g, t_curr.v, t_curr.g, R_prev_inv.v, t_prev.v."""
    parts = (r_curr.v, r_curr.g, t_curr.v, t_curr.g, r_prev_inv.v, t_prev.v)
    return torch.cat([p.reshape(-1) for p in parts]).to(torch.float32).contiguous()


def unpack_pose(pose: torch.Tensor) -> Tuple[CSFD, CSFD]:
    """``(R_curr, t_curr)`` of a packed pose, as views of it."""
    return CSFD(pose[0:9].view(3, 3), pose[9:18].view(3, 3)), CSFD(pose[18:21], pose[21:24])


def _check_maps(vmap_curr, maps, names):
    if vmap_curr.dim() != 3 or vmap_curr.shape[0] != 3:
        raise ValueError(f"vmap_curr: expected (3, H, W), got {tuple(vmap_curr.shape)}")
    for t, name in zip(maps, names):
        kernels.check_tensor(t, name, torch.float32)
        if t.dim() != 3 or t.shape[0] != 3:
            raise ValueError(f"{name}: expected (3, H, W), got {tuple(t.shape)}")


def associate_index(r_curr, t_curr, vmap_curr, r_prev_inv, t_prev, intr: Intrinsics, prev_shape) -> torch.Tensor:
    """The cached association of one pyramid level (``icp_fixed_assoc``):
    kernel K4's ``icp_associate`` entry point on CUDA tensors, its plain
    version on CPU tensors. The engine calls it on the CPU only; on the card
    the level's first ICP launch writes the same map wherever the current
    normal is a number (:class:`IcpLoop`), and this entry point is the
    reference it is held against."""
    if kernels.on_cpu(vmap_curr, r_curr.v, t_curr.v, r_prev_inv.v, t_prev.v):
        return associate_index_plain(r_curr, t_curr, vmap_curr, r_prev_inv, t_prev, intr, prev_shape)
    _check_maps(vmap_curr, (vmap_curr,), ("vmap_curr",))
    H, W = prev_shape
    pose = pack_pose(r_curr, t_curr, r_prev_inv, t_prev)
    index = torch.empty(vmap_curr.shape[1:], dtype=torch.int32, device=vmap_curr.device)
    kernels.launch(
        "icp_associate", vmap_curr.device, vmap_curr, pose, index, int(H), int(W),
        kernels.f32(intr.fx), kernels.f32(intr.fy), kernels.f32(intr.cx), kernels.f32(intr.cy),
    )
    kernels.launch_counts["icp_associate"] += 1
    return index


class _Scratch:
    """K4's scratch on one device and stream, since launches on one stream
    run in order: the blocks' partial sums; the ticket counter, which the
    kernel leaves zeroed; and what an ICP loop keeps on the device between
    its launches: the pose pair (one read, the other written, then swapped),
    ``A`` and ``b``, the inlier count, ``x`` and the two flags (this step
    solved; every step of the frame solved)."""

    def __init__(self, device: torch.device):
        f32 = dict(dtype=torch.float32, device=device)
        self.partials = torch.empty((ICP_MAX_BLOCKS, ICP_SUMS), dtype=torch.float64, device=device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=device)
        self.pose = torch.zeros((2, POSE_FLOATS), **f32)
        self.out = torch.empty(84, **f32)
        self.inliers = torch.empty((), dtype=torch.int32, device=device)
        self.x = torch.empty(12, **f32)
        self.flags = torch.zeros(2, dtype=torch.int32, device=device)
        self.totals = torch.empty(ICP_SUMS, dtype=torch.float64, device=device)  # a sharded iteration's sums


_scratch: dict = {}  # (device, stream) -> _Scratch


def _icp_scratch(device: torch.device) -> _Scratch:
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    if key not in _scratch:
        _scratch[key] = _Scratch(device)
    return _scratch[key]


def _launch_system(scratch, vmap_curr, nmap_curr, model_rows, prev_shape, assoc, pose, out, inliers, intr,
                   dist_thres, angle_thres, tail=None, damping=0.0, first=False, assoc_out=None,
                   totals_out=None) -> None:
    """Check the tensors and launch ``icp_system`` once. ``tail`` is ``None``
    or ``(pose_out, x_out, flags)``; ``assoc_out``, where ``assoc`` is
    ``None``, the int32 (H, W) map the launch writes its association into;
    ``totals_out``, where given, the 55 float64 the launch writes its sums
    into (B19d). Nothing here runs on the device but the kernel."""
    _check_maps(vmap_curr, (vmap_curr, nmap_curr), ("vmap_curr", "nmap_curr"))
    if nmap_curr.shape != vmap_curr.shape:
        raise ValueError("the current maps must share one shape")
    H, W = (int(n) for n in prev_shape)
    kernels.check_tensor(model_rows, "model_rows", torch.float32, (H * W, 12))
    kernels.check_tensor(pose, "pose", torch.float32, (POSE_FLOATS,))
    if assoc is not None:
        if not isinstance(assoc, torch.Tensor):
            raise TypeError("on CUDA the cached association is the int32 index map of associate_index")
        kernels.check_tensor(assoc, "assoc", torch.int32, vmap_curr.shape[1:])
    if assoc_out is not None:
        if assoc is not None:
            raise ValueError("a launch that reads a cached association writes none")
        kernels.check_tensor(assoc_out, "assoc_out", torch.int32, vmap_curr.shape[1:])
    index_maps = tuple(a for a in (assoc, assoc_out) if a is not None)
    kernels.on_cpu(vmap_curr, nmap_curr, model_rows, pose, *index_maps)  # one CUDA device
    kernels.launch(
        "icp_system", vmap_curr.device, vmap_curr, nmap_curr, model_rows, assoc, assoc_out, pose, scratch.partials,
        scratch.ticket, icp_blocks(vmap_curr[0].numel()), out, inliers, *(tail or (None, None, None)),
        kernels.f32(damping), bool(first), H, W,
        kernels.f32(intr.fx), kernels.f32(intr.fy), kernels.f32(intr.cx), kernels.f32(intr.cy),
        kernels.f32(dist_thres), kernels.f32(angle_thres), totals_out,
    )
    kernels.launch_counts["icp_system"] += 1


def icp_tail(totals: torch.Tensor, pose: torch.Tensor, out: torch.Tensor, inliers: torch.Tensor,
             pose_out: torch.Tensor, x_out: torch.Tensor, flags: torch.Tensor, damping: float, first: bool) -> None:
    """B19d, K4's tail as a launch of its own (``csrc/icp.cu::xs_icp_tail``):
    the system of ``totals`` (the 55 float64 sums of ``icp_system``, summed
    over the ranks) into ``out`` and ``inliers`` as float32 and int32, then
    the damping, the 6x6 dual solve and the pose update from ``pose`` into
    ``pose_out``, ``x_out`` and ``flags``, as the fused launch's tail does:
    each total rounded to float32 where it is read. CUDA tensors only (the
    CPU's sharded iteration runs :func:`icp_step_plain` on the summed
    system)."""
    kernels.check_tensor(totals, "totals", torch.float64, (ICP_SUMS,))
    for t, name in ((pose, "pose"), (pose_out, "pose_out")):
        kernels.check_tensor(t, name, torch.float32, (POSE_FLOATS,))
    kernels.check_tensor(out, "out", torch.float32, (84,))
    kernels.check_tensor(x_out, "x_out", torch.float32, (12,))
    kernels.check_tensor(flags, "flags", torch.int32, (2,))
    if kernels.on_cpu(totals, pose, out, pose_out, x_out, flags):
        raise ValueError("icp_tail launches K4's tail: its tensors must lie on a CUDA device")
    kernels.launch("icp_tail", totals.device, totals, pose, out, inliers, pose_out, x_out, flags,
                   kernels.f32(damping), bool(first))
    kernels.launch_counts["icp_tail"] += 1


def build_system(
    r_curr: CSFD,
    t_curr: CSFD,
    vmap_curr: torch.Tensor,
    nmap_curr: torch.Tensor,
    r_prev_inv: CSFD,
    t_prev: CSFD,
    intr: Intrinsics,
    vmap_g_prev: CSFD,
    nmap_g_prev: CSFD,
    dist_thres: float,
    angle_thres: float,
    assoc=None,
) -> IcpSystem:
    """One ICP iteration's normal equations: kernel K4 (``icp_system``
    without its tail) on CUDA tensors, :func:`build_system_plain` on CPU
    tensors. Same contract as the plain version; on CUDA ``assoc`` is
    ``None`` or the int32 index map of :func:`associate_index`."""
    maps = (vmap_curr, nmap_curr, vmap_g_prev.v, vmap_g_prev.g, nmap_g_prev.v, nmap_g_prev.g)
    if kernels.on_cpu(r_curr.v, t_curr.v, r_prev_inv.v, t_prev.v, *maps):
        return build_system_plain(
            r_curr, t_curr, vmap_curr, nmap_curr, r_prev_inv, t_prev, intr, vmap_g_prev, nmap_g_prev,
            dist_thres, angle_thres, assoc=assoc,
        )
    _check_model_maps(vmap_g_prev, nmap_g_prev)
    dev = vmap_curr.device
    out = torch.empty(84, dtype=torch.float32, device=dev)
    inliers = torch.empty((), dtype=torch.int32, device=dev)
    _launch_system(
        _icp_scratch(dev), vmap_curr, nmap_curr, pack_model_rows(vmap_g_prev, nmap_g_prev),
        vmap_g_prev.v.shape[-2:], assoc, pack_pose(r_curr, t_curr, r_prev_inv, t_prev), out, inliers, intr,
        dist_thres, angle_thres,
    )
    return _system_of(out, inliers)


def _check_model_maps(vmap_g_prev: CSFD, nmap_g_prev: CSFD) -> None:
    maps = (vmap_g_prev.v, vmap_g_prev.g, nmap_g_prev.v, nmap_g_prev.g)
    _check_maps(maps[0], maps, ("vmap_prev.v", "vmap_prev.g", "nmap_prev.v", "nmap_prev.g"))
    if any(m.shape != maps[0].shape for m in maps):
        raise ValueError("the previous model's maps must share one shape")


def _system_of(out: torch.Tensor, inliers: torch.Tensor) -> IcpSystem:
    A = CSFD(out[0:36].view(6, 6), out[36:72].view(6, 6))
    b = CSFD(out[72:78], out[78:84])
    return IcpSystem(A=A, b=b, inlier_count=inliers)


class IcpLoop:
    """One frame's ICP loop on the card. The pose lives in K4's scratch:
    every :meth:`iterate` is exactly one ``icp_system`` launch with its tail,
    which reads the pose from one buffer and writes the next pose into the
    other; with the cached association a level's first launch also writes
    the index map its later launches read. Nothing else runs on the device
    between them, and nothing is read back. :meth:`result` copies the
    outcome out of the scratch, which the next loop on this device and
    stream reuses.

    With ``reduce`` (B19d, the sharded engine) an iteration is instead an
    ``icp_system`` launch that writes its 55 double totals, ``reduce(totals)``
    (which sums them over the ranks in place), and :func:`icp_tail`."""

    def __init__(self, pose: torch.Tensor, reduce=None):
        """``pose``: the 36 floats of :func:`pack_pose` on a CUDA device."""
        if pose.device.type != "cuda":
            raise ValueError("IcpLoop drives the kernel: its pose must lie on a CUDA device")
        self._scratch = _icp_scratch(pose.device)
        self._scratch.pose[0].copy_(pose)
        self._cur = 0
        self._first = True
        self._reduce = reduce

    def iterate(self, vmap_curr, nmap_curr, model_rows, prev_shape, intr: Intrinsics, dist_thres: float,
                angle_thres: float, damping: float = 0.0, assoc=None, assoc_out=None) -> None:
        """One iteration: ``assoc`` is the cached index map to read, or
        ``None`` to project; ``assoc_out`` (int32, the current maps' (H, W)),
        given only with ``assoc=None``, receives the index map this launch
        makes at the pose it starts from: :func:`associate_index`'s map
        wherever the current normal is a number, −1 elsewhere."""
        s = self._scratch
        pose_in, pose_out = s.pose[self._cur], s.pose[1 - self._cur]
        if self._reduce is None:
            _launch_system(
                s, vmap_curr, nmap_curr, model_rows, prev_shape, assoc, pose_in, s.out, s.inliers, intr,
                dist_thres, angle_thres, tail=(pose_out, s.x, s.flags), damping=damping, first=self._first,
                assoc_out=assoc_out,
            )
        else:
            _launch_system(
                s, vmap_curr, nmap_curr, model_rows, prev_shape, assoc, pose_in, s.out, s.inliers, intr,
                dist_thres, angle_thres, assoc_out=assoc_out, totals_out=s.totals,
            )
            self._reduce(s.totals)
            icp_tail(s.totals, pose_in, s.out, s.inliers, pose_out, s.x, s.flags, damping, self._first)
        self._cur = 1 - self._cur
        self._first = False

    def result(self) -> IcpStep:
        """The last iteration's system and increment, the pose after it and
        whether every iteration of the loop solved."""
        s = self._scratch
        r_curr, t_curr = unpack_pose(s.pose[self._cur].clone())
        x = s.x.clone()
        return IcpStep(
            system=_system_of(s.out.clone(), s.inliers.clone()), r_curr=r_curr, t_curr=t_curr,
            x=CSFD(x[0:6], x[6:12]), ok=s.flags[1] != 0,
        )


def icp_step(
    r_curr: CSFD,
    t_curr: CSFD,
    vmap_curr: torch.Tensor,
    nmap_curr: torch.Tensor,
    r_prev_inv: CSFD,
    t_prev: CSFD,
    intr: Intrinsics,
    vmap_g_prev: CSFD,
    nmap_g_prev: CSFD,
    dist_thres: float,
    angle_thres: float,
    damping: float = 0.0,
    assoc=None,
) -> IcpStep:
    """One whole ICP iteration from a given pose: one launch of kernel K4
    with its tail on CUDA tensors; :func:`build_system_plain` and
    :func:`icp_step_plain` on CPU tensors."""
    maps = (vmap_curr, nmap_curr, vmap_g_prev.v, vmap_g_prev.g, nmap_g_prev.v, nmap_g_prev.g)
    if kernels.on_cpu(r_curr.v, t_curr.v, r_prev_inv.v, t_prev.v, *maps):
        system = build_system_plain(
            r_curr, t_curr, vmap_curr, nmap_curr, r_prev_inv, t_prev, intr, vmap_g_prev, nmap_g_prev,
            dist_thres, angle_thres, assoc=assoc,
        )
        return icp_step_plain(system, r_curr, t_curr, damping)
    _check_model_maps(vmap_g_prev, nmap_g_prev)
    loop = IcpLoop(pack_pose(r_curr, t_curr, r_prev_inv, t_prev))
    loop.iterate(
        vmap_curr, nmap_curr, pack_model_rows(vmap_g_prev, nmap_g_prev), vmap_g_prev.v.shape[-2:], intr,
        dist_thres, angle_thres, damping, assoc,
    )
    return loop.result()


def _gated_association(
    r_curr, t_curr, vmap_curr, nmap_curr, r_prev_inv, t_prev, intr, vmap_g_prev, nmap_g_prev,
    dist_thres, angle_thres, assoc=None,
):
    """The association (cached or computed here), the current vertices in the
    world, and the validity gates evaluated against the current pose, in the
    reference's order (ICP.cu:196-245)."""
    if assoc is None:
        assoc = associate(r_curr, t_curr, vmap_curr, r_prev_inv, t_prev, intr, vmap_g_prev, nmap_g_prev)
    elif isinstance(assoc, torch.Tensor):
        assoc = _association_from_index(assoc, vmap_g_prev, nmap_g_prev)
    nprev_g, vprev_g, in_img = assoc.nprev_g, assoc.vprev_g, assoc.in_img

    vcurr_g = _world_vertices(r_curr, t_curr, vmap_curr)
    dist = vec3.norm(vprev_g - vcurr_g)
    ncurr_g = vec3.matvec(r_curr, lift(nmap_curr))
    sine = vec3.norm(vec3.cross(ncurr_g, nprev_g))

    valid = (
        ~torch.isnan(nmap_curr[0])
        & in_img
        & ~torch.isnan(nprev_g.v[0])
        & (dist.v <= dist_thres)
        & (sine.v < angle_thres)
    )
    return assoc, vcurr_g, valid


def build_system_plain(
    r_curr: CSFD,
    t_curr: CSFD,
    vmap_curr: torch.Tensor,
    nmap_curr: torch.Tensor,
    r_prev_inv: CSFD,
    t_prev: CSFD,
    intr: Intrinsics,
    vmap_g_prev: CSFD,
    nmap_g_prev: CSFD,
    dist_thres: float,
    angle_thres: float,
    assoc=None,
) -> IcpSystem:
    """Plain version of K4: one ICP iteration's normal equations
    (``search_newton`` + ``combinedKernel``, ICP.cu:196-281), the port of
    ``xslam_tpu/ops/icp.py::build_system``.

    ``vmap_curr``/``nmap_curr`` are real (3, H, W) camera-space maps of the
    current frame; the previous-model maps are dual world-space maps from
    raycasting, and the projection bounds come from them.

    With ``assoc`` (an :class:`Association` or the int32 index map of
    :func:`associate_index`) the projection and gather are skipped and the
    cached correspondences used; the gates are still evaluated against the
    current pose."""
    assoc, vcurr_g, valid = _gated_association(
        r_curr, t_curr, vmap_curr, nmap_curr, r_prev_inv, t_prev, intr, vmap_g_prev, nmap_g_prev,
        dist_thres, angle_thres, assoc,
    )
    nprev_g, vprev_g = assoc.nprev_g, assoc.vprev_g

    n = nprev_g
    d = vprev_g
    s = vcurr_g
    row_rot = vec3.cross(s, n)  # (3, H, W) dual
    rhs = vec3.dot(n, d - s)  # (H, W) dual

    # mask invalid rows to zero (ICP.cu:260-261)
    def mask(x: CSFD, m) -> CSFD:
        return CSFD(
            torch.where(m, torch.nan_to_num(x.v), 0.0),
            torch.where(m, torch.nan_to_num(x.g), 0.0),
        )

    row_rot = mask(row_rot, valid[None])
    row_n = mask(n, valid[None])
    rhs = mask(rhs, valid)

    # J: (N, 6), r: (N, 1)
    J = CSFD(
        torch.cat([row_rot.v, row_n.v]).reshape(6, -1).T,
        torch.cat([row_rot.g, row_n.g]).reshape(6, -1).T,
    )
    r = CSFD(rhs.v.reshape(-1, 1), rhs.g.reshape(-1, 1))

    # block-pairwise accumulation: per-block JᵀJ partials, then a sum over
    # blocks, bounding the float32 accumulation error
    N = J.v.shape[0]
    n_blocks = max(1, N // 4096)
    while N % n_blocks:
        n_blocks -= 1
    Jb = CSFD(J.v.reshape(n_blocks, -1, 6), J.g.reshape(n_blocks, -1, 6))
    rb = CSFD(r.v.reshape(n_blocks, -1, 1), r.g.reshape(n_blocks, -1, 1))

    def bmm(a: CSFD, b: CSFD) -> CSFD:
        f = lambda x, y: torch.bmm(x.transpose(1, 2), y)  # noqa: E731
        return CSFD(f(a.v, b.v), f(a.g, b.v) + f(a.v, b.g))

    A = _block_sum(bmm(Jb, Jb))
    b = _block_sum(bmm(Jb, rb))
    b = CSFD(b.v[:, 0], b.g[:, 0])
    return IcpSystem(A=A, b=b, inlier_count=valid.sum())


def _block_sum(x: CSFD) -> CSFD:
    return CSFD(torch.sum(x.v, dim=0), torch.sum(x.g, dim=0))


def compute_optimize_matrix(
    r_curr: CSFD,
    t_curr: CSFD,
    vmap_curr: torch.Tensor,
    nmap_curr: torch.Tensor,
    r_prev_inv: CSFD,
    t_prev: CSFD,
    intr: Intrinsics,
    vmap_g_prev: CSFD,
    nmap_g_prev: CSFD,
    dist_thres: float,
    angle_thres: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Task-aware optimization hook: gradient of the point-to-plane loss
    w.r.t. the raw 3x4 pose matrix plus its 12x12 Gauss-Newton Hessian
    (``Combined::computeOptimizeMatrix``, ICP.cu:283-354, host reduction
    :431-490).

    Per correspondence (same association and gates as :func:`build_system`):
    ``L = sum ((M p0_h - p1) . n1)^2`` with ``p0_h = [p0, 1]``; the per-pixel
    Jacobian against entry ``M[i, j]`` is ``2 n1[i] proj p0_h[j]`` and the GN
    Hessian factorizes as ``2 J12^T J12`` with ``J12[p, 4i+j] = n1[i] p0_h[j]``.
    The two products are plain float32 matrix products, as in the JAX package.

    Returns (jacobi (3, 4), hessian (12, 12)), value lane."""
    assoc, vcurr_g, valid = _gated_association(
        r_curr, t_curr, vmap_curr, nmap_curr, r_prev_inv, t_prev, intr, vmap_g_prev, nmap_g_prev,
        dist_thres, angle_thres,
    )

    def masked(x):
        return torch.where(valid[None], torch.nan_to_num(x), 0.0)

    n1 = masked(assoc.nprev_g.v)  # (3, H, W)
    p1 = masked(assoc.vprev_g.v)
    p0t = masked(vcurr_g.v)
    ones = torch.where(valid, 1.0, 0.0)
    p0h = torch.cat([masked(vmap_curr), ones[None]])  # (4, H, W)

    proj = torch.sum((p0t - p1) * n1, dim=0)  # (H, W)

    # J12 rows n1[i] * p0h[j], flattened over pixels
    J12 = (n1[:, None] * p0h[None, :]).reshape(12, -1).T  # (N, 12)
    r = proj.reshape(-1, 1)
    jacobi = 2.0 * torch.matmul(J12.T, r).reshape(3, 4)
    hessian = 2.0 * torch.matmul(J12.T, J12)
    return jacobi, hessian


def solve_increment(system: IcpSystem, damping: float = 0.0) -> Tuple[CSFD, torch.Tensor]:
    """Solve the 6x6 dual system with the reference's degeneracy guard
    (|det| < 1e-15 or NaN -> fail, KinectFusionReconstruction.cpp:203-210).

    ``damping`` > 0 applies Levenberg-style scaled-diagonal damping
    ``A + damping * diag(A)``. Returns (x = [alpha beta gamma tx ty tz]
    dual, ok flag as a device boolean)."""
    if damping > 0.0:
        diag = torch.diagonal(system.A.v)
        system = IcpSystem(
            A=CSFD(system.A.v + damping * torch.diag(diag), system.A.g),
            b=system.b,
            inlier_count=system.inlier_count,
        )
    det = torch.linalg.det(system.A.v)
    ok = (torch.abs(det) >= 1e-15) & ~torch.isnan(det)
    eye = torch.eye(6, dtype=torch.float32, device=det.device)
    safe_A = CSFD(torch.where(ok, system.A.v, eye), torch.where(ok, system.A.g, 0.0))
    safe_b = CSFD(torch.where(ok, system.b.v, 0.0), torch.where(ok, system.b.g, 0.0))
    x = solve(safe_A, safe_b)
    x_ok = ~torch.any(torch.isnan(x.v))
    return CSFD(torch.nan_to_num(x.v), torch.nan_to_num(x.g)), ok & x_ok


def icp_step_plain(system: IcpSystem, r_curr: CSFD, t_curr: CSFD, damping: float = 0.0) -> IcpStep:
    """Plain version of K4's tail: solve the system, build the Euler
    increment ``Rz Ry Rx`` and left-multiply it onto the pose
    (KinectFusionReconstruction.cpp:212-224); where the step failed its guard
    the pose stays as it was."""
    x, ok = solve_increment(system, damping=damping)
    inc = se3.euler_xyz_increment(*(CSFD(x.v[i], x.g[i]) for i in range(6)))
    r_inc = se3.rotation(inc)
    t_new = se3.matvec(r_inc, t_curr) + se3.translation(inc)
    r_new = se3.matmul(r_inc, r_curr)
    return IcpStep(
        system=system,
        r_curr=CSFD(torch.where(ok, r_new.v, r_curr.v), torch.where(ok, r_new.g, r_curr.g)),
        t_curr=CSFD(torch.where(ok, t_new.v, t_curr.v), torch.where(ok, t_new.g, t_curr.g)),
        x=x, ok=ok,
    )
