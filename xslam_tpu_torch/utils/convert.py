"""Carry a SLAM state between the JAX engine and the port as numpy arrays.

SLAM has no weights: the state (volume, pose, model maps) is what both
engines must share. The exchange format is a dict of numpy arrays:

- ``value``, ``grad``, ``weight``: (X, Y, Z) float32 volume planes, or for
  the brick layout (``volume_layout="brick"``) its (NB, 512) float32 brick
  rows, which cross as they are;
- ``world2camera_v``, ``world2camera_g``: (4, 4) float32;
- ``vmaps_v``, ``vmaps_g``, ``nmaps_v``, ``nmaps_g``: lists over pyramid
  levels ``l`` of (3, H >> (l + L), W >> (l + L)) float32 maps, ``L`` the
  configuration's ``model_map_level``;
- ``frame_idx`` (int), ``last_align_ok`` (bool), ``t_prev``
  ((H >> L, W >> L) float32: the last raycast's hit distances, 1e9 where a
  ray found nothing, carried as they are).

A JAX ``SlamState`` is written into this format with ``np.asarray`` on each
leaf (the JAX engine donates its state to the next step, so convert it
before that step).

An ICP ``Association`` of the JAX package (its cache of gathered rows)
crosses as the numpy arrays of its leaves (:func:`association_from_numpy`);
an ``IcpSystem`` needs no converter, the tests compare its leaves as numpy.

A hyper-dual number (``DCSFD``) crosses as the tuple of its four lanes'
arrays (``v``, ``e1``, ``e2``, ``e12``); the frame-to-frame odometry's state
as a dict: ``world2camera_v``/``_g`` and ``prev_c2w_v``/``_g`` ((4, 4)
float32), ``vmaps`` and ``nmaps`` (lists over levels of real (3, H >> l,
W >> l) float32 camera-space maps) and ``frame_idx`` (int); a relocalization
result as a dict of ``xi`` ((6,) float32), ``loss_history`` ((iters + 1,)
float32) and ``count`` (int).

A frame's result crosses as a dict (:func:`frame_result_to_numpy`, for
either package's ``FrameResult``): ``camera2world_v``, ``camera2world_g``
((4, 4) float32), ``align_ok``, ``inlier_count``, ``fusion_overflow``, and
where the port's result has them ``fusion_active`` and ``anchor_coverage``;
a result of ``process_frames`` keeps its leading K axis on every entry
((K, 4, 4), (K,)), so a stack of K frames compares with K single frames.

The backend's results cross as dicts of arrays: a ``BAProblem``, a
``BAResult`` and a ``PoseGraphResult`` (their fields), and a
``RecoveringEngine``'s host record (keyframes, events, loop edges, pose
log and its motion model: :func:`recovery_record_to_numpy`), so a JAX
run's backend state can be refined in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from ..csfd.double import DCSFD
from ..csfd.single import CSFD
from ..models.ba import BAProblem, BAResult, PoseGraphResult
from ..models.kinfu import SlamState
from ..models.odometry import OdometryState
from ..models.recovery import Keyframe, RecoveringEngine, RecoveryEvent
from ..models.relocalize import RelocResult
from ..ops.bricks import BrickVolume
from ..ops.fusion import VolumeState
from ..ops.icp import Association


def state_from_numpy(d: dict, device) -> SlamState:
    """Build the port's :class:`SlamState` on ``device`` from numpy arrays: a
    dense volume from (X, Y, Z) planes, a :class:`BrickVolume` from (NB, 512)
    rows."""

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)

    def maps(key):
        return tuple(CSFD(t(v), t(g)) for v, g in zip(d[f"{key}_v"], d[f"{key}_g"]))

    layout = BrickVolume if np.ndim(d["value"]) == 2 else VolumeState
    return SlamState(
        volume=layout(value=t(d["value"]), grad=t(d["grad"]), weight=t(d["weight"])),
        world2camera=CSFD(t(d["world2camera_v"]), t(d["world2camera_g"])),
        vmaps_prev=maps("vmaps"),
        nmaps_prev=maps("nmaps"),
        frame_idx=int(d["frame_idx"]),
        last_align_ok=torch.as_tensor(bool(d["last_align_ok"]), device=device),
        t_prev=t(d["t_prev"]),
    )


def state_to_numpy(state: SlamState) -> dict:
    """The inverse of :func:`state_from_numpy`."""

    def n(x):
        return x.detach().cpu().numpy()

    return {
        "value": n(state.volume.value),
        "grad": n(state.volume.grad),
        "weight": n(state.volume.weight),
        "world2camera_v": n(state.world2camera.v),
        "world2camera_g": n(state.world2camera.g),
        "vmaps_v": [n(m.v) for m in state.vmaps_prev],
        "vmaps_g": [n(m.g) for m in state.vmaps_prev],
        "nmaps_v": [n(m.v) for m in state.nmaps_prev],
        "nmaps_g": [n(m.g) for m in state.nmaps_prev],
        "frame_idx": int(state.frame_idx),
        "last_align_ok": bool(state.last_align_ok),
        "t_prev": n(state.t_prev),
    }


def _dual(v, g, device) -> CSFD:
    return CSFD(torch.as_tensor(np.ascontiguousarray(v, np.float32), device=device),
                torch.as_tensor(np.ascontiguousarray(g, np.float32), device=device))


def association_from_numpy(nprev_v, nprev_g, vprev_v, vprev_g, in_img, device) -> Association:
    """The port's :class:`Association` from the leaves of a JAX one."""
    return Association(
        nprev_g=_dual(nprev_v, nprev_g, device), vprev_g=_dual(vprev_v, vprev_g, device),
        in_img=torch.as_tensor(np.ascontiguousarray(in_img, bool), device=device),
    )



def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)


def _n(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def dcsfd_from_numpy(lanes, device) -> DCSFD:
    """A :class:`DCSFD` on ``device`` from its four lanes (v, e1, e2, e12)."""
    return DCSFD(*(_t(x, device) for x in lanes))


def dcsfd_to_numpy(x: DCSFD) -> tuple:
    return tuple(_n(a) for a in x)


def odometry_state_from_numpy(d: dict, device) -> OdometryState:
    return OdometryState(
        world2camera=CSFD(_t(d["world2camera_v"], device), _t(d["world2camera_g"], device)),
        vmaps_prev=tuple(_t(m, device) for m in d["vmaps"]),
        nmaps_prev=tuple(_t(m, device) for m in d["nmaps"]),
        prev_c2w=CSFD(_t(d["prev_c2w_v"], device), _t(d["prev_c2w_g"], device)),
        frame_idx=int(d["frame_idx"]),
    )


def odometry_state_to_numpy(state: OdometryState) -> dict:
    """The inverse of :func:`odometry_state_from_numpy`."""
    return {
        "world2camera_v": _n(state.world2camera.v), "world2camera_g": _n(state.world2camera.g),
        "vmaps": [_n(m) for m in state.vmaps_prev], "nmaps": [_n(m) for m in state.nmaps_prev],
        "prev_c2w_v": _n(state.prev_c2w.v), "prev_c2w_g": _n(state.prev_c2w.g),
        "frame_idx": int(state.frame_idx),
    }


def reloc_result_from_numpy(d: dict, device) -> RelocResult:
    return RelocResult(xi=_t(d["xi"], device), loss_history=_t(d["loss_history"], device),
                       count=torch.as_tensor(int(d["count"]), dtype=torch.int32, device=device))


def reloc_result_to_numpy(result: RelocResult) -> dict:
    return {"xi": _n(result.xi), "loss_history": _n(result.loss_history), "count": int(result.count)}


# ---------------------------------------------------------------- the backend
def _host(x) -> np.ndarray:
    """A tensor's or a JAX array's values as a numpy array of their own."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.array(x)


def frame_result_to_numpy(result) -> dict:
    """A ``FrameResult`` of either package, one frame's or ``process_frames``'
    (leading K axis), as a dict of numpy arrays; the port's optional fields
    where they are not None."""
    out = {
        "camera2world_v": _host(result.camera2world.v),
        "camera2world_g": _host(result.camera2world.g),
        "align_ok": _host(result.align_ok),
        "inlier_count": _host(result.inlier_count),
        "fusion_overflow": _host(result.fusion_overflow),
    }
    for name in ("fusion_active", "anchor_coverage"):
        if getattr(result, name, None) is not None:
            out[name] = _host(getattr(result, name))
    return out


def ba_problem_to_numpy(problem) -> dict:
    """A ``BAProblem`` (of either package: its fields read with ``np.asarray``
    after a move to the host) as a dict of arrays: ``frame_idx``,
    ``anchor_idx`` ((N,) int32), ``meas_cam`` ((N, 3) float32) and, where
    present, ``meas_normal`` ((N, 3)) and ``obs_weight`` ((N,))."""
    out = {}
    for key in BAProblem._fields:
        value = getattr(problem, key)
        if value is not None:
            out[key] = _host(value)
    return out


def ba_problem_from_numpy(d: dict, device) -> BAProblem:
    def get(key, dtype):
        return None if d.get(key) is None else torch.as_tensor(np.ascontiguousarray(d[key], dtype), device=device)

    return BAProblem(frame_idx=get("frame_idx", np.int32), anchor_idx=get("anchor_idx", np.int32),
                     meas_cam=get("meas_cam", np.float32), meas_normal=get("meas_normal", np.float32),
                     obs_weight=get("obs_weight", np.float32))


def ba_result_to_numpy(result) -> dict:
    """A ``BAResult`` as ``poses`` (K, 6), ``anchors`` (L, 3) and
    ``residual_history`` (iters,) arrays."""
    return {key: _host(getattr(result, key)) for key in BAResult._fields}


def ba_result_from_numpy(d: dict, device) -> BAResult:
    return BAResult(*(_t(d[key], device) for key in BAResult._fields))


def pose_graph_result_to_numpy(result) -> dict:
    """A ``PoseGraphResult`` as ``poses`` (K, 6) and ``residual_history``."""
    return {key: _host(getattr(result, key)) for key in PoseGraphResult._fields}


def pose_graph_result_from_numpy(d: dict, device) -> PoseGraphResult:
    return PoseGraphResult(*(_t(d[key], device) for key in PoseGraphResult._fields))


def recovery_record_to_numpy(engine) -> dict:
    """A ``RecoveringEngine``'s host record (of either package: its fields
    are host data in both) as a dict: ``pose_log`` (list of (4, 4)),
    ``keyframes`` (list of ``(frame_index, camera2world, depth_u16 or
    None)``), ``recovery_events`` (list of the events' five fields),
    ``loop_edges`` (list of ``(i, j, T)``), ``last_good`` (``None`` or
    ``(frame_index, c2w)``), ``vel`` (``None`` or (4, 4)), ``fail_streak``,
    ``frame_index`` (int) and ``pending_loop`` (bool). Copies."""
    copy = lambda x: None if x is None else np.array(x)  # noqa: E731
    last = engine._last_good
    return {
        "pose_log": [np.array(p) for p in engine.pose_log],
        "keyframes": [(int(k.frame_index), np.array(k.camera2world), copy(k.depth_u16)) for k in engine.keyframes],
        "recovery_events": [(int(e.frame_index), bool(e.accepted), float(e.mean_loss_before),
                             float(e.mean_loss_after), float(e.pose_jump_m)) for e in engine.recovery_events],
        "loop_edges": [(int(i), int(j), np.array(T)) for i, j, T in engine.loop_edges],
        "last_good": None if last is None else (int(last[0]), np.array(last[1])),
        "vel": copy(engine._vel),
        "fail_streak": int(engine._fail_streak),
        "frame_index": int(engine._frame_index),
        "pending_loop": bool(engine._pending_loop),
    }


def recovery_record_from_numpy(engine: RecoveringEngine, d: dict) -> RecoveringEngine:
    """Set the port's ``RecoveringEngine``'s host record from the dict of
    :func:`recovery_record_to_numpy`; returns the engine."""
    engine.pose_log = [np.array(p) for p in d["pose_log"]]
    engine.keyframes = [Keyframe(i, np.array(c2w), None if depth is None else np.array(depth))
                        for i, c2w, depth in d["keyframes"]]
    engine.recovery_events = [RecoveryEvent(*e) for e in d["recovery_events"]]
    engine.loop_edges = [(i, j, np.array(T)) for i, j, T in d["loop_edges"]]
    engine._last_good = None if d["last_good"] is None else (d["last_good"][0], np.array(d["last_good"][1]))
    engine._vel = None if d["vel"] is None else np.array(d["vel"])
    engine._fail_streak = d["fail_streak"]
    engine._frame_index = d["frame_index"]
    engine._pending_loop = d["pending_loop"]
    return engine
