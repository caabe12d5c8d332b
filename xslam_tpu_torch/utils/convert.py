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
"""

from __future__ import annotations

import numpy as np
import torch

from ..csfd.double import DCSFD
from ..csfd.single import CSFD
from ..models.kinfu import SlamState
from ..models.odometry import OdometryState
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
