"""Carry a SLAM state between the JAX engine and the port as numpy arrays.

SLAM has no weights: the state (volume, pose, model maps) is what both
engines must share. The exchange format is a dict of numpy arrays:

- ``value``, ``grad``, ``weight``: (X, Y, Z) float32 volume planes;
- ``world2camera_v``, ``world2camera_g``: (4, 4) float32;
- ``vmaps_v``, ``vmaps_g``, ``nmaps_v``, ``nmaps_g``: lists over pyramid
  levels of (3, H >> l, W >> l) float32 maps;
- ``frame_idx`` (int), ``last_align_ok`` (bool), ``t_prev`` ((H, W) float32).

A JAX ``SlamState`` is written into this format with ``np.asarray`` on each
leaf (the JAX engine donates its state to the next step, so convert it
before that step).
"""

from __future__ import annotations

import numpy as np
import torch

from ..csfd.single import CSFD
from ..models.kinfu import SlamState
from ..ops.fusion import VolumeState


def state_from_numpy(d: dict, device) -> SlamState:
    """Build the port's :class:`SlamState` on ``device`` from numpy arrays."""

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)

    def maps(key):
        return tuple(CSFD(t(v), t(g)) for v, g in zip(d[f"{key}_v"], d[f"{key}_g"]))

    return SlamState(
        volume=VolumeState(value=t(d["value"]), grad=t(d["grad"]), weight=t(d["weight"])),
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
