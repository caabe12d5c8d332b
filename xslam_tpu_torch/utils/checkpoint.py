"""Checkpoint / resume of the full SLAM state.

Port of ``xslam_tpu/utils/checkpoint.py``, with its ``.npz`` keys, so a
checkpoint written by either package loads in the other. The reference only
has write-only TSDF dumps (``saveTSDFVolume``,
KinectFusionReconstruction.cpp:438-447) and per-frame pose text files, with
no load path. Here: the engine state (volume value/grad/weight, dense
``(X, Y, Z)`` planes or the brick layout's ``(NB, 512)`` rows, dual pose,
model-map pyramid, frame index, alignment flag, the temporal march's
anchors) and the pose log, so a run can resume mid-sequence.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from ..csfd.single import CSFD
from ..models.kinfu import SlamState, _device
from ..ops.bricks import BrickVolume
from ..ops.fusion import VolumeState


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_state(path: str, state: SlamState, pose_log: List[np.ndarray] | None = None):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {
        "value": _host(state.volume.value),
        "grad": _host(state.volume.grad),
        "weight": _host(state.volume.weight),
        "w2c_v": _host(state.world2camera.v),
        "w2c_g": _host(state.world2camera.g),
        "frame_idx": np.int32(state.frame_idx),
        "last_align_ok": np.bool_(_host(torch.as_tensor(state.last_align_ok))),
        "n_levels": np.int32(len(state.vmaps_prev)),
        "t_prev": _host(state.t_prev),
        "pose_log": np.stack(pose_log) if pose_log else np.zeros((0, 4, 4), np.float32),
    }
    for i, (vm, nm) in enumerate(zip(state.vmaps_prev, state.nmaps_prev)):
        payload[f"vm{i}_v"] = _host(vm.v)
        payload[f"vm{i}_g"] = _host(vm.g)
        payload[f"nm{i}_v"] = _host(nm.v)
        payload[f"nm{i}_g"] = _host(nm.g)
    np.savez(path, **payload)


def load_state(path: str, device=None) -> Tuple[SlamState, List[np.ndarray]]:
    """The state and the pose log of a checkpoint, the state on ``device``:
    the card by default, as the JAX package loads onto its accelerator
    (``RuntimeError`` where CUDA is missing; ``device="cpu"`` for the CPU).
    A checkpoint without ``t_prev`` (written before the temporal march's
    anchors were saved) gets an all-inf anchor map, the cold anchor that
    makes the next frame refresh."""
    device = _device(device, "load_state")
    z = np.load(path if path.endswith(".npz") else path + ".npz")

    def t(key):
        return torch.as_tensor(np.ascontiguousarray(z[key]), device=device)

    levels = int(z["n_levels"])
    vmaps = tuple(CSFD(t(f"vm{i}_v"), t(f"vm{i}_g")) for i in range(levels))
    nmaps = tuple(CSFD(t(f"nm{i}_v"), t(f"nm{i}_g")) for i in range(levels))
    layout = BrickVolume if z["value"].ndim == 2 else VolumeState  # brick rows (NB, 512), else (X, Y, Z)
    state = SlamState(
        volume=layout(value=t("value"), grad=t("grad"), weight=t("weight")),
        world2camera=CSFD(t("w2c_v"), t("w2c_g")),
        vmaps_prev=vmaps,
        nmaps_prev=nmaps,
        frame_idx=int(z["frame_idx"]),
        last_align_ok=torch.as_tensor(bool(z["last_align_ok"]), device=device),
        t_prev=t("t_prev") if "t_prev" in z.files
        else torch.full(tuple(vmaps[0].v.shape[-2:]), torch.inf, dtype=torch.float32, device=device),
    )
    return state, list(z["pose_log"])


def save_tsdf_volume(path: str, state: SlamState):
    """Raw float TSDF dump, same payload as the reference's
    ``saveTSDFVolume`` (value plane only) but with the correct size."""
    _host(state.volume.value).astype(np.float32).tofile(path)
