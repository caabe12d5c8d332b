"""Shared helpers for the tests that hold the PyTorch port (``xslam_tpu_torch``)
against the JAX package on the CPU: config and dual-number conversion, and a
JAX engine run whose state is carried across as numpy arrays."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from xslam_tpu.csfd.single import CSFD as JCSFD
from xslam_tpu_torch.csfd.single import CSFD as TCSFD
from xslam_tpu_torch.io.config import SlamConfig as TorchSlamConfig

# One intra-op thread per test process: the suite runs six xdist workers
# beside XLA's own thread pools, and PyTorch's default pool (one thread per
# core) spinning against them made the port's tests about ten times slower
# in the full run than alone. The tests' tensors are small.
torch.set_num_threads(1)


def torch_config(cfg) -> TorchSlamConfig:
    """The port's SlamConfig with the same field values as a JAX one."""
    return TorchSlamConfig(**dataclasses.asdict(cfg))


def to_torch(x: JCSFD) -> TCSFD:
    return TCSFD(torch.from_numpy(np.array(x.v)), torch.from_numpy(np.array(x.g)))


def to_jax(x: TCSFD) -> JCSFD:
    return JCSFD(jnp.asarray(x.v.numpy()), jnp.asarray(x.g.numpy()))


def jax_state_to_numpy(state) -> dict:
    """A JAX ``SlamState`` in the exchange format of
    :func:`xslam_tpu_torch.utils.convert.state_from_numpy` (copies, so the
    JAX state may be donated afterwards)."""
    a = lambda x: np.array(x)  # noqa: E731
    return {
        "value": a(state.volume.value),
        "grad": a(state.volume.grad),
        "weight": a(state.volume.weight),
        "world2camera_v": a(state.world2camera.v),
        "world2camera_g": a(state.world2camera.g),
        "vmaps_v": [a(m.v) for m in state.vmaps_prev],
        "vmaps_g": [a(m.g) for m in state.vmaps_prev],
        "nmaps_v": [a(m.v) for m in state.nmaps_prev],
        "nmaps_g": [a(m.g) for m in state.nmaps_prev],
        "frame_idx": int(state.frame_idx),
        "last_align_ok": bool(state.last_align_ok),
        "t_prev": a(state.t_prev),
    }


def seeded_pose_direction(seed: int = 0, scale: float = 1e-2) -> np.ndarray:
    """A (4, 4) derivative lane for the initial world->camera pose: a small
    random rigid-motion direction (skew rotation part, free translation),
    so every dual lane downstream carries real values."""
    rng = np.random.default_rng(seed)
    w = scale * rng.standard_normal(3)
    g = np.zeros((4, 4), np.float32)
    g[:3, :3] = [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]
    g[:3, 3] = scale * rng.standard_normal(3)
    return g


def seed_jax_state(state, g: np.ndarray):
    """A JAX init state whose world->camera pose carries the derivative ``g``."""
    return state._replace(world2camera=JCSFD(state.world2camera.v, jnp.asarray(g)))


def frac_equal(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((a == b) | (np.isnan(a) & np.isnan(b))))


def paired_engine_runs(options: dict, n_frames: int) -> dict:
    """The JAX engine and the port's (on the CPU) over the first ``n_frames``
    frames of the small orbit (1 degree a frame) with the tests' small config
    and ``options``: each engine's poses, ``align_ok`` flags, ``t_prev`` after
    every frame, and model maps (level 0) after frame 0, as numpy arrays;
    with the ground truth, normalised to the first pose."""
    from tests.helpers import small_config, small_dataset
    from xslam_tpu.models.kinfu import XSlamEngine as JaxEngine
    from xslam_tpu.utils.evaluation import normalize_to_first
    from xslam_tpu_torch.models.kinfu import XSlamEngine as TorchEngine

    cfg = small_config(end_frame=n_frames, **options)
    ds = small_dataset(n_frames, degrees_per_frame=1.0)
    depths = [ds.get_depth(i) for i in range(n_frames)]
    out = {"gt": normalize_to_first([ds.get_pose(i) for i in range(n_frames)])}
    jeng = JaxEngine(cfg)
    state = jeng.init_state()
    run = dict(poses=[], ok=[], t_prev=[])
    for i in range(n_frames):
        state, res = jeng.process_frame(state, depths[i])
        run["poses"].append(np.array(res.camera2world.v))
        run["ok"].append(bool(res.align_ok))
        run["t_prev"].append(np.array(state.t_prev))
        if i == 0:
            run["maps"] = tuple(JCSFD(np.array(m.v), np.array(m.g)) for m in (state.vmaps_prev[0], state.nmaps_prev[0]))
    out["jax"] = run
    teng = TorchEngine(torch_config(cfg), device="cpu")
    state = teng.init_state()
    run = dict(poses=[], ok=[], t_prev=[])
    for i in range(n_frames):
        state, res = teng.process_frame(state, depths[i])
        run["poses"].append(res.camera2world.v.numpy().copy())
        run["ok"].append(bool(res.align_ok))
        run["t_prev"].append(state.t_prev.numpy().copy())
        if i == 0:
            run["maps"] = tuple(TCSFD(m.v.clone(), m.g.clone()) for m in (state.vmaps_prev[0], state.nmaps_prev[0]))
    out["port"] = run
    return out
