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
