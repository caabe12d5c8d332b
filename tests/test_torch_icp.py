"""The port's ICP normal equations and 6x6 dual solve against xslam_tpu, on
model maps exported from the JAX engine after 2 frames (pose derivative
seeded, so both lanes carry values) and the third frame's depth pyramid.

Tolerance: A and b within rtol 1e-4 of each lane's largest entry (float32
sums over ~19k rows reduced in another order); inlier counts within 0.1%
(a pixel on a distance or angle gate may flip)."""

import jax
import numpy as np
import pytest
import torch

from tests.helpers import small_config, small_dataset
from tests.torch_port_helpers import seed_jax_state, seeded_pose_direction, to_torch
from xslam_tpu.geometry import se3 as jse3
from xslam_tpu.models.kinfu import XSlamEngine
from xslam_tpu.ops import icp as jicp
from xslam_tpu.ops import preprocess as jpre
from xslam_tpu_torch.geometry.intrinsics import Intrinsics
from xslam_tpu_torch.ops import icp as ticp

LEVELS = (2, 1, 0)


@pytest.fixture(scope="module")
def icp_inputs():
    cfg = small_config()
    ds = small_dataset(3, degrees_per_frame=1.0)
    engine = XSlamEngine(cfg)
    state = seed_jax_state(engine.init_state(), seeded_pose_direction(1))
    for i in range(2):
        state, _ = engine.process_frame(state, ds.get_depth(i))
    d0 = jax.jit(jpre.bilateral_filter)(jax.numpy.asarray(ds.get_depth(2)))
    depths = [d0, jpre.pyr_down(d0)]
    depths.append(jpre.pyr_down(depths[-1]))
    vmaps = [jpre.create_vmap(engine.intr.level(i), depths[i]) for i in range(3)]
    nmaps = [jpre.create_nmap(v) for v in vmaps]
    c2w_prev = jse3.inverse(state.world2camera)
    poses = dict(
        r_curr=jse3.rotation(c2w_prev), t_curr=jse3.translation(c2w_prev),
        r_prev_inv=jse3.rotation(state.world2camera), t_prev=jse3.translation(c2w_prev),
    )
    return cfg, engine.intr, state, vmaps, nmaps, poses


_jbuild = jax.jit(jicp.build_system, static_argnames=("intr", "dist_thres", "angle_thres"))


@pytest.fixture(scope="module")
def systems(icp_inputs):
    """(JAX system, port system) per pyramid level."""
    return {level: _systems(icp_inputs, level) for level in LEVELS}


def _systems(icp_inputs, level):
    cfg, intr, state, vmaps, nmaps, p = icp_inputs
    args = (p["r_curr"], p["t_curr"], vmaps[level], nmaps[level], p["r_prev_inv"], p["t_prev"])
    js = _jbuild(
        *args, intr=intr.level(level), vmap_g_prev=state.vmaps_prev[level], nmap_g_prev=state.nmaps_prev[level],
        dist_thres=cfg.dist_thres, angle_thres=cfg.angle_thres_sine,
    )
    targs = [to_torch(a) if hasattr(a, "g") else torch.from_numpy(np.array(a)) for a in args]
    ts = ticp.build_system(
        *targs[:6], Intrinsics(*intr.level(level)), to_torch(state.vmaps_prev[level]),
        to_torch(state.nmaps_prev[level]), cfg.dist_thres, cfg.angle_thres_sine,
    )
    return js, ts


def _lane_close(t, j):
    t, j = t.numpy(), np.asarray(j)
    assert np.abs(j).max() > 0
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4 * np.abs(j).max())


@pytest.mark.parametrize("level", LEVELS)
def test_build_system(icp_inputs, systems, level):
    js, ts = systems[level]
    for name in ("A", "b"):
        _lane_close(getattr(ts, name).v, getattr(js, name).v)
        _lane_close(getattr(ts, name).g, getattr(js, name).g)
    jn, tn = int(js.inlier_count), int(ts.inlier_count)
    assert jn > 0.25 * icp_inputs[3][level][0].size  # a real overlap, not a degenerate system
    assert abs(jn - tn) <= max(1, 1e-3 * jn)


@pytest.mark.parametrize("level", LEVELS)
def test_solve_increment(systems, level):
    js, ts = systems[level]
    jx, jok = jicp.solve_increment(js)
    tx, tok = ticp.solve_increment(ts)
    assert bool(jok) and bool(tok)
    np.testing.assert_allclose(tx.v.numpy(), np.asarray(jx.v), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(tx.g.numpy(), np.asarray(jx.g), rtol=1e-3, atol=1e-3 * np.abs(np.asarray(jx.g)).max())


def test_degenerate_system_fails_guard():
    """No correspondences: det = 0 -> the reference's guard rejects the step."""
    from xslam_tpu_torch.csfd.single import CSFD

    z = torch.zeros((6, 6))
    system = ticp.IcpSystem(A=CSFD(z, z), b=CSFD(torch.zeros(6), torch.zeros(6)), inlier_count=torch.tensor(0))
    x, ok = ticp.solve_increment(system)
    assert not bool(ok)
    assert torch.all(x.v == 0)
