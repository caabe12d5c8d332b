"""The port's ICP normal equations and 6x6 dual solve against xslam_tpu, on
model maps exported from the JAX engine after 2 frames (pose derivative
seeded, so both lanes carry values) and the third frame's depth pyramid.

Tolerance: A and b within rtol 1e-4 of each lane's largest entry (float32
sums over ~19k rows reduced in another order); inlier counts within 0.1%
(a pixel on a distance or angle gate may flip). The same holds with the
association cached (the port's int32 index map against the JAX package's
gathered rows), also after the pose has moved, and for
``compute_optimize_matrix`` (rtol 1e-4 of the largest entry)."""

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
from xslam_tpu_torch.utils.convert import association_from_numpy

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
    args, jkw, targs, tkw = _level_args(icp_inputs, level)
    return _jbuild(*args, **jkw), ticp.build_system(*targs, **tkw)


def _level_args(icp_inputs, level):
    """(JAX args, port args) of one level: the six pose and current-map
    arguments, then intr, previous maps and thresholds by keyword."""
    cfg, intr, state, vmaps, nmaps, p = icp_inputs
    args = (p["r_curr"], p["t_curr"], vmaps[level], nmaps[level], p["r_prev_inv"], p["t_prev"])
    jkw = dict(intr=intr.level(level), vmap_g_prev=state.vmaps_prev[level], nmap_g_prev=state.nmaps_prev[level],
               dist_thres=cfg.dist_thres, angle_thres=cfg.angle_thres_sine)
    targs = [to_torch(a) if hasattr(a, "g") else torch.from_numpy(np.array(a)) for a in args]
    tkw = dict(intr=Intrinsics(*intr.level(level)), vmap_g_prev=to_torch(state.vmaps_prev[level]),
               nmap_g_prev=to_torch(state.nmaps_prev[level]), dist_thres=cfg.dist_thres,
               angle_thres=cfg.angle_thres_sine)
    return args, jkw, targs, tkw


def _moved(r, t, seed):
    """A pose a small seeded rigid motion away (value lane; the derivative
    lane is carried along), for the JAX and the port's CSFD alike."""
    rng = np.random.default_rng(seed)
    w = 2e-3 * rng.standard_normal(3)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], np.float32)
    dR = np.eye(3, dtype=np.float32) + K
    dt = (2e-3 * rng.standard_normal(3)).astype(np.float32)
    rv, rg, tv, tg = (np.asarray(x, np.float32) for x in (r.v, r.g, t.v, t.g))
    return (dR @ rv, dR @ rg), (dR @ tv + dt, dR @ tg)


def _assert_systems_close(ts, js, min_inliers):
    for name in ("A", "b"):
        _lane_close(getattr(ts, name).v, getattr(js, name).v)
        _lane_close(getattr(ts, name).g, getattr(js, name).g)
    jn, tn = int(js.inlier_count), int(ts.inlier_count)
    assert jn > min_inliers  # a real overlap, not a degenerate system
    assert abs(jn - tn) <= max(1, 1e-3 * jn)


@pytest.mark.parametrize("moved", [False, True], ids=["same_pose", "moved_pose"])
@pytest.mark.parametrize("level", LEVELS)
def test_build_system_cached_association(icp_inputs, level, moved):
    """The association is made at the level's starting pose and cached; the
    system is then built at that pose or at a moved one, where the cached
    gates must be evaluated again."""
    from xslam_tpu.csfd.single import CSFD as JCSFD
    from xslam_tpu_torch.csfd.single import CSFD as TCSFD

    args, jkw, targs, tkw = _level_args(icp_inputs, level)
    jassoc = jicp.associate(args[0], args[1], args[2], args[4], args[5], jkw["intr"], jkw["vmap_g_prev"],
                            jkw["nmap_g_prev"])
    tindex = ticp.associate_index(targs[0], targs[1], targs[2], targs[4], targs[5], tkw["intr"],
                                  tkw["vmap_g_prev"].v.shape[-2:])
    assert tindex.dtype == torch.int32 and tuple(tindex.shape) == tuple(targs[2].shape[1:])
    np.testing.assert_array_equal(tindex.numpy() >= 0, np.asarray(jassoc.in_img))
    if moved:
        (rv, rg), (tv, tg) = _moved(args[0], args[1], seed=level)
        args = (JCSFD(jax.numpy.asarray(rv), jax.numpy.asarray(rg)),
                JCSFD(jax.numpy.asarray(tv), jax.numpy.asarray(tg))) + args[2:]
        targs = [TCSFD(torch.from_numpy(rv), torch.from_numpy(rg)),
                 TCSFD(torch.from_numpy(tv), torch.from_numpy(tg))] + targs[2:]
    js = _jbuild(*args, **jkw, assoc=jassoc)
    ts = ticp.build_system(*targs, **tkw, assoc=tindex)
    _assert_systems_close(ts, js, 0.25 * icp_inputs[3][level][0].size * (0.5 if moved else 1.0))
    if moved:  # the moved pose changed the system: the gates and rows were re-evaluated
        js0 = _jbuild(*_level_args(icp_inputs, level)[0], **jkw, assoc=jassoc)
        assert np.abs(np.asarray(js.b.v) - np.asarray(js0.b.v)).max() > 1e-3 * np.abs(np.asarray(js0.b.v)).max()

    # the JAX package's own cache form (gathered rows), carried across as numpy
    tassoc = association_from_numpy(
        *(np.array(x) for x in (jassoc.nprev_g.v, jassoc.nprev_g.g, jassoc.vprev_g.v, jassoc.vprev_g.g,
                                  jassoc.in_img)), "cpu")
    ts_rows = ticp.build_system_plain(*targs, **tkw, assoc=tassoc)
    _assert_systems_close(ts_rows, js, 0)


@pytest.mark.parametrize("level", LEVELS)
def test_compute_optimize_matrix(icp_inputs, level):
    args, jkw, targs, tkw = _level_args(icp_inputs, level)
    jj, jh = jax.jit(jicp.compute_optimize_matrix, static_argnames=("intr", "dist_thres", "angle_thres"))(
        *args, **jkw)
    tj, th = ticp.compute_optimize_matrix(*targs, **tkw)
    assert tuple(tj.shape) == (3, 4) and tuple(th.shape) == (12, 12)
    _lane_close(tj, jj)
    _lane_close(th, jh)


def test_cpu_wrappers_launch_nothing(icp_inputs):
    """On CPU tensors the K4 wrappers run the plain versions."""
    from xslam_tpu_torch.ops import kernels

    _, _, targs, tkw = _level_args(icp_inputs, 2)
    before = dict(kernels.launch_counts)
    ticp.build_system(*targs, **tkw)
    ticp.associate_index(targs[0], targs[1], targs[2], targs[4], targs[5], tkw["intr"], (30, 40))
    assert kernels.launch_counts == before
    assert before["icp_system"] == 0 and before["icp_associate"] == 0


def _lane_close(t, j):
    t, j = t.numpy(), np.asarray(j)
    assert np.abs(j).max() > 0
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4 * np.abs(j).max())


@pytest.mark.parametrize("level", LEVELS)
def test_build_system(icp_inputs, systems, level):
    js, ts = systems[level]
    _assert_systems_close(ts, js, 0.25 * icp_inputs[3][level][0].size)


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
