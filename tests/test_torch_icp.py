"""The port's ICP normal equations and 6x6 dual solve against xslam_tpu, on
model maps exported from the JAX engine after 2 frames (pose derivative
seeded, so both lanes carry values) and the third frame's depth pyramid.

Tolerance: A and b within rtol 1e-4 of each lane's largest entry (float32
sums over ~19k rows reduced in another order); inlier counts within 0.1%
(a pixel on a distance or angle gate may flip). The same holds with the
association cached (the port's int32 index map against the JAX package's
gathered rows), also after the pose has moved, and for
``compute_optimize_matrix`` (rtol 1e-4 of the largest entry).

The rest of an ICP iteration (``icp_step_plain``, the plain version of K4's
tail: damping, solve, Euler increment, pose update) is held against the JAX
package's ``solve_increment`` + ``euler_xyz_increment`` + composition on the
SAME system (the JAX one, carried across as numpy), so only that arithmetic
differs: ``x`` within rtol 1e-3 (the ICP matrix is ill-conditioned and the
two LAPACKs pivot alike but round in another order), the pose within 2e-5
(``x`` is of order 1e-2) and its derivative lane within 1e-3 of its largest
entry."""

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


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("level", LEVELS)
def test_cached_association_at_its_own_pose_is_the_projection(icp_inputs, level):
    """What lets the card fold the association into a level's first ICP
    launch: at the pose the association is made at, the system built from
    the cached association is the system built by projecting, bit for bit, in
    both packages (JAX run eagerly, one operation at a time, so no fusion
    rounds the two programs apart). In the port's index form this holds also
    with -1 stored wherever the current normal is NaN, as the folded launch
    stores it."""
    args, jkw, targs, tkw = _level_args(icp_inputs, level)
    jassoc = jicp.associate(args[0], args[1], args[2], args[4], args[5], jkw["intr"], jkw["vmap_g_prev"],
                            jkw["nmap_g_prev"])
    j_cached, j_projected = jicp.build_system(*args, **jkw, assoc=jassoc), jicp.build_system(*args, **jkw)
    index = ticp.associate_index_plain(targs[0], targs[1], targs[2], targs[4], targs[5], tkw["intr"],
                                       tkw["vmap_g_prev"].v.shape[-2:])
    folded = torch.where(torch.isnan(targs[3][0]), -1, index).to(torch.int32)
    assert bool((folded != index).any())  # some pixel without a normal projects into the image
    t_projected = ticp.build_system_plain(*targs, **tkw)
    for name in ("A", "b"):
        for lane in ("v", "g"):
            want = _bits(getattr(getattr(j_projected, name), lane))
            np.testing.assert_array_equal(_bits(getattr(getattr(j_cached, name), lane)), want)
            want = _bits(getattr(getattr(t_projected, name), lane).numpy())
            for cached in (index, folded):
                got = getattr(getattr(ticp.build_system_plain(*targs, **tkw, assoc=cached), name), lane)
                np.testing.assert_array_equal(_bits(got.numpy()), want)
    assert int(j_cached.inlier_count) == int(j_projected.inlier_count) > 0
    assert int(t_projected.inlier_count) > 0


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


# --- the rest of an iteration: icp_step_plain (plain version of K4's tail) ---
def _jax_step(js, r_curr, t_curr, damping):
    """One pose update as xslam_tpu/models/kinfu.py::_pose_estimate's body."""
    from xslam_tpu.csfd.single import CSFD as JCSFD

    x, ok = jicp.solve_increment(js, damping=damping)
    inc = jse3.euler_xyz_increment(*(JCSFD(x.v[i], x.g[i]) for i in range(6)))
    r_inc = jse3.rotation(inc)
    t_new = jse3.matvec(r_inc, t_curr) + jse3.translation(inc)
    r_new = jse3.matmul(r_inc, r_curr)
    return x, ok, r_new, t_new


def _port_system(js):
    from xslam_tpu_torch.csfd.single import CSFD

    n = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return ticp.IcpSystem(A=CSFD(n(js.A.v), n(js.A.g)), b=CSFD(n(js.b.v), n(js.b.g)),
                          inlier_count=torch.tensor(int(js.inlier_count)))


@pytest.mark.parametrize("damping", [0.0, 1e-3], ids=["undamped", "damped"])
@pytest.mark.parametrize("level", LEVELS)
def test_icp_step_plain(icp_inputs, systems, level, damping):
    js, _ = systems[level]
    p = icp_inputs[5]
    jx, jok, jr, jt = _jax_step(js, p["r_curr"], p["t_curr"], damping)
    step = ticp.icp_step_plain(_port_system(js), to_torch(p["r_curr"]), to_torch(p["t_curr"]), damping)
    assert bool(jok) and bool(step.ok)
    np.testing.assert_allclose(step.x.v.numpy(), np.asarray(jx.v), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(step.x.g.numpy(), np.asarray(jx.g), rtol=1e-3, atol=1e-3 * np.abs(np.asarray(jx.g)).max())
    assert np.abs(np.asarray(jt.v) - np.asarray(p["t_curr"].v)).max() > 1e-4  # the step moved the pose
    for got, want in ((step.r_curr, jr), (step.t_curr, jt)):
        np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=2e-5)
        np.testing.assert_allclose(got.g.numpy(), np.asarray(want.g), atol=1e-3 * max(1.0, np.abs(np.asarray(want.g)).max()))
    if damping > 0:  # damping shortened the step
        x0 = ticp.icp_step_plain(_port_system(js), to_torch(p["r_curr"]), to_torch(p["t_curr"]), 0.0).x
        assert not np.array_equal(x0.v.numpy(), step.x.v.numpy())


def test_icp_step_on_cpu_is_the_plain_step(icp_inputs):
    """The wrapper of a whole iteration on CPU tensors: the plain system,
    then the plain step, and no launch."""
    from xslam_tpu_torch.ops import kernels

    _, _, targs, tkw = _level_args(icp_inputs, 2)
    step = ticp.icp_step(*targs, **tkw, damping=0.0)
    ref = ticp.icp_step_plain(ticp.build_system_plain(*targs, **tkw), targs[0], targs[1], 0.0)
    for got, want in ((step.r_curr, ref.r_curr), (step.t_curr, ref.t_curr), (step.x, ref.x), (step.system.A, ref.system.A)):
        assert torch.equal(got.v, want.v) and torch.equal(got.g, want.g)
    assert bool(step.ok) and kernels.launch_counts["icp_system"] == 0


def test_pose_pack_round_trip():
    from xslam_tpu_torch.csfd.single import CSFD

    rng = np.random.default_rng(11)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    r, t, rpi, tp = CSFD(f(3, 3), f(3, 3)), CSFD(f(3), f(3)), CSFD(f(3, 3), f(3, 3)), CSFD(f(3), f(3))
    pose = ticp.pack_pose(r, t, rpi, tp)
    assert pose.dtype == torch.float32 and tuple(pose.shape) == (ticp.POSE_FLOATS,) and pose.is_contiguous()
    r2, t2 = ticp.unpack_pose(pose)
    for got, want in ((r2, r), (t2, t)):
        assert torch.equal(got.v, want.v) and torch.equal(got.g, want.g)
    assert torch.equal(pose[24:33].view(3, 3), rpi.v) and torch.equal(pose[33:36], tp.v)


@pytest.mark.parametrize("level", LEVELS)
def test_packed_model_rows_match_the_planes(icp_inputs, level):
    _, _, _, tkw = _level_args(icp_inputs, level)
    vmap, nmap = tkw["vmap_g_prev"], tkw["nmap_g_prev"]
    rows = ticp.pack_model_rows(vmap, nmap)
    H, W = vmap.v.shape[-2:]
    assert tuple(rows.shape) == (H * W, 12) and rows.is_contiguous() and rows.dtype == torch.float32
    planes = (vmap.v, vmap.g, nmap.v, nmap.g)
    for k, plane in enumerate(planes):
        got, want = rows[:, 3 * k:3 * k + 3].numpy(), plane.reshape(3, -1).T.numpy()
        np.testing.assert_array_equal(got, want)  # NaN where the model has no surface, bit for bit elsewhere
    assert np.isfinite(rows.numpy()).any() and np.isnan(rows.numpy()).any()


def test_icp_blocks_follow_the_shape():
    assert ticp.icp_blocks(1) == 1
    assert ticp.icp_blocks(120 * 160) == -(-120 * 160 // ticp.ICP_PIXELS_PER_BLOCK)
    assert ticp.icp_blocks(480 * 640) <= ticp.ICP_MAX_BLOCKS
    assert ticp.icp_blocks(4000 * 4000) == ticp.ICP_MAX_BLOCKS


def test_degenerate_step_freezes_the_pose():
    """No correspondences (frame 0 tracks against NaN maps): the guard
    fails, the increment is zero and the pose comes back bit for bit, with
    its derivative lane, not NaN."""
    from xslam_tpu_torch.csfd.single import CSFD

    rng = np.random.default_rng(3)
    r = CSFD(torch.eye(3), torch.from_numpy(rng.standard_normal((3, 3)).astype(np.float32)))
    t = CSFD(torch.tensor([0.1, -0.2, 0.3]), torch.from_numpy(rng.standard_normal(3).astype(np.float32)))
    z = torch.zeros((6, 6))
    system = ticp.IcpSystem(A=CSFD(z, z), b=CSFD(torch.zeros(6), torch.zeros(6)), inlier_count=torch.tensor(0))
    for damping in (0.0, 1e-3):
        step = ticp.icp_step_plain(system, r, t, damping)
        assert not bool(step.ok)
        assert torch.equal(step.r_curr.v, r.v) and torch.equal(step.r_curr.g, r.g)
        assert torch.equal(step.t_curr.v, t.v) and torch.equal(step.t_curr.g, t.g)
        assert torch.all(step.x.v == 0) and torch.all(step.x.g == 0)
    # a NaN system (a NaN pose upstream) fails the guard as well
    nan = torch.full((6, 6), float("nan"))
    step = ticp.icp_step_plain(system._replace(A=CSFD(nan, z)), r, t, 0.0)
    assert not bool(step.ok) and torch.equal(step.t_curr.v, t.v)
