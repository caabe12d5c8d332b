"""The port's brick fusion (``xslam_tpu_torch.ops.fusion_brick``, plain
versions of kernels B3a-c) against ``xslam_tpu.ops.fusion_brick`` and against
the port's own dense fusion, on the CPU at the tests' scale (64^3 at 0.12 m,
160x120 depth).

- The mip table (B3a) equals the JAX package's ``_depth_mips`` bit for bit,
  its +inf / -inf / valid pads included.
- The classes (B3b) equal ``classify_bricks_full(split=False)``'s on at
  least 99.9% of bricks at the orbit, a volume corner and the JAX tests'
  window-misalignment regression pose: XLA on the CPU may fuse a
  multiply-add that PyTorch rounds twice, which can move a bound by an ulp.
  (On these inputs every brick agreed.)
- The port's ``integrate_brick`` equals the port's dense ``integrate`` bit
  for bit (``torch.equal`` on all three planes), also with a seeded
  derivative lane; against JAX's ``integrate_brick`` within K2's tolerances
  (weights >= 99.99% equal, value and grad within 1e-5 where they agree).
- The overflow: ``cap=4`` raises the flag as the JAX function does, and
  ``"flag"`` leaves the same bricks unfused; in the engine the flag
  propagates, ``"dense"`` gives the dense engine's volume bit for bit, and
  a brick-fusion run lies in the JAX brick engine's ATE class.
- B3b ranks bricks by per-block counts and warp ballots, and B3a walks a
  tile's pixels lane by lane; their numpy twins here show the ranks are
  flat brick order and every pixel is read once.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.helpers import SMALL_INTR, small_config, small_dataset, small_scene
from tests.torch_port_helpers import seeded_pose_direction, to_torch, torch_config
from xslam_tpu.csfd.single import CSFD as JCSFD
from xslam_tpu.io.synthetic import render_depth
from xslam_tpu.models.kinfu import XSlamEngine as JaxEngine
from xslam_tpu.ops import fusion as jfusion
from xslam_tpu.ops import fusion_brick as jbrick
from xslam_tpu.utils.evaluation import ate_rmse, normalize_to_first
from xslam_tpu_torch.geometry.intrinsics import Intrinsics
from xslam_tpu_torch.models.kinfu import XSlamEngine as TorchEngine
from xslam_tpu_torch.ops import fusion as tfusion
from xslam_tpu_torch.ops import fusion_brick as tbrick
from xslam_tpu_torch.ops import kernels

TINTR = Intrinsics(*SMALL_INTR)


def _cfgs():
    cfg = small_config()
    args = (tuple(cfg.tsdf_size), cfg.voxel_size, cfg.trunc_dist, cfg.max_integration_weight)
    return cfg, jfusion.VolumeConfig(*args), tfusion.VolumeConfig(*args)


def _look_at(eye, target):
    """Camera-to-volume pose of a camera at ``eye`` looking at ``target``."""
    z = (target - eye) / np.linalg.norm(target - eye)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    c2v = np.eye(4)
    c2v[:3, :3] = np.stack([x, np.cross(z, x), z], axis=1)
    c2v[:3, 3] = eye
    return c2v


def _regression_c2w():
    """tests/test_fusion_brick.py::test_window_misalignment_regression's pose:
    trial 9 of its seeded sweep."""
    rng = np.random.default_rng(0)
    for _ in range(9):
        rng.uniform(-0.4, 0.4, 3), rng.uniform(-0.5, 0.5, 3)
    ang, t = rng.uniform(-0.4, 0.4, 3), rng.uniform(-0.5, 0.5, 3)
    c, s = np.cos(ang), np.sin(ang)
    rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
    ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
    rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = (rx @ ry @ rz).astype(np.float32)
    c2w[:3, 3] = t
    return c2w


def _case(name):
    """(volume->camera pose (4, 4) float32, depth uint16) of a named case."""
    cfg = small_config()
    w2v = np.asarray(cfg.world2volume, np.float32)
    if name == "orbit":
        ds = small_dataset(4, degrees_per_frame=1.0)
        return np.linalg.inv(w2v @ ds.get_pose(3)).astype(np.float32), ds.get_depth(3)
    if name == "corner":
        extent = 64 * 0.12
        rng = np.random.default_rng(11)
        depth = rng.uniform(300.0, 7000.0, (SMALL_INTR.height, SMALL_INTR.width))
        depth[rng.random(depth.shape) < 0.1] = 0.0
        c2v = _look_at(np.full(3, 0.3), np.full(3, extent / 2))
        return np.linalg.inv(c2v).astype(np.float32), depth.astype(np.uint16)
    c2w = _regression_c2w()
    depth = np.asarray(render_depth(small_scene(), c2w, SMALL_INTR))
    return np.linalg.inv(w2v @ c2w).astype(np.float32), depth


CASES = ("orbit", "corner", "regression")


def _poses(v2c, seed=None):
    """(JAX r, t, port r, t) of a volume->camera pose; a seeded derivative lane if ``seed``."""
    g = np.zeros((4, 4), np.float32) if seed is None else seeded_pose_direction(seed)
    r = JCSFD(jnp.asarray(v2c[:3, :3]), jnp.asarray(g[:3, :3]))
    t = JCSFD(jnp.asarray(v2c[:3, 3]), jnp.asarray(g[:3, 3]))
    return r, t, to_torch(r), to_torch(t)


# --------------------------------------------------------------- B3a: mips
@pytest.mark.parametrize("source", ["orbit", "corner", "crop_117x157"])
def test_mip_table_equals_jax(source):
    if source == "crop_117x157":  # tiles that do not divide the image: padded rows and columns at every level
        depth = _case("orbit")[1][:117, :157].copy()
    else:
        depth = _case(source)[1].copy()
    depth[10:50, 20:70] = 0  # a hole: tiles with no valid depth (min +inf, max -inf)
    jdm = jfusion.scale_depth(jnp.asarray(depth))
    sizes, mins, maxs, allv = jbrick._depth_mips(jdm)
    want = np.concatenate([
        np.stack([np.asarray(a).reshape(-1), np.asarray(b).reshape(-1), np.asarray(c).reshape(-1).astype(np.float32)],
                 axis=1)
        for a, b, c in zip(mins, maxs, allv)
    ])
    got = tbrick.depth_mips(tfusion.scale_depth(torch.from_numpy(np.ascontiguousarray(depth)))).numpy()
    layout = tbrick.mip_layout(*depth.shape)
    assert list(layout.sizes) == list(sizes)
    assert got.shape == want.shape == (layout.rows, 3)
    assert np.array_equal(got, want)  # inf pads compare equal as numbers
    assert np.isposinf(got[:, 0]).any() and np.isneginf(got[:, 1]).any()


def test_mip_layout_offsets():
    layout = tbrick.mip_layout(120, 160)
    assert layout.sizes == tuple(ts for ts in tbrick.MIP_LEVELS if ts <= 120)
    assert layout.offsets[0] == 0
    for i in range(1, len(layout.sizes)):
        h, w = layout.shapes[i - 1]
        assert layout.offsets[i] == layout.offsets[i - 1] + h * w
    assert layout.rows == sum(h * w for h, w in layout.shapes)


def _mip_tile_threads(ts):
    """csrc/bricks.cu::mip_tile_threads: a power of two up to 512, about 32 pixels a thread."""
    want, t = ts * ts // 32, 1
    while 2 * t <= want and t < 512:
        t *= 2
    return t


@pytest.mark.parametrize("ts", tbrick.MIP_LEVELS)
def test_mip_walk_reads_every_pixel_once(ts):
    """numpy twin of csrc/bricks.cu::depth_mips_kernel's walk: thread q of
    the tile's T threads starts at pixel q of the tile in row order and steps
    T pixels by (T // ts) rows and (T % ts) columns with one carry; a thread
    reads at most 63 pixels (eight rounds of eight loads), and a tile's
    threads are an aligned run of lanes or whole warps."""
    threads = _mip_tile_threads(ts)
    assert ts * ts / threads < 64 and (threads <= 32 or threads % 32 == 0) and 512 % threads == 0
    seen = np.zeros((ts, ts), np.int32)
    step_y, step_x = threads // ts, threads - (threads // ts) * ts
    for q in range(threads):
        yy, xx = q // ts, q % ts
        while yy < ts:
            seen[yy, xx] += 1
            xx += step_x
            yy += step_y
            if xx >= ts:
                xx -= ts
                yy += 1
    assert (seen == 1).all()


# --------------------------------------------------------- B3b: classes
@pytest.mark.parametrize("name", CASES)
def test_classes_match_jax(name):
    _, jcfg, tcfg = _cfgs()
    v2c, depth = _case(name)
    r, t, tr, tt = _poses(v2c)
    jcls = np.asarray(jbrick.classify_bricks_full(jfusion.scale_depth(jnp.asarray(depth)), r.v, t.v, SMALL_INTR,
                                                  jcfg, jcfg.resolution, split=False).cls)
    table = tbrick.depth_mips(tfusion.scale_depth(torch.from_numpy(depth)))
    tcls = tbrick.classify_bricks_plain(table, kernels.fusion_pose(tr, tt), TINTR, tcfg).numpy()
    assert tcls.shape == jcls.shape == (8, 8, 8)
    differ = int((tcls != jcls).sum())
    assert differ <= 0.001 * tcls.size, f"{differ} of {tcls.size} bricks differ"
    counts = np.bincount(tcls.reshape(-1), minlength=4)
    assert counts[tbrick.ACTIVE] > 10 and counts[tbrick.NONE] > 10, counts


def test_classes_reach_far_and_far_partial():
    """A uniform far depth makes FAR bricks and, at the frustum's sides,
    FAR_PARTIAL ones (tests/test_fusion_brick.py's check of the JAX classes)."""
    _, jcfg, tcfg = _cfgs()
    v2c, _ = _case("orbit")
    r, t, tr, tt = _poses(v2c)
    far = np.full((SMALL_INTR.height, SMALL_INTR.width), 4000, np.uint16)
    table = tbrick.depth_mips(tfusion.scale_depth(torch.from_numpy(far)))
    tcls = tbrick.classify_bricks_plain(table, kernels.fusion_pose(tr, tt), TINTR, tcfg).numpy()
    jcls = np.asarray(jbrick.classify_bricks_full(jfusion.scale_depth(jnp.asarray(far)), r.v, t.v, SMALL_INTR, jcfg,
                                                  jcfg.resolution).cls)
    assert (tcls == tbrick.FAR).sum() > 0 and (tcls == tbrick.FAR_PARTIAL).sum() > 0
    assert (tcls != jcls).sum() <= 0.001 * tcls.size


def _twin_rank(cls_flat, cap, block=tbrick.CLASSIFY_BLOCK):
    """numpy twin of csrc/bricks.cu's rank_bricks_kernel: block b adds the
    counts of blocks < b, then ranks its own bricks by warp ballots (the
    warps' popcounts before it, then the lanes' below it)."""
    n = cls_flat.size
    blocks = -(-n // block)
    padded = np.full(blocks * block, tbrick.NONE, np.int64)
    padded[:n] = cls_flat
    per_block = padded.reshape(blocks, block)
    counts = [((per_block == tbrick.ACTIVE).sum(1)), ((per_block != tbrick.NONE).sum(1))]
    rank = np.full(n, -1, np.int64)
    active_ids = np.full(n, -1, np.int64)
    work_ids = np.full(n, -1, np.int64)
    for b in range(blocks):
        for pred, before, out in ((per_block[b] == tbrick.ACTIVE, counts[0][:b].sum(), active_ids),
                                  (per_block[b] != tbrick.NONE, counts[1][:b].sum(), work_ids)):
            warps = pred.reshape(-1, 32)
            pops = warps.sum(1)
            for w in range(warps.shape[0]):
                for lane in range(32):
                    if warps[w, lane]:
                        r = before + pops[:w].sum() + warps[w, :lane].sum()
                        out[r] = b * block + w * 32 + lane
                        if out is active_ids:
                            rank[b * block + w * 32 + lane] = r
    return rank, active_ids, work_ids, counts[0].sum(), counts[1].sum()


@pytest.mark.parametrize("n", [512, 1000, 32768])
def test_rank_twin_is_flat_order(n):
    rng = np.random.default_rng(n)
    cls = rng.choice(4, size=n, p=[0.6, 0.2, 0.15, 0.05]).astype(np.int32)
    rank, active_ids, work_ids, n_active, n_work = _twin_rank(cls, cap=0)
    plain = tbrick.rank_bricks_plain(torch.from_numpy(cls), cap=int(n_active) - 1)
    assert np.array_equal(rank, plain.rank.numpy())
    assert np.array_equal(active_ids[:n_active], plain.active_ids[:n_active].numpy())
    assert np.array_equal(work_ids[:n_work], plain.work_ids[:n_work].numpy())
    assert np.array_equal(active_ids[:n_active], np.flatnonzero(cls == tbrick.ACTIVE))
    assert plain.totals.tolist() == [n_active, n_work] and bool(plain.overflow)
    assert (plain.active_ids[n_active:] == n).all()  # the plain version pads with NB


# ---------------------------------------------------- B3c: the fused volume
def _fuse_both(name, seed=None, cap=512, overflow="flag"):
    """(port dense volume, port brick volume, brick flags) after the case's
    frame, each from the same pre-frame volume: the orbit's frames 0-2 fused
    densely."""
    cfg, _, tcfg = _cfgs()
    w2v = np.asarray(cfg.world2volume, np.float32)
    ds = small_dataset(3, degrees_per_frame=1.0)
    pre = tfusion.create_volume(tcfg, "cpu")
    for i in range(3):
        v2c = np.linalg.inv(w2v @ ds.get_pose(i)).astype(np.float32)
        _, _, tr, tt = _poses(v2c, seed=None if seed is None else seed + i)
        tfusion.integrate(pre, tfusion.scale_depth(torch.from_numpy(ds.get_depth(i))), tr, tt, TINTR, tcfg)
    v2c, depth = _case(name)
    _, _, tr, tt = _poses(v2c, seed)
    dm = tfusion.scale_depth(torch.from_numpy(depth))
    dense = tfusion.VolumeState(*(x.clone() for x in pre))
    brick = tfusion.VolumeState(*(x.clone() for x in pre))
    tfusion.integrate(dense, dm, tr, tt, TINTR, tcfg)
    flags = tfusion.integrate_brick(brick, dm, tr, tt, TINTR, tcfg, cap=cap, overflow=overflow)
    return pre, dense, brick, flags


@pytest.mark.parametrize("seed", [None, 4], ids=["no_seed", "gradient_seed"])
@pytest.mark.parametrize("name", CASES)
def test_brick_fusion_equals_dense_bit_for_bit(name, seed):
    pre, dense, brick, (overflow, n_active) = _fuse_both(name, seed)
    assert not bool(overflow) and int(n_active) > 10
    assert int((dense.weight != pre.weight).sum()) > 500  # the frame updates the volume
    for d, b in zip(dense, brick):
        assert torch.equal(d.view(torch.int32), b.view(torch.int32))  # every bit, the sign of zero too
    if seed is not None:
        assert float(dense.grad.abs().max()) > 1e-3  # the derivative lane carries values


@pytest.mark.parametrize("name", CASES)
def test_brick_fusion_matches_jax(name):
    """One frame into an empty volume with a seeded pose: the port's
    integrate_brick against JAX's, within K2's tolerances."""
    _, jcfg, tcfg = _cfgs()
    v2c, depth = _case(name)
    r, t, tr, tt = _poses(v2c, seed=6)
    jvol, joverflow = jbrick.integrate_brick(jfusion.create_volume(jcfg), jfusion.scale_depth(jnp.asarray(depth)),
                                             r, t, SMALL_INTR, jcfg, cap=512)
    tvol = tfusion.create_volume(tcfg, "cpu")
    toverflow, _ = tfusion.integrate_brick(tvol, tfusion.scale_depth(torch.from_numpy(depth)), tr, tt, TINTR, tcfg,
                                           cap=512)
    assert bool(joverflow) == bool(toverflow) is False
    jw, tw = np.asarray(jvol.weight), tvol.weight.numpy()
    assert (jw > 0).sum() > 500
    assert np.mean(jw == tw) >= 0.9999
    same = jw == tw
    for plane in ("value", "grad"):
        np.testing.assert_allclose(getattr(tvol, plane).numpy()[same], np.asarray(getattr(jvol, plane))[same],
                                   atol=1e-5)


def test_cap_overflow_flags_and_leaves_the_same_bricks_unfused():
    _, jcfg, tcfg = _cfgs()
    v2c, depth = _case("orbit")
    r, t, tr, tt = _poses(v2c)
    jdm = jfusion.scale_depth(jnp.asarray(depth))
    jvol, joverflow = jbrick.integrate_brick(jfusion.create_volume(jcfg), jdm, r, t, SMALL_INTR, jcfg, cap=4)
    tvol = tfusion.create_volume(tcfg, "cpu")
    dm = tfusion.scale_depth(torch.from_numpy(depth))
    toverflow, n_active = tfusion.integrate_brick(tvol, dm, tr, tt, TINTR, tcfg, cap=4)
    assert bool(joverflow) and bool(toverflow) and int(n_active) > 4
    # the bricks each leaves unfused: ACTIVE ones of flat rank >= cap
    jcls = np.asarray(jbrick.classify_bricks_full(jdm, r.v, t.v, SMALL_INTR, jcfg, jcfg.resolution).cls).reshape(-1)
    classes = tbrick.classify_bricks(tbrick.depth_mips(dm), kernels.fusion_pose(tr, tt), TINTR, tcfg, 4)
    jdropped = np.flatnonzero(jcls == tbrick.ACTIVE)[4:]
    tdropped = np.flatnonzero(classes.rank.numpy() >= 4)
    assert len(tdropped) > 0 and np.array_equal(jdropped, tdropped)
    # there the weights stay 0 in both; the fused bricks carry the updates
    jw = jbrick.to_bricks(jvol.weight)
    tw = tbrick.to_bricks(tvol.weight)
    assert not np.asarray(jw[tdropped]).any() and not bool(tw[tdropped].any())
    assert np.mean(np.asarray(jvol.weight) == tvol.weight.numpy()) >= 0.9999
    assert int(tw.sum()) > 0


def test_brick_wrappers_launch_nothing_on_cpu():
    before = dict(kernels.launch_counts)
    _fuse_both("orbit")
    assert kernels.launch_counts == before
    assert before["depth_mips"] == before["classify_bricks"] == before["fuse_bricks"] == 0


def test_integrate_brick_checks_its_options():
    _, _, tcfg = _cfgs()
    vol = tfusion.create_volume(tcfg, "cpu")
    with pytest.raises(ValueError):
        tfusion.integrate_brick(vol, torch.zeros(120, 160), None, None, TINTR, tcfg, cap=4, overflow="drop")
    odd = tfusion.VolumeConfig((60, 64, 64), tcfg.voxel_size, tcfg.trunc_dist, tcfg.max_weight)
    with pytest.raises(ValueError):
        tbrick.classify_bricks_plain(torch.zeros(1, 3), torch.zeros(24), TINTR, odd)


# ------------------------------------------------------------- the engine
N_FRAMES = 6


def _engine_run(n, **options):
    cfg = small_config(end_frame=n, **options)
    ds = small_dataset(n, degrees_per_frame=1.0)
    engine = TorchEngine(torch_config(cfg), device="cpu")
    state = engine.init_state()
    flags, actives = [], []
    for i in range(n):
        state, res = engine.process_frame(state, ds.get_depth(i), gt_pose=ds.get_pose(i))
        engine.log_pose(res)
        flags.append(bool(res.fusion_overflow))
        actives.append(None if res.fusion_active is None else int(res.fusion_active))
    return state, flags, actives, engine


@pytest.mark.parametrize("overflow", ["flag", "dense"])
def test_engine_overflow(overflow):
    """tests/test_fusion_brick.py::test_engine_overflow_propagates_and_dense_fallback
    for the port: oracle poses (a crippled map must not stop integration)."""
    state, flags, actives, _ = _engine_run(2, use_gt_pose=True, fusion_mode="brick", fusion_brick_cap=4,
                                           fusion_overflow=overflow)
    assert all(a is not None and a > 4 for a in actives)
    dense, dflags, dactives, _ = _engine_run(2, use_gt_pose=True)
    assert dflags == [False, False] and dactives == [None, None]
    if overflow == "flag":
        assert flags == [True, True]
        assert not torch.equal(state.volume.weight, dense.volume.weight)
    else:
        assert flags == [False, False]
        for a, b in zip(state.volume, dense.volume):
            assert torch.equal(a, b)


@pytest.fixture(scope="module")
def brick_runs():
    """Six tracked frames with bench.py's fusion (brick, cap 2816, dense on
    overflow) on both engines, and the port's dense run."""
    options = dict(fusion_mode="brick", fusion_brick_cap=2816, fusion_overflow="dense")
    cfg = small_config(end_frame=N_FRAMES, **options)
    ds = small_dataset(N_FRAMES, degrees_per_frame=1.0)
    jeng = JaxEngine(cfg)
    jstate = jeng.init_state()
    jax_poses = []
    for i in range(N_FRAMES):
        jstate, jres = jeng.process_frame(jstate, ds.get_depth(i))
        jax_poses.append(np.array(jres.camera2world.v))
    runs = {}
    for mode, opts in (("brick", options), ("dense", {})):
        engine = TorchEngine(torch_config(small_config(end_frame=N_FRAMES, **opts)), device="cpu")
        state = engine.init_state()
        oks, actives = [], []
        for i in range(N_FRAMES):
            state, res = engine.process_frame(state, ds.get_depth(i))
            engine.log_pose(res)
            oks.append(bool(res.align_ok))
            actives.append(None if res.fusion_active is None else int(res.fusion_active))
        runs[mode] = (state, engine.pose_log, oks, actives)
    gt = normalize_to_first([ds.get_pose(i) for i in range(N_FRAMES)])
    return jax_poses, runs, gt


def test_brick_run_in_the_jax_engines_ate_class(brick_runs):
    jax_poses, runs, gt = brick_runs
    _, poses, oks, actives = runs["brick"]
    assert all(oks) and all(0 < a <= 2816 for a in actives)
    ate_j = ate_rmse(normalize_to_first(jax_poses), gt)
    ate_t = ate_rmse(normalize_to_first(poses), gt)
    assert ate_j < 0.06 and ate_t < 0.06, (ate_j, ate_t)
    assert abs(ate_j - ate_t) < 5e-3, (ate_j, ate_t)


def test_brick_run_equals_the_dense_run(brick_runs):
    """Brick fusion gives dense fusion's volume every frame, so the whole
    tracked run is the dense run's, pose for pose and bit for bit."""
    _, runs, _ = brick_runs
    bstate, bposes, _, _ = runs["brick"]
    dstate, dposes, _, _ = runs["dense"]
    for a, b in zip(bstate.volume, dstate.volume):
        assert torch.equal(a, b)
    for a, b in zip(bposes, dposes):
        assert np.array_equal(a, b)
