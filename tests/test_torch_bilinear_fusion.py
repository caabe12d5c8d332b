"""Fusion's bilinear depth branch (``bi_interpolate_threshold > 0``; kernel B11
in K2 and in the brick pass B3c) in the port against the JAX package, on the
small synthetic sweep (120x160 depth, 64^3 volume at 0.12 m).

- ``ops/sampling.py::bilinear_depth_sample`` against JAX's at thresholds
  1e-30, 0.1 and 0.5 on a rendered depth with its edges and with holes
  punched in it, at 20,000 seeded dual image points: ``in_bounds`` equal;
  the interpolant-or-nearest choice may flip where the block's spread lies
  within rounding of the threshold (XLA contracts multiply-adds on the CPU
  where the port rounds twice), and such points are counted, at most 0.1%;
  elsewhere values within 1e-6 m and the derivative lane within 1e-5 of its
  largest entry.
- ``fusion.integrate`` with thresholds 0.1 and 0.5 over two frames with
  seeded poses: weights equal on >= 99.99% of voxels, values within 1e-5
  and grads within 1e-4 of their largest entry where the weights agree; the
  branch changes the derivative lane against the nearest branch's.
- The port's derivative lane against finite differences of its value lane,
  as ``tests/test_fusion_raycast.py::test_fusion_gradient_wrt_pose`` holds
  JAX's (threshold 0.5, its bounds).
- ``integrate_brick`` and ``integrate_rows`` against JAX's with threshold 0.1,
  K2's tolerances; and the set of voxels where brick fusion parts from dense
  fusion under bilinear sampling (the classifier's proofs allow the nearest
  sample's half pixel, not the bilinear block's) is the JAX package's set in
  the port too.
- K2's tile test keeps every tile in which the bilinear branch updates a
  voxel (it reads only the gate, which the branch keeps).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import SMALL_INTR, small_config, small_dataset
from tests.torch_port_helpers import seeded_pose_direction, to_torch
from xslam_tpu.csfd.single import CSFD as JCSFD
from xslam_tpu.geometry import se3 as jse3
from xslam_tpu.ops import fusion as jfusion
from xslam_tpu.ops import fusion_brick as jbrick
from xslam_tpu.ops import sampling as jsampling
from xslam_tpu_torch.csfd.single import CSFD as TCSFD
from xslam_tpu_torch.csfd.single import lift as tlift
from xslam_tpu_torch.geometry import se3 as tse3
from xslam_tpu_torch.geometry.intrinsics import Intrinsics
from xslam_tpu_torch.ops import bricks as tbricks
from xslam_tpu_torch.ops import fusion as tfusion
from xslam_tpu_torch.ops import kernels
from xslam_tpu_torch.ops import sampling as tsampling

TINTR = Intrinsics(*SMALL_INTR)


def _cfgs(**overrides):
    cfg = small_config(**overrides)
    args = (tuple(cfg.tsdf_size), cfg.voxel_size, cfg.trunc_dist, cfg.max_integration_weight)
    return cfg, jfusion.VolumeConfig(*args), tfusion.VolumeConfig(*args)


def _holed_depth_m(frame: int = 2, seed: int = 5) -> np.ndarray:
    """A rendered frame in metres (float32) with 5% of its pixels zeroed."""
    depth = small_dataset(frame + 1, degrees_per_frame=1.0).get_depth(frame)
    depth_m = np.asarray(tfusion.scale_depth(torch.from_numpy(depth)))
    rng = np.random.default_rng(seed)
    depth_m[rng.random(depth_m.shape) < 0.05] = 0.0
    return depth_m


# ---------------------------------------------------------------- the sample
@pytest.mark.parametrize("threshold", [1e-30, 0.1, 0.5])
def test_bilinear_depth_sample_matches_jax(threshold):
    depth_m = _holed_depth_m()
    H, W = depth_m.shape
    rng = np.random.default_rng(7)
    n = 20_000
    x = rng.uniform(-2.0, W + 2.0, n).astype(np.float32)
    y = rng.uniform(-2.0, H + 2.0, n).astype(np.float32)
    gx, gy = (rng.standard_normal((2, n)) * 3.0).astype(np.float32)
    jout, jin = jax.jit(functools.partial(jsampling.bilinear_depth_sample, threshold=threshold))(
        jnp.asarray(depth_m), JCSFD(jnp.asarray(x), jnp.asarray(gx)), JCSFD(jnp.asarray(y), jnp.asarray(gy)))
    tout, tin = tsampling.bilinear_depth_sample(
        torch.from_numpy(depth_m), TCSFD(torch.from_numpy(x), torch.from_numpy(gx)),
        TCSFD(torch.from_numpy(y), torch.from_numpy(gy)), threshold)
    jv, jg, tv, tg = np.asarray(jout.v), np.asarray(jout.g), tout.v.numpy(), tout.g.numpy()
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    inside = tin.numpy()
    assert inside.mean() > 0.9
    interp_j, interp_t = jg != 0.0, tg != 0.0  # the interpolant carries the seeded derivative, the nearest none
    if threshold > 0.01:
        assert (interp_t & inside).mean() > 0.3  # the branch is taken
    flips = inside & ((interp_j != interp_t) | (np.abs(jv - tv) > 1e-6))
    assert flips.sum() <= 1e-3 * n, int(flips.sum())
    keep = inside & ~flips
    np.testing.assert_allclose(tv[keep], jv[keep], atol=1e-6)
    scale = max(1.0, float(np.abs(jg[keep]).max()))
    np.testing.assert_allclose(tg[keep], jg[keep], atol=1e-5 * scale)


# --------------------------------------------------------- dense fusion, K2
def _fuse_two(threshold: float):
    cfg, jcfg, tcfg = _cfgs()
    ds = small_dataset(4, degrees_per_frame=2.0)
    w2v = np.asarray(cfg.world2volume, np.float32)
    jvol = jfusion.create_volume(jcfg)
    tvol = tfusion.create_volume(tcfg, "cpu")
    integrate = jax.jit(functools.partial(jfusion.integrate, intr=SMALL_INTR, cfg=jcfg, bi_threshold=threshold))
    for i, frame in enumerate((0, 3)):
        c2w = np.linalg.inv(ds.get_pose(0)) @ ds.get_pose(frame)
        c2v = JCSFD(jnp.asarray((w2v @ c2w).astype(np.float32)), jnp.asarray(seeded_pose_direction(i)))
        v2c = jse3.inverse(c2v)
        r, t = jse3.rotation(v2c), jse3.translation(v2c)
        depth = ds.get_depth(frame)
        jvol = integrate(jvol, jfusion.scale_depth(jnp.asarray(depth)), r, t)
        tfusion.integrate(tvol, tfusion.scale_depth(torch.from_numpy(depth)), to_torch(r), to_torch(t), TINTR, tcfg,
                          bi_threshold=threshold)
    return jvol, tvol


@pytest.fixture(scope="module")
def fused():
    return {threshold: _fuse_two(threshold) for threshold in (0.0, 0.1, 0.5)}


@pytest.mark.parametrize("threshold", [0.1, 0.5])
def test_integrate_bilinear_matches_jax(fused, threshold):
    jvol, tvol = fused[threshold]
    jw, tw = np.asarray(jvol.weight), tvol.weight.numpy()
    assert (jw == 2).sum() > 1000
    assert np.mean(jw == tw) >= 0.9999
    same = jw == tw
    np.testing.assert_allclose(tvol.value.numpy()[same], np.asarray(jvol.value)[same], atol=1e-5)
    jg = np.asarray(jvol.grad)[same]
    np.testing.assert_allclose(tvol.grad.numpy()[same], jg, atol=1e-4 * max(1.0, float(np.abs(jg).max())))
    # the bilinear branch is taken: the derivative lane differs from the nearest branch's
    nearest = fused[0.0][1]
    both = (tvol.weight > 0) & (nearest.weight > 0)
    assert float((tvol.grad - nearest.grad)[both].abs().max()) > 1e-3


def test_integrate_bilinear_launches_nothing_on_cpu(fused):
    assert kernels.launch_counts["fuse_volume_bilinear"] == 0 and kernels.launch_counts["fuse_volume"] == 0


def test_bilinear_fusion_derivative_matches_finite_differences():
    """The port's CSFD derivative through fusion against central finite
    differences of its value lane, a translation direction seeded in the
    volume->camera pose (JAX's test, its volume and bounds)."""
    cfg, _, tcfg = _cfgs(tsdf_size=(32, 32, 32), voxel_size=0.24)
    ds = small_dataset(1)
    w2v = np.asarray(cfg.world2volume, np.float32)
    depth_m = tfusion.scale_depth(torch.from_numpy(ds.get_depth(0)))
    ez = torch.tensor([0.0, 0.0, 1.0])

    def integrate_with_tz(v, g):
        c2v = tse3.matmul(tlift(torch.from_numpy(w2v)), tlift(torch.from_numpy(ds.get_pose(0).astype(np.float32))))
        v2c = tse3.inverse(c2v)
        t = tse3.translation(v2c)
        t = TCSFD(t.v + v * ez, t.g + g * ez)
        vol = tfusion.create_volume(tcfg, "cpu")
        return tfusion.integrate(vol, depth_m, tse3.rotation(v2c), t, TINTR, tcfg, bi_threshold=0.5)

    eps = 1e-3
    vol0 = integrate_with_tz(0.0, 1.0)
    volp, volm = integrate_with_tz(eps, 0.0), integrate_with_tz(-eps, 0.0)
    fd = ((volp.value - volm.value) / (2 * eps)).numpy()
    an = vol0.grad.numpy()
    mask = (volp.weight.numpy() > 0) & (volm.weight.numpy() > 0) & (np.abs(fd) < 5) & (np.abs(an) < 5)
    assert mask.sum() > 1000
    assert np.corrcoef(fd[mask], an[mask])[0, 1] > 0.99
    d = np.abs(an[mask] - fd[mask])
    assert np.median(d) < 1e-3 and np.percentile(d, 95) < 0.02, (np.median(d), np.percentile(d, 95))


# ------------------------------------------------------- brick fusion, B3c
def _orbit_case():
    cfg = small_config()
    ds = small_dataset(4, degrees_per_frame=1.0)
    w2v = np.asarray(cfg.world2volume, np.float32)
    v2c = np.linalg.inv(w2v @ ds.get_pose(3)).astype(np.float32)
    g = seeded_pose_direction(6)
    r = JCSFD(jnp.asarray(v2c[:3, :3]), jnp.asarray(g[:3, :3]))
    t = JCSFD(jnp.asarray(v2c[:3, 3]), jnp.asarray(g[:3, 3]))
    return ds.get_depth(3), r, t


def _corner_case():
    """A camera in a corner of the volume looking at its middle, on a seeded
    depth with 10% holes: every depth edge a block can straddle."""
    extent = 64 * 0.12
    eye, target = np.full(3, 0.3), np.full(3, extent / 2)
    z = (target - eye) / np.linalg.norm(target - eye)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    c2v = np.eye(4)
    c2v[:3, :3] = np.stack([x, np.cross(z, x), z], axis=1)
    c2v[:3, 3] = eye
    v2c = np.linalg.inv(c2v).astype(np.float32)
    rng = np.random.default_rng(11)
    depth = rng.uniform(300.0, 7000.0, (SMALL_INTR.height, SMALL_INTR.width))
    depth[rng.random(depth.shape) < 0.1] = 0.0
    g = seeded_pose_direction(7)
    r = JCSFD(jnp.asarray(v2c[:3, :3]), jnp.asarray(g[:3, :3]))
    t = JCSFD(jnp.asarray(v2c[:3, 3]), jnp.asarray(g[:3, 3]))
    return depth.astype(np.uint16), r, t


BRICK_CASES = {"orbit": _orbit_case, "corner": _corner_case}
THRESHOLD = 0.1


@pytest.fixture(scope="module")
def brick_fused():
    """Per case, one frame into an empty volume with threshold 0.1: (JAX dense,
    JAX brick, JAX rows (dense twin), port dense, port brick, port rows (dense
    twin)), each a tuple of numpy planes."""
    _, jcfg, tcfg = _cfgs()
    out = {}
    for name, make in BRICK_CASES.items():
        depth, r, t = make()
        tr, tt = to_torch(r), to_torch(t)
        jdm = jfusion.scale_depth(jnp.asarray(depth))
        jd = jfusion.integrate(jfusion.create_volume(jcfg), jdm, r, t, SMALL_INTR, jcfg, bi_threshold=THRESHOLD)
        jb, jo = jbrick.integrate_brick(jfusion.create_volume(jcfg), jdm, r, t, SMALL_INTR, jcfg,
                                        bi_threshold=THRESHOLD, cap=4096)
        from xslam_tpu.ops import bricks as jbricks

        jrows, jro = jbrick.integrate_rows(jbricks.create(jcfg), jdm, r, t, SMALL_INTR, jcfg, bi_threshold=THRESHOLD,
                                           cap=4096)
        jr = jbricks.to_dense(jrows, jcfg.resolution)
        assert not bool(jo) and not bool(jro)
        dm = tfusion.scale_depth(torch.from_numpy(depth))
        td = tfusion.integrate(tfusion.create_volume(tcfg, "cpu"), dm, tr, tt, TINTR, tcfg, bi_threshold=THRESHOLD)
        tb = tfusion.create_volume(tcfg, "cpu")
        to, _ = tfusion.integrate_brick(tb, dm, tr, tt, TINTR, tcfg, cap=4096, bi_threshold=THRESHOLD)
        trows = tbricks.create(tcfg, "cpu")
        tro, _ = tfusion.integrate_rows(trows, dm, tr, tt, TINTR, tcfg, cap=4096, bi_threshold=THRESHOLD)
        assert not bool(to) and not bool(tro)
        tr_dense = tbricks.to_dense(trows, tcfg.resolution)

        def planes(v):
            return tuple(np.array(x) for x in v)

        out[name] = (planes(jd), planes(jb), planes(jr),
                     tuple(x.numpy() for x in td), tuple(x.numpy() for x in tb), tuple(x.numpy() for x in tr_dense))
    return out


@pytest.mark.parametrize("layout", ["brick", "rows"])
@pytest.mark.parametrize("name", sorted(BRICK_CASES))
def test_brick_fusion_bilinear_matches_jax(brick_fused, name, layout):
    jd, jb, jr, td, tb, tr = brick_fused[name]
    j, t = (jb, tb) if layout == "brick" else (jr, tr)
    assert (j[2] > 0).sum() > 500
    assert np.mean(j[2] == t[2]) >= 0.9999
    same = j[2] == t[2]
    np.testing.assert_allclose(t[0][same], j[0][same], atol=1e-5)
    np.testing.assert_allclose(t[1][same], j[1][same], atol=1e-4 * max(1.0, float(np.abs(j[1][same]).max())))


def _parted(dense, brick) -> np.ndarray:
    """Voxels where brick fusion parts from dense fusion beyond rounding: the
    weight differs, or the value by more than 1e-4."""
    return (dense[2] != brick[2]) | (np.abs(dense[0] - brick[0]) > 1e-4)


@pytest.mark.parametrize("name", sorted(BRICK_CASES))
def test_brick_vs_dense_difference_set_equals_jax(brick_fused, name):
    jd, jb, jr, td, tb, tr = brick_fused[name]
    for jx, tx in ((jb, tb), (jr, tr)):
        np.testing.assert_array_equal(np.flatnonzero(_parted(td, tx)), np.flatnonzero(_parted(jd, jx)))


# ------------------------------------------------------------ K2's tile test
@pytest.mark.parametrize("pose", ["sweep_frame_3", "corner", "plane_cuts_volume"])
def test_tile_test_keeps_every_bilinear_update(pose):
    """K2's tile test (``ops/fusion.py::tile_keep_mask``) reads only the
    in-front test and the pixel gate, which the bilinear branch keeps (its
    2x2 block lies inside the gated pixels): it drops no tile in which the
    bilinear plain version updates a voxel, on a smooth depth where the
    interpolant is taken."""
    from tests.test_torch_fusion import _tile_poses

    _, _, tcfg = _cfgs()
    c2v = _tile_poses()[pose]
    v, u = np.mgrid[0:SMALL_INTR.height, 0:SMALL_INTR.width]
    depth = (2.5 + 0.8 * np.sin(u / 23.0) * np.cos(v / 17.0)).astype(np.float32)  # metres, neighbours cm apart
    v2c = np.linalg.inv(c2v).astype(np.float32)
    g = torch.from_numpy(seeded_pose_direction(3))
    r = TCSFD(torch.from_numpy(v2c[:3, :3].copy()), g[:3, :3].clone())
    t = TCSFD(torch.from_numpy(v2c[:3, 3].copy()), g[:3, 3].clone())
    vol, near = tfusion.create_volume(tcfg, "cpu"), tfusion.create_volume(tcfg, "cpu")
    kernels.fuse_volume_plain(*vol, torch.from_numpy(depth), r, t, TINTR, tcfg.voxel_size, tcfg.trunc_dist,
                              tcfg.max_weight, THRESHOLD)
    kernels.fuse_volume_plain(*near, torch.from_numpy(depth), r, t, TINTR, tcfg.voxel_size, tcfg.trunc_dist,
                              tcfg.max_weight)
    updated = vol.weight > 0
    assert int(updated.sum()) > 1000 and bool((vol.grad != near.grad).any())  # the interpolant is taken
    keep = tfusion.tile_keep_mask(r, t, TINTR, tcfg.resolution, tcfg.voxel_size)
    tx, ty, tz = tfusion.FUSE_TILE
    per_voxel = keep.repeat_interleave(tx, 0).repeat_interleave(ty, 1).repeat_interleave(tz, 2)
    assert not bool((updated & ~per_voxel).any())
