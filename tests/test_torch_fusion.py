"""The port's TSDF fusion (plain version of kernel K2) against
xslam_tpu.ops.fusion.integrate: a 64^3 volume at 0.12 m, two frames of the
small synthetic sweep fused with derivative-seeded poses.

Tolerance: weight equal on >= 99.99% of voxels (a voxel on the
floor(img - 0.5) gate or the truncation edge may flip when XLA fuses a
multiply-add that PyTorch rounds twice), value/grad within 1e-5 where the
weights agree.

K2 skips the tiles of the volume that its test against the camera proves
unseen; ``tile_keep_mask`` is that test as a plain function (same tile, same
margin). It must never drop a tile in which ``fuse_volume_plain`` updates a
voxel: held on the sweep's poses, a pose that looks along the volume from a
corner, a pose whose camera plane cuts the volume, and with ``fy`` of
either sign."""

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
from xslam_tpu_torch.geometry.intrinsics import Intrinsics
from xslam_tpu_torch.ops import fusion as tfusion
from xslam_tpu_torch.ops import kernels


def _vol_cfgs():
    cfg = small_config()
    j = jfusion.VolumeConfig(tuple(cfg.tsdf_size), cfg.voxel_size, cfg.trunc_dist, cfg.max_integration_weight)
    t = tfusion.VolumeConfig(tuple(cfg.tsdf_size), cfg.voxel_size, cfg.trunc_dist, cfg.max_integration_weight)
    return cfg, j, t


@pytest.fixture(scope="module")
def fused():
    cfg, jcfg, tcfg = _vol_cfgs()
    ds = small_dataset(4, degrees_per_frame=2.0)
    w2v = np.asarray(cfg.world2volume, np.float32)
    tintr = Intrinsics(*SMALL_INTR)
    jvol = jfusion.create_volume(jcfg)
    tvol = tfusion.create_volume(tcfg, "cpu")
    integrate = jax.jit(functools.partial(jfusion.integrate, intr=SMALL_INTR, cfg=jcfg))
    for i, frame in enumerate((0, 3)):
        c2w = np.linalg.inv(ds.get_pose(0)) @ ds.get_pose(frame)
        c2v = JCSFD(jnp.asarray((w2v @ c2w).astype(np.float32)), jnp.asarray(seeded_pose_direction(i)))
        v2c = jse3.inverse(c2v)
        r, t = jse3.rotation(v2c), jse3.translation(v2c)
        depth = ds.get_depth(frame)
        jdepth = jfusion.scale_depth(jnp.asarray(depth))
        tdepth = tfusion.scale_depth(torch.from_numpy(depth))
        np.testing.assert_array_equal(tdepth.numpy(), np.asarray(jdepth))
        jvol = integrate(jvol, jdepth, r, t)
        out = tfusion.integrate(tvol, tdepth, to_torch(r), to_torch(t), tintr, tcfg)
        assert out is tvol  # updated in place
    return jvol, tvol


def test_fusion_weight_matches(fused):
    jvol, tvol = fused
    jw, tw = np.asarray(jvol.weight), tvol.weight.numpy()
    assert (jw == 2).sum() > 1000  # both frames landed on a shared surface
    assert np.mean(jw == tw) >= 0.9999


@pytest.mark.parametrize("plane", ["value", "grad"])
def test_fusion_value_grad_match(fused, plane):
    jvol, tvol = fused
    same = np.asarray(jvol.weight) == tvol.weight.numpy()
    j, t = np.asarray(getattr(jvol, plane)), getattr(tvol, plane).numpy()
    assert np.abs(j).max() > 1e-2  # the seeded lanes carry real values
    np.testing.assert_allclose(t[same], j[same], atol=1e-5)


def test_fusion_bilinear_branch_runs_in_place():
    """The bilinear branch (``bi_threshold > 0``), once refused here, fuses
    in place on CPU tensors and launches nothing: the same volume object
    comes back, updated; tests/test_torch_bilinear_fusion.py holds it to
    JAX's."""
    cfg, _, tcfg = _vol_cfgs()
    ds = small_dataset(1)
    w2v = np.asarray(cfg.world2volume, np.float32)
    v2c = np.linalg.inv(w2v @ ds.get_pose(0)).astype(np.float32)
    r = to_torch(JCSFD(jnp.asarray(v2c[:3, :3]), jnp.zeros((3, 3), jnp.float32)))
    t = to_torch(JCSFD(jnp.asarray(v2c[:3, 3]), jnp.zeros(3, jnp.float32)))
    vol = tfusion.create_volume(tcfg, "cpu")
    before = kernels.launch_counts["fuse_volume_bilinear"]
    out = tfusion.integrate(vol, tfusion.scale_depth(torch.from_numpy(ds.get_depth(0))), r, t,
                            Intrinsics(*SMALL_INTR), tcfg, bi_threshold=0.1)
    assert out is vol and int((vol.weight > 0).sum()) > 1000
    assert kernels.launch_counts["fuse_volume_bilinear"] == before


def test_fusion_launches_nothing_on_cpu(fused):
    assert kernels.launch_counts["fuse_volume"] == 0


# --- K2's tile test (ops/fusion.py::tile_keep_mask) -------------------------
def _look_at(eye, target):
    """Camera-to-volume pose of a camera at ``eye`` looking at ``target``."""
    z = (target - eye) / np.linalg.norm(target - eye)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    c2v = np.eye(4)
    c2v[:3, :3] = np.stack([x, np.cross(z, x), z], axis=1)
    c2v[:3, 3] = eye
    return c2v


def _tile_poses():
    """name -> camera-to-volume pose, in the 64^3 x 0.12 m volume."""
    cfg = small_config()
    ds = small_dataset(4, degrees_per_frame=2.0)
    w2v = np.asarray(cfg.world2volume, np.float64)
    extent = 64 * 0.12
    centre = np.full(3, extent / 2)
    return {
        "sweep_frame_0": w2v,
        "sweep_frame_3": w2v @ np.linalg.inv(ds.get_pose(0)) @ ds.get_pose(3),
        "corner": _look_at(np.full(3, 0.2), centre),
        "far_corner_outside": _look_at(np.array([extent + 0.5, -0.4, extent + 0.3]), centre),
        "plane_cuts_volume": _look_at(centre + np.array([0.3, -0.2, 0.1]), np.array([extent, 0.0, extent / 3])),
    }


@pytest.mark.parametrize("fy_sign", [-1.0, 1.0], ids=["fy_negative", "fy_positive"])
@pytest.mark.parametrize("pose", list(_tile_poses()))
def test_tile_test_keeps_every_updated_voxel(pose, fy_sign):
    _, _, tcfg = _vol_cfgs()
    intr = Intrinsics(*SMALL_INTR)._replace(fy=fy_sign * abs(SMALL_INTR.fy))
    c2v = _tile_poses()[pose]
    rng = np.random.default_rng(5)
    # any depth serves: metres in [0.3, 7], a tenth of the pixels invalid
    depth = rng.uniform(0.3, 7.0, (intr.height, intr.width)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.1] = 0.0
    v2c = np.linalg.inv(c2v).astype(np.float32)
    g = torch.from_numpy(seeded_pose_direction(2))
    r = tfusion.CSFD(torch.from_numpy(v2c[:3, :3].copy()), g[:3, :3].clone())
    t = tfusion.CSFD(torch.from_numpy(v2c[:3, 3].copy()), g[:3, 3].clone())
    vol = tfusion.create_volume(tcfg, "cpu")
    kernels.fuse_volume_plain(*vol, torch.from_numpy(depth), r, t, intr, tcfg.voxel_size, tcfg.trunc_dist,
                              tcfg.max_weight)
    updated = vol.weight > 0
    assert int(updated.sum()) > 1000  # the pose sees the volume
    keep = tfusion.tile_keep_mask(r, t, intr, tcfg.resolution, tcfg.voxel_size)
    tx, ty, tz = tfusion.FUSE_TILE
    assert tuple(keep.shape) == (64 // tx, 64 // ty, 64 // tz)
    per_voxel = keep.repeat_interleave(tx, 0).repeat_interleave(ty, 1).repeat_interleave(tz, 2)
    assert not bool((updated & ~per_voxel).any())


def test_tile_test_drops_most_of_the_canonical_volume():
    """At 256^3 x 0.03 m (the same extent) the sweep's camera sees about a
    tenth of the voxels; the test keeps under a quarter of the tiles. (At
    64^3 a tile spans the volume's whole z extent and little is dropped.)"""
    v2c = np.linalg.inv(_tile_poses()["sweep_frame_3"]).astype(np.float32)
    r = tfusion.CSFD(torch.from_numpy(v2c[:3, :3].copy()), torch.zeros(3, 3))
    t = tfusion.CSFD(torch.from_numpy(v2c[:3, 3].copy()), torch.zeros(3))
    intr = Intrinsics(481.2, -480.0, 319.5, 239.5, 640, 480)
    keep = tfusion.tile_keep_mask(r, t, intr, (256, 256, 256), 0.03)
    assert tuple(keep.shape) == (64, 32, 4)
    assert 0.05 < float(keep.float().mean()) < 0.25
