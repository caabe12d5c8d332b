"""The port's TSDF fusion (plain version of kernel K2) against
xslam_tpu.ops.fusion.integrate: a 64^3 volume at 0.12 m, two frames of the
small synthetic sweep fused with derivative-seeded poses.

Tolerance: weight equal on >= 99.99% of voxels (a voxel on the
floor(img - 0.5) gate or the truncation edge may flip when XLA fuses a
multiply-add that PyTorch rounds twice), value/grad within 1e-5 where the
weights agree."""

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


def test_fusion_bilinear_branch_not_ported():
    _, _, tcfg = _vol_cfgs()
    vol = tfusion.create_volume(tcfg, "cpu")
    with pytest.raises(NotImplementedError):
        tfusion.integrate(vol, torch.zeros((120, 160)), None, None, Intrinsics(*SMALL_INTR), tcfg, bi_threshold=0.1)


def test_fusion_launches_nothing_on_cpu(fused):
    assert kernels.launch_counts["fuse_volume"] == 0
