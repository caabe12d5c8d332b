"""The port's raycast (plain march = kernel K3's twin, dual secant refine, TSDF
normals) against xslam_tpu.ops.raycast on a volume fused by the JAX engine
(pose derivative seeded) and carried across with ``state_from_numpy``.

Tolerance: march events at the same step on >= 99.9% of rays (a sample on a
floor boundary may pick the neighbouring voxel when XLA fuses a
multiply-add), and event times within 1e-6 m: XLA on the CPU contracts the
march time ``0.2 + k * step`` into one fused multiply-add where the port, like
its CUDA kernel built with ``-fmad=false``, rounds twice, so a time may
differ in its last bit;
vertex/normal finite masks agree on >= 99.5% of pixels and values within
1e-4 where both are finite (derivative lanes relative to their largest
entry)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import small_config, small_dataset
from tests.torch_port_helpers import jax_state_to_numpy, seed_jax_state, seeded_pose_direction
from xslam_tpu.csfd.single import lift as jlift
from xslam_tpu.geometry import se3 as jse3
from xslam_tpu.models.kinfu import XSlamEngine
from xslam_tpu.ops import fusion as jfusion
from xslam_tpu.ops import raycast as jray
from xslam_tpu_torch.csfd.single import lift as tlift
from xslam_tpu_torch.geometry import se3 as tse3
from xslam_tpu_torch.geometry.intrinsics import Intrinsics
from xslam_tpu_torch.ops import fusion as tfusion
from xslam_tpu_torch.ops import kernels
from xslam_tpu_torch.ops import raycast as tray
from xslam_tpu_torch.utils.convert import state_from_numpy, state_to_numpy


def _poses(se3, lift, w2c, w2v):
    c2w = se3.inverse(w2c)
    c2v = se3.matmul(lift(w2v), c2w)
    v2w = se3.inverse(lift(w2v))
    return se3.rotation(c2v), se3.translation(c2v), se3.rotation(v2w), se3.translation(v2w)


@pytest.fixture(scope="module")
def rendered():
    cfg = small_config()
    ds = small_dataset(3, degrees_per_frame=1.0)
    engine = XSlamEngine(cfg)
    state = seed_jax_state(engine.init_state(), seeded_pose_direction(2))
    for i in range(3):
        state, _ = engine.process_frame(state, ds.get_depth(i))
    d = jax_state_to_numpy(state)
    tstate = state_from_numpy(d, "cpu")
    w2v = np.asarray(cfg.world2volume, np.float32)
    jvc = jfusion.VolumeConfig(tuple(cfg.tsdf_size), cfg.voxel_size, cfg.trunc_dist, cfg.max_integration_weight)
    tvc = tfusion.VolumeConfig(tuple(cfg.tsdf_size), cfg.voxel_size, cfg.trunc_dist, cfg.max_integration_weight)

    jp = _poses(jse3, jlift, state.world2camera, jnp.asarray(w2v))
    j_rays = jax.jit(functools.partial(jray._camera_rays, intr=engine.intr))(jp[0], jp[1])
    j_hit = jax.jit(functools.partial(jray.march, cfg=jvc))(state.volume.value, j_rays[1], j_rays[0])
    j_maps = jax.jit(functools.partial(jray.raycast, intr=engine.intr, cfg=jvc, packed_taps=False))(
        state.volume, *jp)

    tp = _poses(tse3, tlift, tstate.world2camera, torch.from_numpy(w2v))
    tintr = Intrinsics(*engine.intr)
    t_dir, t_start = tray._camera_rays(tp[0], tp[1], tintr)
    t_hit = kernels.march_fixed(tstate.volume.value, t_start, t_dir, tvc.voxel_size, tvc.trunc_dist)
    t_maps = tray.raycast(tstate.volume, *tp, tintr, tvc)
    return d, tstate, (j_rays, j_hit, j_maps), (t_dir, t_hit, t_maps)


def test_state_roundtrip(rendered):
    d, tstate = rendered[:2]
    back = state_to_numpy(tstate)
    assert back.keys() == d.keys()
    for k, v in d.items():
        for a, b in zip(v if isinstance(v, list) else [v], back[k] if isinstance(v, list) else [back[k]]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_camera_rays(rendered):
    (j_rays, _, _), (t_dir, _, _) = rendered[2], rendered[3]
    np.testing.assert_allclose(t_dir.v.numpy(), np.asarray(j_rays[0].v), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t_dir.g.numpy(), np.asarray(j_rays[0].g), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("event", ["t_found", "t_dead"])
def test_march_events(rendered, event):
    j_hit, t_hit = rendered[2][1], rendered[3][1]
    j = np.asarray(getattr(j_hit, event))
    t = t_hit[0 if event == "t_found" else 1].numpy()
    assert np.mean(j < jray.INF_T) > 0.5  # the rays do hit the fused surface
    step = small_config().trunc_dist * 0.8

    def step_index(x):
        return np.where(x < jray.INF_T, np.round((x - jray.RAY_MIN_M) / step), -1)

    same = step_index(j) == step_index(t)
    assert np.mean(same) >= 0.999
    np.testing.assert_allclose(t[same], j[same], rtol=0, atol=1e-6)


@pytest.mark.parametrize("which", ["vmap", "nmap"])
def test_model_maps(rendered, which):
    j_maps, t_maps = rendered[2][2], rendered[3][2]
    i = 0 if which == "vmap" else 1
    jv, jg = np.asarray(j_maps[i].v), np.asarray(j_maps[i].g)
    tv, tg = t_maps[i].v.numpy(), t_maps[i].g.numpy()
    jf, tf = np.isfinite(jv[0]), np.isfinite(tv[0])
    assert jf.mean() > 0.5
    assert np.mean(jf == tf) >= 0.995
    both = jf & tf
    np.testing.assert_allclose(tv[:, both], jv[:, both], atol=1e-4)
    assert np.abs(jg[:, both]).max() > 0  # the seeded derivative reached the maps
    np.testing.assert_allclose(tg[:, both], jg[:, both], atol=1e-4 * max(1.0, np.abs(jg[:, both]).max()))


def test_other_march_modes_not_ported(rendered):
    tstate = rendered[1]
    with pytest.raises(NotImplementedError):
        tray.raycast(tstate.volume, *([None] * 4), None, None, march_mode="skip")
