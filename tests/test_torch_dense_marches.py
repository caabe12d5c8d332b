"""The dense layout's marches (B14a ``skip_field_dense``, B14b
``march_skip_dense``, B14c ``window_march_dense``, K3 with a stride) and the
raycast in every ``MARCH_MODES`` entry, in the port against the JAX package
on a 64^3 volume fused by the JAX engine from a derivative-seeded pose (three
frames of the small sweep, 120x160 rays), carried across with
``state_from_numpy``.

Tolerances:
- the brick distance field and the packed skip volume: equal, every brick
  and voxel (integer and select arithmetic only);
- march events (``skip``, ``hier``, ``hier_skip``, ``hier2``): both events at
  the same step on >= 99.9% of rays, as ``tests/test_torch_raycast.py``
  holds K3's plain twin (a sample on a floor boundary may pick the
  neighbouring voxel where XLA fuses a multiply-add), and event times within
  1e-6 m where both record one;
- the skip march against the port's fixed march on the same rays: the same
  accepted rays and the same ``t_found`` on each, exactly (the JAX package's
  own claim, ``tests/test_march_skip.py``);
- K3 at stride 2 and 4: the stride-1 march's events at the strided pixels,
  exactly;
- the raycast's maps in each mode, with TSDF and screen normals (the screen
  normals through ``model_map_pyramid(vmap, None, 1)``, B4n's plain
  version): finite masks on >= 99.5% of pixels, values within 1e-4 where
  both are finite (derivative lanes relative to their largest entry), as
  ``tests/test_torch_raycast.py::test_model_maps``.
"""

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
from xslam_tpu_torch.models.kinfu import model_map_pyramid
from xslam_tpu_torch.ops import fusion as tfusion
from xslam_tpu_torch.ops import kernels
from xslam_tpu_torch.ops import raycast as tray
from xslam_tpu_torch.ops.kernels import INF_T
from xslam_tpu_torch.utils.convert import state_from_numpy

WINDOW = 12


def _poses(se3, lift, w2c, w2v):
    c2w = se3.inverse(w2c)
    c2v = se3.matmul(lift(w2v), c2w)
    v2w = se3.inverse(lift(w2v))
    return se3.rotation(c2v), se3.translation(c2v), se3.rotation(v2w), se3.translation(v2w)


@pytest.fixture(scope="module")
def scene():
    cfg = small_config()
    ds = small_dataset(3, degrees_per_frame=1.0)
    engine = XSlamEngine(cfg)
    state = seed_jax_state(engine.init_state(), seeded_pose_direction(2))
    for i in range(3):
        state, _ = engine.process_frame(state, ds.get_depth(i))
    tstate = state_from_numpy(jax_state_to_numpy(state), "cpu")
    w2v = np.asarray(cfg.world2volume, np.float32)
    args = (tuple(cfg.tsdf_size), cfg.voxel_size, cfg.trunc_dist, cfg.max_integration_weight)
    jvc, tvc = jfusion.VolumeConfig(*args), tfusion.VolumeConfig(*args)
    jp = _poses(jse3, jlift, state.world2camera, jnp.asarray(w2v))
    ray_dir, ray_start = jax.jit(functools.partial(jray._camera_rays, intr=engine.intr))(jp[0], jp[1])
    tp = _poses(tse3, tlift, tstate.world2camera, torch.from_numpy(w2v))
    return dict(jvol=state.volume, jp=jp, ray_dir=ray_dir, ray_start=ray_start, jvc=jvc, jintr=engine.intr,
                tvol=tstate.volume, tp=tp, pose=kernels.pack_ray_pose(*tp), tvc=tvc, tintr=Intrinsics(*engine.intr))


def _events_close(j, t):
    """Both events at the same step on >= 99.9% of rays, times within 1e-6 m where both record one."""
    for name in ("t_found", "t_dead"):
        a, b = np.asarray(getattr(j, name)), getattr(t, name).numpy()
        assert a.shape == b.shape
        same = (a >= INF_T) == (b >= INF_T)
        both = (a < INF_T) & (b < INF_T)
        assert np.mean(same & (~both | (np.abs(a - b) <= 1e-6))) >= 0.999, name
    assert np.mean(np.asarray(j.t_found) < INF_T) > 0.5  # most rays hit


def test_brick_distance_field_and_skip_volume_equal_jax(scene):
    jv, tv = scene["jvol"], scene["tvol"]
    jd = np.asarray(jray.brick_distance_field(jv.value, jv.weight))
    td = tray.brick_distance_field(tv.value, tv.weight).numpy()
    np.testing.assert_array_equal(td, jd)
    assert (jd == 0).any() and (jd >= 2).any()  # event bricks, and bricks a march may jump
    np.testing.assert_array_equal(tray.skip_volume(tv.value, tv.weight).numpy(),
                                  np.asarray(jray.skip_volume(jv.value, jv.weight)))
    # B14a's wrapper on CPU tensors: the field in brick order
    np.testing.assert_array_equal(tray.skip_field_dense(tv, scene["tvc"].resolution).numpy(), jd.reshape(-1))


def test_march_skip_dense_matches_jax_and_the_fixed_march(scene):
    jv, tv, tvc = scene["jvol"], scene["tvol"], scene["tvc"]
    jhit = jax.jit(lambda v: jray.march_skip(v.value, v.weight, scene["ray_start"], scene["ray_dir"], scene["jvc"]))(jv)
    dist = tray.skip_field_dense(tv, tvc.resolution)
    thit = tray.march_skip_dense(tv, dist, scene["pose"], scene["tintr"], tvc)
    _events_close(jhit, thit)
    # the port's skip march against its fixed march on the same rays: the same accepted rays and crossing times
    ff, fd = kernels.march_fixed(tv.value, scene["pose"], scene["tintr"], tvc.voxel_size, tvc.trunc_dist)
    acc_f = ff < torch.clamp(fd, max=INF_T)
    acc_s = thit.t_found < torch.clamp(thit.t_dead, max=INF_T)
    assert int(acc_f.sum()) > 5000 and torch.equal(acc_f, acc_s)
    assert torch.equal(ff[acc_f], thit.t_found[acc_s])


@pytest.mark.parametrize("skip", [False, True], ids=["hier", "hier_skip"])
def test_march_hier_matches_jax(scene, skip):
    jv, tv = scene["jvol"], scene["tvol"]
    jhit = jax.jit(lambda v: jray.march_hier(v.value, scene["ray_start"], scene["ray_dir"], scene["jvc"],
                                             window=WINDOW, weight=v.weight if skip else None))(jv)
    thit = tray.march_hier(tv, scene["pose"], scene["tintr"], scene["tvc"], WINDOW, skip=skip)
    _events_close(jhit, thit)


def test_march_hier2_matches_jax(scene):
    jv, tv = scene["jvol"], scene["tvol"]
    jhit = jax.jit(lambda v: jray.march_hier2(v.value, scene["ray_start"], scene["ray_dir"], scene["jvc"], window=8))(jv)
    thit = tray.march_hier2(tv, scene["pose"], scene["tintr"], scene["tvc"], 8)
    _events_close(jhit, thit)


@pytest.mark.parametrize("stride", [2, 4])
def test_strided_fixed_march_is_the_full_march_subsampled(scene, stride):
    tv, tvc = scene["tvol"], scene["tvc"]
    full = kernels.march_fixed(tv.value, scene["pose"], scene["tintr"], tvc.voxel_size, tvc.trunc_dist)
    part = kernels.march_fixed(tv.value, scene["pose"], scene["tintr"], tvc.voxel_size, tvc.trunc_dist, stride=stride)
    assert tuple(part[0].shape) == (kernels.strided(120, stride), kernels.strided(160, stride))
    for a, b in zip(full, part):
        assert torch.equal(a[::stride, ::stride], b)


@pytest.fixture(scope="module")
def jax_raycasts(scene):
    """JAX's raycast of each march mode with TSDF normals, and the screen
    normals of its vertex map (what ``normals_mode="screen"`` returns)."""
    out = {}
    for mode in tray.MARCH_MODES:
        vmap, nmap = jax.jit(functools.partial(jray.raycast, intr=scene["jintr"], cfg=scene["jvc"], march_mode=mode,
                                               hier_window=WINDOW, packed_taps=False))(scene["jvol"], *scene["jp"])
        out[mode] = vmap, nmap, jray.screen_normals(vmap)
    return out


def _maps_close(j, t):
    jv, jg, tv, tg = np.asarray(j.v), np.asarray(j.g), t.v.numpy(), t.g.numpy()
    jf, tf = np.isfinite(jv[0]), np.isfinite(tv[0])
    assert jf.mean() > 0.5
    assert np.mean(jf == tf) >= 0.995
    both = jf & tf
    np.testing.assert_allclose(tv[:, both], jv[:, both], atol=1e-4)
    np.testing.assert_allclose(tg[:, both], jg[:, both], atol=1e-4 * max(1.0, np.abs(jg[:, both]).max()))


@pytest.mark.parametrize("normals", ["tsdf", "screen"])
@pytest.mark.parametrize("mode", tray.MARCH_MODES)
def test_raycast_modes_match_jax(scene, jax_raycasts, mode, normals):
    jv, jn, jscreen = jax_raycasts[mode]
    vmap, nmap = tray.raycast(scene["tvol"], *scene["tp"], scene["tintr"], scene["tvc"], normals_mode=normals,
                              march_mode=mode, hier_window=WINDOW)
    _maps_close(jv, vmap)
    if normals == "screen":
        assert nmap is None  # left to the model-map pyramid's launch (B4n)
        nmap = model_map_pyramid(vmap, None, 1)[1][0]
        jn = jscreen
    _maps_close(jn, nmap)


@pytest.mark.parametrize("option", [dict(packed_taps=True, march_mode="temporal"),
                                    dict(compact=True, normals_mode="none"), dict(march_mode="hier2_skip")],
                         ids=["packed_taps", "compact", "hier2_skip"])
def test_raycast_options_outside_the_port_raise(scene, option):
    """What the dense layout's raycast refuses with ValueError: the brick
    layout's marches (as JAX's ``raycast`` does) and an unknown normals mode
    (the port's own check), whatever the packed taps and the compaction
    (which run: tests/test_torch_raycast_options.py)."""
    with pytest.raises(ValueError):
        tray.raycast(scene["tvol"], *scene["tp"], scene["tintr"], scene["tvc"], **option)


def test_dense_marches_launch_nothing_on_cpu(scene):
    for name in ("skip_field_dense", "march_skip_dense", "window_march_dense", "march_fixed_strided"):
        assert kernels.launch_counts[name] == 0
