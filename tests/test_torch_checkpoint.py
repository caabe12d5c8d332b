"""Checkpoints: the port's ``utils/checkpoint.py`` against the JAX package's.

- A checkpoint written by either package loads in the other with every
  array equal, for the dense (X, Y, Z) planes and the brick layout's
  (NB, 512) rows; one without ``t_prev`` loads with an all-inf anchor map.
- Resuming in the port: bench.py's configuration (the brick layout, whose
  temporal march reads the saved anchors) at 160x120 on the CPU, 4
  frames run straight through against 2 frames, a checkpoint, a new engine
  loading it and running the last 2: the same poses and volume bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import small_config, small_dataset
from tests.torch_port_helpers import torch_config
from xslam_tpu.csfd.single import CSFD as JCSFD
from xslam_tpu.models.kinfu import SlamState as JaxSlamState
from xslam_tpu.ops.bricks import BrickVolume as JaxBrickVolume
from xslam_tpu.ops.fusion import VolumeState as JaxVolumeState
from xslam_tpu.utils import checkpoint as jcheckpoint
from xslam_tpu_torch.models.kinfu import XSlamEngine
from xslam_tpu_torch.ops.bricks import BrickVolume
from xslam_tpu_torch.utils import checkpoint as tcheckpoint
from xslam_tpu_torch.utils.convert import state_from_numpy, state_to_numpy

LEVELS = ((3, 12, 16), (3, 6, 8))


def _arrays(layout, rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    vol = (f(8, 512) if layout == "brick" else f(8, 8, 16) for _ in range(3))
    value, grad, weight = vol
    return {
        "value": value, "grad": grad, "weight": weight,
        "world2camera_v": f(4, 4), "world2camera_g": f(4, 4),
        "vmaps_v": [f(*s) for s in LEVELS], "vmaps_g": [f(*s) for s in LEVELS],
        "nmaps_v": [f(*s) for s in LEVELS], "nmaps_g": [f(*s) for s in LEVELS],
        "frame_idx": 7, "last_align_ok": False, "t_prev": f(12, 16),
    }


def _jax_state(d):
    a = jnp.asarray
    vol = (JaxBrickVolume if d["value"].ndim == 2 else JaxVolumeState)(a(d["value"]), a(d["grad"]), a(d["weight"]))
    return JaxSlamState(
        volume=vol, world2camera=JCSFD(a(d["world2camera_v"]), a(d["world2camera_g"])),
        vmaps_prev=tuple(JCSFD(a(v), a(g)) for v, g in zip(d["vmaps_v"], d["vmaps_g"])),
        nmaps_prev=tuple(JCSFD(a(v), a(g)) for v, g in zip(d["nmaps_v"], d["nmaps_g"])),
        frame_idx=jnp.int32(d["frame_idx"]), last_align_ok=jnp.bool_(d["last_align_ok"]), t_prev=a(d["t_prev"]),
    )


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], list):
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("layout", ["dense", "brick"])
def test_checkpoints_cross_the_packages(tmp_path, layout):
    rng = np.random.default_rng(0)
    d = _arrays(layout, rng)
    log = [rng.standard_normal((4, 4)).astype(np.float32) for _ in range(3)]

    jcheckpoint.save_state(str(tmp_path / "jax.npz"), _jax_state(d), log)
    state, pose_log = tcheckpoint.load_state(str(tmp_path / "jax.npz"))
    assert isinstance(state.volume, BrickVolume) == (layout == "brick")
    assert isinstance(state.frame_idx, int) and state.frame_idx == 7
    _same(state_to_numpy(state), d)
    _same({"log": pose_log}, {"log": log})

    tcheckpoint.save_state(str(tmp_path / "port.npz"), state_from_numpy(d, "cpu"), log)
    jstate, jlog = jcheckpoint.load_state(str(tmp_path / "port.npz"))
    assert isinstance(jstate.volume, JaxBrickVolume) == (layout == "brick")
    assert int(jstate.frame_idx) == 7 and not bool(jstate.last_align_ok)
    for key, x in (("value", jstate.volume.value), ("weight", jstate.volume.weight), ("t_prev", jstate.t_prev),
                   ("world2camera_g", jstate.world2camera.g)):
        np.testing.assert_array_equal(np.asarray(x), d[key])
    for i, m in enumerate(jstate.nmaps_prev):
        np.testing.assert_array_equal(np.asarray(m.g), d["nmaps_g"][i])
    _same({"log": jlog}, {"log": log})


def test_checkpoint_without_anchors_loads_cold(tmp_path):
    d = _arrays("dense", np.random.default_rng(1))
    tcheckpoint.save_state(str(tmp_path / "c.npz"), state_from_numpy(d, "cpu"))
    z = dict(np.load(str(tmp_path / "c.npz")))
    del z["t_prev"]
    np.savez(str(tmp_path / "old.npz"), **z)
    state, pose_log = tcheckpoint.load_state(str(tmp_path / "old"))
    assert pose_log == []
    assert state.t_prev.shape == (12, 16) and bool(torch.isinf(state.t_prev).all())


def test_resume_equals_the_uninterrupted_run(tmp_path):
    cfg = torch_config(small_config(end_frame=4, num_levels=2))
    cfg = dataclasses.replace(
        cfg, volume_layout="brick", fusion_mode="brick", fusion_brick_cap=2816, fusion_overflow="dense",
        raycast_normals="screen", raycast_march="temporal", model_map_level=1, icp_fixed_assoc=True,
        raycast_refine="reuse")
    depths = [small_dataset(4, degrees_per_frame=1.0).get_depth(i) for i in range(4)]

    straight = XSlamEngine(cfg, device="cpu")
    end = straight.init_state()
    for d in depths:
        end, r = straight.process_frame(end, d)
        straight.log_pose(r)

    first = XSlamEngine(cfg, device="cpu")
    s = first.init_state()
    for d in depths[:2]:
        s, r = first.process_frame(s, d)
        first.log_pose(r)
    tcheckpoint.save_state(str(tmp_path / "ckpt.npz"), s, first.pose_log)

    resumed = XSlamEngine(cfg, device="cpu")
    s2, resumed.pose_log = tcheckpoint.load_state(str(tmp_path / "ckpt.npz"), device="cpu")
    assert isinstance(s2.volume, BrickVolume) and s2.frame_idx == 2
    for d in depths[2:]:
        s2, r = resumed.process_frame(s2, d)
        resumed.log_pose(r)
    assert len(resumed.pose_log) == 4
    for a, b in zip(resumed.pose_log, straight.pose_log):
        assert a.tobytes() == b.tobytes()
    for a, b in zip(s2.volume, end.volume):
        assert torch.equal(a, b)
