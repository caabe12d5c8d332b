"""The port's frame-to-frame odometry (``xslam_tpu_torch.models.odometry``)
against the JAX engine on the small orbit (``small_config()``, 0.5 degrees a
frame, tests/test_odometry.py's input).

(a) 6 frames through both engines from scratch: every frame aligns on both,
    both ATEs under 0.1 m (tests/test_odometry.py's bound), and the first
    tracked pose (frame 1) within 5e-4 of JAX's: later poses drift apart
    from ulp-level differences of the ICP's sums, as the engines' do.
(b) A state carried across: the JAX engine runs 3 frames, its state crosses
    as numpy (``utils/convert.py``), both engines track the 4th frame from
    it: pose within 5e-4, its derivative lane within 5e-4 of its largest
    entry.
(c) ``device=None`` needs CUDA: no fallback to the CPU.
"""

import numpy as np
import pytest
import torch

from tests.helpers import small_config, small_dataset
from tests.torch_port_helpers import torch_config
from xslam_tpu.models.odometry import OdometryEngine as JaxOdometry
from xslam_tpu.utils.evaluation import ate_rmse, normalize_to_first
from xslam_tpu_torch.models.odometry import OdometryEngine
from xslam_tpu_torch.utils import convert

N_FRAMES = 6
CARRY_AT = 3


@pytest.fixture(scope="module")
def runs():
    cfg = small_config(end_frame=N_FRAMES)
    ds = small_dataset(N_FRAMES, degrees_per_frame=0.5)
    depths = [ds.get_depth(i) for i in range(N_FRAMES)]
    gt = normalize_to_first([ds.get_pose(i) for i in range(N_FRAMES)])

    jeng = JaxOdometry(cfg)
    jstate = jeng.init_state()
    j_ok, carried, j_carry_pose = [], None, None
    for i in range(N_FRAMES):
        if i == CARRY_AT:
            carried = {
                "world2camera_v": np.array(jstate.world2camera.v), "world2camera_g": np.array(jstate.world2camera.g),
                "vmaps": [np.array(m) for m in jstate.vmaps_prev], "nmaps": [np.array(m) for m in jstate.nmaps_prev],
                "prev_c2w_v": np.array(jstate.prev_c2w.v), "prev_c2w_g": np.array(jstate.prev_c2w.g),
                "frame_idx": int(jstate.frame_idx),
            }
        jstate, res = jeng.process_frame(jstate, depths[i])
        jeng.log_pose(res)
        j_ok.append(bool(res.align_ok))
        if i == CARRY_AT:
            j_carry_pose = (np.array(res.camera2world.v), np.array(res.camera2world.g))

    teng = OdometryEngine(torch_config(cfg), device="cpu")
    tstate = teng.init_state()
    t_ok = []
    for i in range(N_FRAMES):
        tstate, res = teng.process_frame(tstate, depths[i])
        teng.log_pose(res)
        t_ok.append(bool(res.align_ok))

    carried_state = convert.odometry_state_from_numpy(carried, "cpu")
    back = convert.odometry_state_to_numpy(carried_state)
    _, t_carry = teng.process_frame(carried_state, depths[CARRY_AT])
    return dict(jeng=jeng, teng=teng, j_ok=j_ok, t_ok=t_ok, gt=gt, carried=carried, back=back,
                j_carry=j_carry_pose, t_carry=(t_carry.camera2world.v.numpy(), t_carry.camera2world.g.numpy()))


def test_every_frame_aligns(runs):
    assert all(runs["j_ok"]) and all(runs["t_ok"]), (runs["j_ok"], runs["t_ok"])


def test_both_ates_bounded(runs):
    j_ate = ate_rmse(normalize_to_first(runs["jeng"].pose_log), runs["gt"])
    t_ate = ate_rmse(normalize_to_first(runs["teng"].pose_log), runs["gt"])
    print(f"ATE JAX {j_ate:.6g} m, port {t_ate:.6g} m")
    assert j_ate < 0.1 and t_ate < 0.1


def test_first_tracked_pose_matches(runs):
    np.testing.assert_allclose(runs["teng"].pose_log[1], runs["jeng"].pose_log[1], rtol=0, atol=5e-4)
    np.testing.assert_array_equal(runs["teng"].pose_log[0], np.eye(4, dtype=np.float32))


def test_carried_state_step_matches(runs):
    for key, value in runs["carried"].items():
        if isinstance(value, list):
            for a, b in zip(runs["back"][key], value):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(runs["back"][key], value)
    (jv, jg), (tv, tg) = runs["j_carry"], runs["t_carry"]
    np.testing.assert_allclose(tv, jv, rtol=0, atol=5e-4)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=5e-4 * max(1.0, np.abs(jg).max()))


def test_engine_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        OdometryEngine(torch_config(small_config()))
