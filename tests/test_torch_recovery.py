"""The port's recovering engine (``xslam_tpu_torch/models/recovery.py``)
against ``xslam_tpu.models.recovery`` on the CPU, on the small scene of
tests/helpers.py (160x120, 64^3), the port with ``device="cpu"``.

Tolerances, and why:

- ``_depth_maps`` and ``_depth_icp``: bit-equal (the same numpy code).
- The blackout sequence of tests/test_recovery.py:41 through both engines:
  the same decisions (``align_ok`` frame by frame, each recovery event's
  frame and ``accepted``, the keyframes' frame indices, the loop edges'
  keyframe pairs); event losses within PR 15's relocalize tolerance, 1e-4
  relative plus one voxel's worth, 1 / reloc_min_count (a voxel at a mask
  threshold may fall on either side in the two packages); poses within
  1 mm (measured 1.6e-6 over the 11 frames: the engines agree to float32
  rounding through the relocalization).
- ``refine_trajectory`` of the port's 8-frame run, carried across to the JAX
  engine by ``utils/convert.py``: the refined poses within 1e-4 (two
  rounds of re-association at float32 poses; measured 3.0e-7).
"""

import numpy as np
import pytest
import torch

import tests.torch_port_helpers  # noqa: F401  (sets one intra-op thread)
from tests.helpers import SMALL_INTR, small_config, small_dataset, small_scene
from tests.torch_port_helpers import torch_config
from xslam_tpu.geometry import se3 as jse3
from xslam_tpu.io.synthetic import render_depth
from xslam_tpu.models import recovery as jrec
from xslam_tpu_torch.models import recovery as trec
from xslam_tpu_torch.models.ba import build_ba_problem
from xslam_tpu_torch.utils import convert
from xslam_tpu_torch.utils.evaluation import ate_rmse, normalize_to_first

POSE_TOL_M = 1e-3
REFINE_TOL = 1e-4


def _cfg(reloc_after):
    """tests/test_recovery.py:30's configuration."""
    return small_config(end_frame=12, reloc_after_failures=reloc_after, reloc_iters=15, reloc_min_count=200.0,
                        max_translation_per_frame=0.15, min_inlier_fraction=0.35)


def _blackout_seq(ds):
    """5 tracked frames, 2 blank (the camera keeps moving), paused resume."""
    blank = np.zeros_like(ds.get_depth(0))
    return [(i, ds.get_depth(i)) for i in range(5)] + [(4, blank)] * 2 + [(7, ds.get_depth(7))] * 4


def _run(eng, seq):
    state = eng.init_state()
    oks = []
    for _, depth in seq:
        state, res = eng.process_frame(state, depth)
        oks.append(bool(np.asarray(res.align_ok)))
    return oks


def _errs_mm(eng, ds, seq):
    gt = normalize_to_first([ds.get_pose(f) for f, _ in seq])
    return [1000 * np.linalg.norm(e[:3, 3] - g[:3, 3]) for e, g in zip(normalize_to_first(eng.pose_log), gt)]


@pytest.fixture(scope="module")
def blackout():
    ds = small_dataset(n_frames=12, degrees_per_frame=2.5)
    seq = _blackout_seq(ds)
    cfg = _cfg(reloc_after=2)
    j_eng = jrec.RecoveringEngine(cfg)
    j_oks = _run(j_eng, seq)
    t_eng = trec.RecoveringEngine(torch_config(cfg), device="cpu")
    t_oks = _run(t_eng, seq)
    return dict(ds=ds, seq=seq, cfg=cfg, jax=(j_eng, j_oks), port=(t_eng, t_oks))


def _views():
    scene = small_scene()
    Ta = np.eye(4, dtype=np.float32)
    Tb = Ta @ np.asarray(jse3.exp_real(np.array([0.02, -0.03, 0.01, 0.04, -0.02, 0.05], np.float32)))
    da = np.asarray(render_depth(scene, Ta, SMALL_INTR)).astype(np.uint16)
    db = np.asarray(render_depth(scene, Tb, SMALL_INTR)).astype(np.uint16)
    return Ta, Tb, da, db


def test_depth_maps_and_icp_bit_equal():
    """tests/test_recovery.py:142's two views: the vertex and normal maps and
    the verifier's pose, inlier fraction and rms equal JAX's to the bit, and
    the verifier recovers the relative pose."""
    Ta, Tb, da, db = _views()
    for got, ref in zip(trec._depth_maps(da, SMALL_INTR), jrec._depth_maps(da, SMALL_INTR)):
        assert np.array_equal(got, ref, equal_nan=True)
    T_true = np.linalg.inv(Ta) @ Tb
    seed = T_true @ np.asarray(jse3.exp_real(np.array([0.01, 0.015, -0.01, 0.02, -0.015, 0.02], np.float32)))
    T, frac, rms = trec._depth_icp(da, db, seed, SMALL_INTR)
    T_ref, frac_ref, rms_ref = jrec._depth_icp(da, db, seed, SMALL_INTR)
    assert np.array_equal(T, T_ref) and frac == frac_ref and rms == rms_ref
    assert frac > 0.6 and rms < 0.02
    assert np.linalg.norm(T[:3, 3] - T_true[:3, 3]) < 0.01 and np.abs(T[:3, :3] - T_true[:3, :3]).max() < 0.01


def test_blackout_decisions_match_jax(blackout):
    j_eng, j_oks = blackout["jax"]
    t_eng, t_oks = blackout["port"]
    assert t_oks == j_oks
    assert [(e.frame_index, e.accepted) for e in t_eng.recovery_events] == \
        [(e.frame_index, e.accepted) for e in j_eng.recovery_events]
    tol = 1.0 / blackout["cfg"].reloc_min_count
    for te, je in zip(t_eng.recovery_events, j_eng.recovery_events):
        for got, ref in ((te.mean_loss_before, je.mean_loss_before), (te.mean_loss_after, je.mean_loss_after)):
            assert abs(got - ref) <= 1e-4 * abs(ref) + tol, (te, je)
    assert [k.frame_index for k in t_eng.keyframes] == [k.frame_index for k in j_eng.keyframes]
    assert [(i, j) for i, j, _ in t_eng.loop_edges] == [(i, j) for i, j, _ in j_eng.loop_edges]
    assert len(t_eng.pose_log) == len(j_eng.pose_log) == len(blackout["seq"])
    worst = max(float(np.abs(a[:3, 3] - b[:3, 3]).max()) for a, b in zip(t_eng.pose_log, j_eng.pose_log))
    assert worst < POSE_TOL_M, worst
    # the host records cross both ways: the port's record read back gives the same record
    rec = convert.recovery_record_to_numpy(t_eng)
    back = convert.recovery_record_to_numpy(convert.recovery_record_from_numpy(
        trec.RecoveringEngine(torch_config(blackout["cfg"]), device="cpu"), rec))
    assert back["recovery_events"] == rec["recovery_events"] and back["frame_index"] == rec["frame_index"]
    assert all(np.array_equal(a, b) for a, b in zip(back["pose_log"], rec["pose_log"]))


def test_recovery_after_blackout(blackout):
    """tests/test_recovery.py:60's properties in the port: blank frames'
    attempts rejected, a non-blank one descends, no spike past 100 mm, the
    end within 60 mm."""
    t_eng, _ = blackout["port"]
    errs = _errs_mm(t_eng, blackout["ds"], blackout["seq"])
    blanks = [e for e in t_eng.recovery_events if e.mean_loss_before == 0.0]
    assert blanks and all(not e.accepted for e in blanks)
    assert any(0 < e.mean_loss_after < e.mean_loss_before for e in t_eng.recovery_events), t_eng.recovery_events
    assert max(errs) < 100.0, errs
    assert errs[-1] < 60.0, errs


def test_plain_engine_stays_lost():
    """tests/test_recovery.py:91 in the port: without recovery the pose
    freezes at the drift error."""
    ds = small_dataset(n_frames=12, degrees_per_frame=2.5)
    seq = _blackout_seq(ds)
    eng = trec.RecoveringEngine(torch_config(_cfg(reloc_after=0)), device="cpu")
    _run(eng, seq)
    assert not eng.recovery_events
    assert _errs_mm(eng, ds, seq)[-1] > 150.0


def test_relocalization_records_loop_closure(blackout):
    """tests/test_ba_live.py:114 in the port: the far relocalization leaves a
    loop edge against keyframe 0, consistent with the keyframes, that
    ``refine_keyframes`` consumes."""
    t_eng, _ = blackout["port"]
    far = [e for e in t_eng.recovery_events if e.pose_jump_m > blackout["cfg"].keyframe_dist]
    assert far and t_eng.loop_edges, t_eng.recovery_events
    i, j, T = t_eng.loop_edges[-1]
    assert i == 0 and 0 < j < len(t_eng.keyframes)
    np.testing.assert_allclose(T, np.linalg.inv(t_eng.keyframes[0].camera2world) @ t_eng.keyframes[j].camera2world,
                               atol=1e-5)
    assert np.isfinite(t_eng.refine_keyframes(iters=5)).all()


def test_keyframes_and_pose_graph():
    """tests/test_recovery.py:102 in the port: keyframe gating, and an
    odometry-only pose graph that keeps the keyframes where they are."""
    n = 10
    ds = small_dataset(n_frames=n, degrees_per_frame=3.0)
    eng = trec.RecoveringEngine(torch_config(small_config(end_frame=n, keyframe_dist=0.05, keyframe_angle_deg=4.0)),
                                device="cpu")
    _run(eng, [(i, ds.get_depth(i)) for i in range(n)])
    assert len(eng.keyframes) >= 3
    refined = eng.refine_keyframes(iters=5)
    assert refined.shape == (len(eng.keyframes), 4, 4)
    for kf, T in zip(eng.keyframes, refined):
        assert float(np.linalg.norm(kf.camera2world[:3, 3] - T[:3, 3])) < 1e-3


def _bare(module, cfg):
    """A ``RecoveringEngine`` of ``module`` without an engine: the keyframe,
    loop and backend machinery only (tests/test_recovery.py:186)."""
    eng = module.RecoveringEngine.__new__(module.RecoveringEngine)
    eng.config, eng.intr = cfg, SMALL_INTR
    eng.keyframes, eng.loop_edges, eng._frame_index = [], [], 0
    return eng


def test_loop_detection_fires_on_revisit():
    """tests/test_recovery.py:176 through both packages: a walk that returns
    to its start closes a loop to keyframe 0 or 1, with JAX's edges."""
    scene = small_scene()
    cfg = small_config(loop_detect=True, loop_min_gap=4, keyframe_dist=1e-6, keyframe_angle_deg=1e-6)
    engines = [_bare(trec, torch_config(cfg)), _bare(jrec, cfg)]
    offsets = [[0.0, 0.0, 0.0], [0.25, 0.0, 0.0], [0.5, 0.0, 0.0], [0.5, 0.25, 0.0], [0.25, 0.25, 0.0],
               [0.02, 0.01, 0.0]]  # the last revisits keyframe 0
    for i, off in enumerate(offsets):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = off
        depth = np.asarray(render_depth(scene, c2w, SMALL_INTR)).astype(np.uint16)
        for eng in engines:
            eng._frame_index = i
            eng._maybe_keyframe(c2w, depth)
    port, ref = engines
    assert len(port.keyframes) == 6 and len(port.loop_edges) >= 1
    j, k, T = port.loop_edges[-1]
    assert k == 5 and j <= 1
    T_true = np.linalg.inv(port.keyframes[j].camera2world) @ port.keyframes[k].camera2world
    assert np.linalg.norm(T[:3, 3] - T_true[:3, 3]) < 0.02
    assert [(a, b) for a, b, _ in port.loop_edges] == [(a, b) for a, b, _ in ref.loop_edges]
    assert all(np.array_equal(x[2], y[2]) for x, y in zip(port.loop_edges, ref.loop_edges))


def test_ba_observation_budget_coarsens_stride():
    """tests/test_ba_live.py:160 in the port: ``refine_keyframes_ba``
    coarsens the anchor stride until the problem fits ``max_obs``."""
    scene = small_scene()
    eng = _bare(trec, torch_config(small_config()))
    eng.device = torch.device("cpu")
    poses = []
    for k in range(5):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [0.05 * k, 0.0, 0.0]
        eng.keyframes.append(trec.Keyframe(k, c2w, np.asarray(render_depth(scene, c2w, SMALL_INTR)).astype(np.uint16)))
        poses.append(c2w)
    depths = [k.depth_u16 for k in eng.keyframes]
    n4, _ = build_ba_problem(poses, depths, SMALL_INTR, stride=4)
    assert int(n4.frame_idx.shape[0]) > 2000
    assert eng.refine_keyframes_ba(stride=4, rounds=1, max_obs=2000).shape == (5, 4, 4)
    s = 4
    while True:
        p, _ = build_ba_problem(poses, depths, SMALL_INTR, stride=s)
        if p is None or int(p.frame_idx.shape[0]) <= 2000:
            break
        s *= 2
    assert s > 4 and (p is None or int(p.frame_idx.shape[0]) <= 2000)


def test_refine_trajectory_matches_jax():
    """tests/test_ba_live.py:88 in the port (8 frames, every frame a
    keyframe with its depth; the refinement keeps the trajectory), then the
    run's record carried to a JAX ``RecoveringEngine`` by ``utils/convert``:
    JAX's ``refine_trajectory`` on the same keyframes gives the port's."""
    n = 8
    ds = small_dataset(n, degrees_per_frame=2.5)
    cfg = small_config(end_frame=n, keyframe_dist=0.0, keyframe_angle_deg=0.0)
    eng = trec.RecoveringEngine(torch_config(cfg), device="cpu")
    _run(eng, [(i, ds.get_depth(i)) for i in range(n)])
    assert len(eng.keyframes) >= n - 1 and all(k.depth_u16 is not None for k in eng.keyframes)
    refined = eng.refine_trajectory(use_ba=True)
    assert refined.shape == (n, 4, 4) and np.isfinite(refined).all()
    gt = normalize_to_first([ds.get_pose(i) for i in range(n)])
    ate_raw = ate_rmse(normalize_to_first(eng.pose_log), gt)
    ate_ref = ate_rmse(normalize_to_first(list(refined)), gt)
    assert eng.last_ba_residuals.shape == (8,) and np.isfinite(eng.last_ba_residuals).all()
    assert ate_ref < max(1.2 * ate_raw, ate_raw + 0.002), (ate_raw, ate_ref)

    rec = convert.recovery_record_to_numpy(eng)
    ref_eng = _bare(jrec, cfg)
    ref_eng.pose_log = rec["pose_log"]
    ref_eng.keyframes = [jrec.Keyframe(*k) for k in rec["keyframes"]]
    ref_eng.loop_edges = rec["loop_edges"]
    ref = ref_eng.refine_trajectory(use_ba=True)
    np.testing.assert_allclose(refined, ref, atol=REFINE_TOL)
    np.testing.assert_allclose(eng.last_ba_residuals, ref_eng.last_ba_residuals, rtol=1e-4)
