"""The port's whole SLAM step (``xslam_tpu_torch.models.kinfu``) against the JAX
engine on the small synthetic sweep, ``small_config()`` defaults (the dense
reference configuration).

(a) One step from a carried state: the JAX engine runs 3 frames from a
    derivative-seeded pose, its state is carried across, and both engines
    process the 4th frame. Pose within 1e-4, weights equal on >= 99.99% of
    voxels, model-map masks agreeing on >= 99.5% of pixels.
(b) A 6-frame run from scratch on both sides: every frame aligns, both ATEs
    under 0.06 m (tests/test_e2e_slam.py's bound) and within 5e-3 m of each
    other: trajectories diverge chaotically from 1-ulp differences
    (xslam_tpu/models/kinfu.py::process_frames), so runs are compared by
    ATE class, not pose by pose.
(c) No fallback and no silent configuration: ``device=None`` needs CUDA,
    and options outside the ported slice raise.
(d) The engine's other options of the dense path (oracle poses, rejection
    gates, damping) behave as the JAX engine's tests require.
(e) The ICP options: ``icp_fixed_assoc=True``, ``model_map_level=1`` with
    ``num_levels=2`` (tests/test_bricks.py's choice: three levels would leave
    a 20x15 coarsest model map on this input) and both together, each a
    6-frame run on both engines in the same ATE class as (b), with state
    shapes equal to the JAX state's.
(f) The stages as the engine composes them from the kernels' wrappers: the
    model-map pyramid of a processed frame is ``resize_model_maps`` applied
    level by level to its finest maps, bit for bit, and the engine's cached
    volume->world pose gives the state that inverting it every frame gives.
"""

import numpy as np
import pytest
import torch

from tests.helpers import small_config, small_dataset
from tests.torch_port_helpers import jax_state_to_numpy, seed_jax_state, seeded_pose_direction, torch_config
from xslam_tpu.models.kinfu import XSlamEngine as JaxEngine
from xslam_tpu.utils.evaluation import ate_rmse, normalize_to_first
from xslam_tpu_torch.geometry import se3 as tse3
from xslam_tpu_torch.models import kinfu as tkinfu
from xslam_tpu_torch.models.kinfu import XSlamEngine as TorchEngine
from xslam_tpu_torch.ops import kernels
from xslam_tpu_torch.utils.convert import state_from_numpy

N_FRAMES = 6
CARRY_AT = 3


@pytest.fixture(scope="module")
def runs():
    cfg = small_config(end_frame=N_FRAMES)
    ds = small_dataset(N_FRAMES, degrees_per_frame=1.0)
    depths = [ds.get_depth(i) for i in range(N_FRAMES)]

    # JAX: one engine (one compile) for the seeded carry and the plain run
    jeng = JaxEngine(cfg)
    jstate = seed_jax_state(jeng.init_state(), seeded_pose_direction(3))
    for i in range(CARRY_AT):
        jstate, _ = jeng.process_frame(jstate, depths[i])
    carried = jax_state_to_numpy(jstate)  # before the next call donates it
    jstate, jres = jeng.process_frame(jstate, depths[CARRY_AT])
    jax_step = (jax_state_to_numpy(jstate), np.array(jres.camera2world.v), np.array(jres.camera2world.g))

    jstate = jeng.init_state()
    jax_run = []
    for i in range(N_FRAMES):
        jstate, jres = jeng.process_frame(jstate, depths[i])
        jax_run.append((np.array(jres.camera2world.v), bool(jres.align_ok)))

    teng = TorchEngine(torch_config(cfg), device="cpu")
    tstate, tres = teng.process_frame(state_from_numpy(carried, "cpu"), depths[CARRY_AT])
    torch_step = (tstate, tres)

    tstate = teng.init_state()
    torch_run = []
    for i in range(N_FRAMES):
        tstate, tres = teng.process_frame(tstate, depths[i])
        teng.log_pose(tres)
        torch_run.append((teng.pose_log[-1], bool(tres.align_ok)))
    gt = normalize_to_first([ds.get_pose(i) for i in range(N_FRAMES)])
    return jax_step, torch_step, jax_run, torch_run, gt


def test_one_step_pose(runs):
    (_, jv, jg), (_, tres) = runs[0], runs[1]
    assert bool(tres.align_ok)
    np.testing.assert_allclose(tres.camera2world.v.numpy(), jv, atol=1e-4)
    assert np.abs(jg).max() > 0  # the seeded derivative went through tracking
    np.testing.assert_allclose(tres.camera2world.g.numpy(), jg, atol=1e-3 * max(1.0, np.abs(jg).max()))


def test_one_step_volume(runs):
    (jstate, _, _), (tstate, _) = runs[0], runs[1]
    jw, tw = jstate["weight"], tstate.volume.weight.numpy()
    assert (jw > 0).sum() > 5000
    assert np.mean(jw == tw) >= 0.9999
    same = jw == tw
    np.testing.assert_allclose(tstate.volume.value.numpy()[same], jstate["value"][same], atol=1e-4)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_one_step_model_maps(runs, level):
    (jstate, _, _), (tstate, _) = runs[0], runs[1]
    for key, maps in (("vmaps", tstate.vmaps_prev), ("nmaps", tstate.nmaps_prev)):
        j = jstate[f"{key}_v"][level]
        t = maps[level].v.numpy()
        jf, tf = np.isfinite(j[0]), np.isfinite(t[0])
        assert jf.mean() > 0.4
        assert np.mean(jf == tf) >= 0.995
        np.testing.assert_allclose(t[:, jf & tf], j[:, jf & tf], atol=1e-3)


def test_six_frame_run_aligns(runs):
    jax_run, torch_run = runs[2], runs[3]
    assert all(ok for _, ok in jax_run)
    assert all(ok for _, ok in torch_run)


def test_six_frame_ate_class(runs):
    jax_run, torch_run, gt = runs[2], runs[3], runs[4]
    ate_j = ate_rmse(normalize_to_first([p for p, _ in jax_run]), gt)
    ate_t = ate_rmse(normalize_to_first([p for p, _ in torch_run]), gt)
    assert ate_j < 0.06 and ate_t < 0.06, (ate_j, ate_t)
    assert abs(ate_j - ate_t) < 5e-3, (ate_j, ate_t)
    np.testing.assert_allclose(torch_run[1][0], jax_run[1][0], atol=1e-4)  # the first tracked frame


def test_cpu_run_launches_no_kernel(runs):
    assert set(kernels.launch_counts) >= {
        "bilateral_filter", "fuse_volume", "march_fixed", "icp_system", "raycast_refine", "resize_model_maps",
        "depth_pyramid", "vertex_normal_maps", "depth_mips", "classify_bricks", "fuse_bricks"}
    assert all(n == 0 for n in kernels.launch_counts.values()), kernels.launch_counts


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None selects it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchEngine(torch_config(small_config()))


@pytest.mark.parametrize("case", ["brick_layout_dense_fusion"])
def test_options_outside_the_slice_raise(case):
    """The JAX engine's own checks raise as there (the brick layout needs
    brick fusion). B15's fusion options, which raised here, now run:
    tests/test_torch_fusion_classifier_runs.py; the observation-sharded BA
    runs: tests/test_torch_sharded_backend.py."""
    with pytest.raises(ValueError, match="fusion_mode='brick'"):
        TorchEngine(torch_config(small_config(volume_layout="brick", fusion_mode="dense")), device="cpu")


def _port_run(n, **options):
    cfg = small_config(end_frame=n, **options)
    ds = small_dataset(n, degrees_per_frame=1.0)
    engine = TorchEngine(torch_config(cfg), device="cpu")
    state = engine.init_state()
    oks = []
    for i in range(n):
        state, res = engine.process_frame(state, ds.get_depth(i), gt_pose=ds.get_pose(i))
        engine.log_pose(res)
        oks.append(bool(res.align_ok))
    return ds, engine, state, oks


def test_use_gt_pose_mode():
    """Oracle-pose ablation (flag_use_gtPose), as tests/test_e2e_slam.py
    checks it of the JAX engine."""
    ds, engine, state, _ = _port_run(3, use_gt_pose=True)
    np.testing.assert_allclose(engine.pose_log[2], ds.get_pose(2), atol=1e-6)
    assert (state.volume.weight > 0).sum() > 5000


@pytest.mark.parametrize("option", [dict(min_inlier_fraction=1.0), dict(max_translation_per_frame=1e-9)])
def test_rejection_gates_keep_the_previous_pose(option):
    """A gate that no frame can pass rejects every tracked frame: the pose
    stays at frame 0's and the volume is fused from frame 0 only."""
    _, engine, state, oks = _port_run(3, **option)
    assert oks == [True, False, False]
    np.testing.assert_array_equal(engine.pose_log[2], np.eye(4, dtype=np.float32))
    assert float(state.volume.weight.max()) == 1.0


def test_damped_icp_tracks():
    _, engine, _, oks = _port_run(3, icp_damping=1e-3)
    assert all(oks)
    assert np.abs(engine.pose_log[2] - engine.pose_log[0]).max() > 1e-3  # it moved with the camera


ICP_OPTIONS = {
    "fixed_assoc": dict(icp_fixed_assoc=True),
    "halfres_maps": dict(model_map_level=1, num_levels=2),
    "fixed_assoc_halfres_maps": dict(icp_fixed_assoc=True, model_map_level=1, num_levels=2),
}


@pytest.fixture(scope="module", params=list(ICP_OPTIONS))
def option_runs(request):
    """A 6-frame run of both engines under one set of ICP options:
    (JAX poses and flags, JAX final state, port poses and flags, port state, gt)."""
    options = ICP_OPTIONS[request.param]
    cfg = small_config(end_frame=N_FRAMES, **options)
    ds = small_dataset(N_FRAMES, degrees_per_frame=1.0)
    jeng = JaxEngine(cfg)
    jstate = jeng.init_state()
    jax_run = []
    for i in range(N_FRAMES):
        jstate, jres = jeng.process_frame(jstate, ds.get_depth(i))
        jax_run.append((np.array(jres.camera2world.v), bool(jres.align_ok)))
    teng = TorchEngine(torch_config(cfg), device="cpu")
    tstate = teng.init_state()
    init_shapes = [tuple(m.v.shape) for m in tstate.vmaps_prev] + [tuple(tstate.t_prev.shape)]
    torch_run = []
    for i in range(N_FRAMES):
        tstate, tres = teng.process_frame(tstate, ds.get_depth(i))
        teng.log_pose(tres)
        torch_run.append((teng.pose_log[-1], bool(tres.align_ok)))
    gt = normalize_to_first([ds.get_pose(i) for i in range(N_FRAMES)])
    return jax_run, jax_state_to_numpy(jstate), torch_run, tstate, gt, init_shapes


def test_icp_option_run_ate_class(option_runs):
    jax_run, _, torch_run, _, gt, _ = option_runs
    assert all(ok for _, ok in jax_run) and all(ok for _, ok in torch_run)
    ate_j = ate_rmse(normalize_to_first([p for p, _ in jax_run]), gt)
    ate_t = ate_rmse(normalize_to_first([p for p, _ in torch_run]), gt)
    assert ate_j < 0.06 and ate_t < 0.06, (ate_j, ate_t)
    assert abs(ate_j - ate_t) < 5e-3, (ate_j, ate_t)
    # The first tracked frame, within 5e-4: a cached association keeps a pixel
    # whose target flipped at a rounding tie for the whole level, so 1-ulp
    # differences reach the pose. With the cache and half-resolution maps the
    # jitted JAX engine itself lies 1.2e-4 from the JAX functions run eagerly,
    # while the port agrees with the eager run to 1e-7.
    np.testing.assert_allclose(torch_run[1][0], jax_run[1][0], atol=5e-4)


def test_icp_option_state_shapes(option_runs):
    _, jstate, _, tstate, _, init_shapes = option_runs
    for key, maps in (("vmaps", tstate.vmaps_prev), ("nmaps", tstate.nmaps_prev)):
        assert [tuple(m.v.shape) for m in maps] == [j.shape for j in jstate[f"{key}_v"]]
        assert [tuple(m.g.shape) for m in maps] == [j.shape for j in jstate[f"{key}_g"]]
    assert tuple(tstate.t_prev.shape) == jstate["t_prev"].shape
    # init_state already has the shapes the steps keep
    assert init_shapes == [tuple(m.v.shape) for m in tstate.vmaps_prev] + [tuple(tstate.t_prev.shape)]
    assert int(tstate.frame_idx) == jstate["frame_idx"]


def test_min_inlier_fraction_counts_model_map_pixels():
    """The inlier gate counts against the model map's pixels,
    (H >> L) * (W >> L): at ``model_map_level=1`` a fraction of 1.0 asks for
    4800 inliers of the 160x120 frame, which tracking reaches, not for all
    19200 pixels, which it cannot."""
    ds, engine, state, oks = _port_run(3, model_map_level=1, num_levels=2, min_inlier_fraction=1.0)
    assert oks == [True, True, True]
    assert np.abs(engine.pose_log[2] - engine.pose_log[0]).max() > 1e-3  # tracked, not frozen
    _, _, _, oks_full = _port_run(3, model_map_level=0, num_levels=2, min_inlier_fraction=1.0)
    assert oks_full == [True, False, False]


@pytest.mark.parametrize("level", [1, 2])
def test_model_map_pyramid_is_the_wrappers_composition(runs, level):
    tstate = runs[1][0]
    vmap, nmap = tstate.vmaps_prev[0], tstate.nmaps_prev[0]
    for _ in range(level):
        vmap, nmap = tkinfu.resize_model_maps(vmap, nmap)
    for got, want in ((vmap, tstate.vmaps_prev[level]), (nmap, tstate.nmaps_prev[level])):
        assert torch.equal(got.v.view(torch.int32), want.v.view(torch.int32))
        assert torch.equal(got.g.view(torch.int32), want.g.view(torch.int32))


def test_cached_volume2world_gives_the_same_frame():
    cfg = small_config(end_frame=2)
    ds = small_dataset(2, degrees_per_frame=1.0)
    engine = TorchEngine(torch_config(cfg), device="cpu")
    inverse = tse3.inverse(engine.world2volume)
    assert torch.equal(engine.volume2world.v, inverse.v) and torch.equal(engine.volume2world.g, inverse.g)
    # the engine's frame is the module's frame at the two constants the engine holds
    a, b = engine.init_state(), engine.init_state()
    for i in range(2):
        a, _ = engine.process_frame(a, ds.get_depth(i))
        b, _ = tkinfu.process_frame(
            b, torch.as_tensor(np.asarray(ds.get_depth(i), np.uint16)), np.eye(4, dtype=np.float32),
            config=engine.config, intr=engine.intr, vol_cfg=engine.vol_cfg, world2volume=engine.world2volume,
            volume2world=inverse)
    assert torch.equal(a.world2camera.v, b.world2camera.v)
    assert torch.equal(a.volume.value, b.volume.value)
    for x, y in zip(a.vmaps_prev + a.nmaps_prev, b.vmaps_prev + b.nmaps_prev):
        assert torch.equal(x.v.view(torch.int32), y.v.view(torch.int32))


def test_depth_tensor_on_the_engine_device_gives_the_host_arrays_frame():
    """A uint16 depth tensor already on the engine's device is taken as it is:
    the same frames fed as numpy arrays and as CPU tensors give the same pose
    bits; a tensor of another type raises."""
    cfg = small_config(end_frame=3)
    ds = small_dataset(3, degrees_per_frame=1.0)
    engine = TorchEngine(torch_config(cfg), device="cpu")
    a, b = engine.init_state(), engine.init_state()
    for i in range(3):
        depth = np.asarray(ds.get_depth(i), np.uint16)
        a, ra = engine.process_frame(a, depth)
        b, rb = engine.process_frame(b, torch.from_numpy(depth.copy()))
        assert torch.equal(ra.camera2world.v.view(torch.int32), rb.camera2world.v.view(torch.int32))
        assert torch.equal(ra.camera2world.g.view(torch.int32), rb.camera2world.g.view(torch.int32))
    with pytest.raises(ValueError, match="uint16"):
        engine.process_frame(b, torch.from_numpy(depth.astype(np.int32)))
