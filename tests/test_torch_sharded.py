"""The port's sharded engine (``xslam_tpu_torch.parallel``, the dense
layout) against the JAX package's ``ShardedXSlamEngine`` and against the
port's own single engine, on the CPU at the tests' scale (160x120, 64^3).

- Two gloo ranks, each a process of its own
  (``tests/sharded_rank.py``, a rendezvous file under the test's temporary
  directory), over the 5 frames of
  ``tests/test_sharded.py``'s sweep, held to JAX's ``ShardedXSlamEngine(...,
  n_devices=2)`` and to the port's ``XSlamEngine(device="cpu")`` with
  ``tests/test_sharded.py``'s bounds: poses within 1e-3, ATE below 0.06 m,
  weights differing on fewer than 1e-4 of the voxels, values within 5e-3
  where both are observed.
- One rank (a group of one, in this process): ``XSlamEngine``'s poses (both
  lanes), volume and model maps bit for bit, also with the fast options
  (brick fusion, screen normals, the cached association); its
  ``process_frames`` the frame loop's bits.
- ``min_inlier_fraction`` gates both engines alike (``tests/test_sharded.py
  ::test_sharded_min_inlier_gate_matches_single``).
- Three behaviours of the JAX engine that the single engine does not share:
  the dense layout's raycast is the fixed march with the secant2 refine
  whatever ``raycast_march`` says; a slab's brick cap is ``max(256,
  fusion_brick_cap // n)``; brick fusion never reruns densely, so its
  overflow flag is reported whatever ``fusion_overflow`` says.
- Every ``config.<knob>`` the single engine reads, the sharded engine reads
  (``tests/test_sharded.py::test_config_surface_parity_single_vs_sharded``).
- The brick layout builds (its runs: ``tests/test_torch_sharded_bricks.py``);
  a recovering engine wraps the sharded one and runs (its runs:
  ``tests/test_torch_sharded_backend.py``); ``run_slam --sharded`` runs the
  dense and the brick config on the CPU with the single engine's ATE.
"""

import os
import pathlib
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from tests.helpers import small_config, small_dataset
from tests.torch_port_helpers import torch_config
from xslam_tpu.parallel.engine import ShardedXSlamEngine as JaxShardedEngine
from xslam_tpu.utils.evaluation import ate_rmse, normalize_to_first
from xslam_tpu_torch import run_slam
from xslam_tpu_torch.io.options import BENCH_ARGS
from xslam_tpu_torch.models.kinfu import XSlamEngine
from xslam_tpu_torch.models.recovery import RecoveringEngine
from xslam_tpu_torch.parallel.engine import ShardedXSlamEngine
from xslam_tpu_torch.parallel.mesh import SpaceGroup, destroy_space_group, init_space_group
from xslam_tpu_torch.parallel.sharded import sharded_integrate

N_FRAMES = 5
REPO = pathlib.Path(__file__).resolve().parents[1]


def _depths(n):
    ds = small_dataset(n, degrees_per_frame=0.5)
    return [ds.get_depth(i) for i in range(n)], [ds.get_pose(i) for i in range(n)]


def _run(engine, depths):
    state = engine.init_state()
    results = []
    for d in depths:
        state, res = engine.process_frame(state, d)
        engine.log_pose(res)
        results.append(res)
    return state, results


@pytest.fixture
def one_rank():
    """A group of one gloo rank in this process, ended after the test."""
    group = init_space_group("cpu")
    yield group
    destroy_space_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = small_config(end_frame=N_FRAMES)
    depths, gt = _depths(N_FRAMES)
    tmp = tmp_path_factory.mktemp("ranks")
    with open(tmp / "config.pkl", "wb") as f:
        pickle.dump(torch_config(cfg), f)
    np.save(tmp / "depths.npy", np.stack(depths))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "sharded_rank.py"), str(tmp / "config.pkl"),
                               str(tmp / "depths.npy"), str(tmp / "out"), "--rank", str(r), "--world-size", "2",
                               "--init-method", f"file://{tmp / 'rendezvous'}", "--device", "cpu"],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        # JAX's sharded engine while the ranks run
        jeng = JaxShardedEngine(cfg, n_devices=2)
        jstate = jeng.init_state()
        for d in depths:
            jstate, res = jeng.process_frame(jstate, d)
            jeng.log_pose(res)
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), outs
    ranks = [dict(np.load(tmp / f"out.{r}.npz")) for r in range(2)]

    single = XSlamEngine(torch_config(cfg), device="cpu")
    sstate, _ = _run(single, depths)
    return dict(jeng=jeng, jstate=jstate, ranks=ranks, single=single, sstate=sstate, gt=gt)


def _hold(poses, volume, ref_poses, ref_weight, ref_value):
    for p, q in zip(poses, ref_poses):
        np.testing.assert_allclose(p, q, atol=1e-3)
    w, v = volume
    assert (w != ref_weight).mean() < 1e-4
    both = (w > 0) & (ref_weight > 0)
    np.testing.assert_allclose(v[both], ref_value[both], atol=5e-3)


def test_two_ranks_track_jax_sharded(runs):
    r0 = runs["ranks"][0]
    jstate = runs["jstate"]
    _hold(r0["pose_v"], (r0["weight"], r0["value"]), runs["jeng"].pose_log, np.asarray(jstate.volume.weight),
          np.asarray(jstate.volume.value))
    assert r0["align_ok"].all() and bool(jstate.last_align_ok)
    est, gt = normalize_to_first(list(r0["pose_v"])), normalize_to_first(runs["gt"])
    assert ate_rmse(est, gt) < 0.06


def test_two_ranks_track_the_single_engine(runs):
    r0, r1 = runs["ranks"]
    s = runs["sstate"]
    _hold(r0["pose_v"], (r0["weight"], r0["value"]), runs["single"].pose_log, s.volume.weight.numpy(),
          s.volume.value.numpy())
    # every rank takes the same steps: the summed systems are the same on both
    for key in ("pose_v", "pose_g", "align_ok", "inliers", "overflow"):
        np.testing.assert_array_equal(r0[key], r1[key], key)
    assert list(r0["slab"]) == [0, 32] and list(r1["slab"]) == [32, 64]
    np.testing.assert_allclose(r0["vmap"], runs["sstate"].vmaps_prev[0].v.numpy(), atol=5e-3)


def _bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("options", ["dense", "fast"])
def test_one_rank_is_the_single_engine_bit_for_bit(one_rank, options):
    opts = {} if options == "dense" else dict(fusion_mode="brick", fusion_brick_cap=1024, raycast_normals="screen",
                                              icp_fixed_assoc=True)
    cfg = torch_config(small_config(end_frame=N_FRAMES, **opts))
    depths, _ = _depths(N_FRAMES if options == "dense" else 3)
    single, sharded = XSlamEngine(cfg, device="cpu"), ShardedXSlamEngine(cfg, group=one_rank)
    sstate, sres = _run(single, depths)
    pstate, pres = _run(sharded, depths)
    for a, b in zip(sres, pres):
        assert _bits(a.camera2world.v, b.camera2world.v) and _bits(a.camera2world.g, b.camera2world.g)
        assert bool(a.align_ok) == bool(b.align_ok) and int(a.inlier_count) == int(b.inlier_count)
    assert all(_bits(a, b) for a, b in zip(sstate.volume, sharded.dense_volume(pstate)))
    for a, b in zip(sstate.vmaps_prev + sstate.nmaps_prev, pstate.vmaps_prev + pstate.nmaps_prev):
        assert _bits(a.v, b.v) and _bits(a.g, b.g)


def test_one_rank_process_frames_is_the_loop(one_rank):
    cfg = torch_config(small_config(end_frame=4))
    depths, _ = _depths(4)
    engine = ShardedXSlamEngine(cfg, group=one_rank)
    loop_state, loop = _run(engine, depths)
    state, first = engine.process_frames(engine.init_state(), np.stack(depths[:2]))
    state, second = engine.process_frames(state, np.stack(depths[2:]))
    poses = torch.cat([first.camera2world.v, second.camera2world.v])
    assert _bits(poses, torch.stack([r.camera2world.v for r in loop]))
    assert all(_bits(a, b) for a, b in zip(loop_state.volume, state.volume))


@pytest.mark.parametrize("fraction, expect_ok", [(0.999, False), (0.0, True)])
def test_min_inlier_gate_matches_single(one_rank, fraction, expect_ok):
    cfg = torch_config(small_config(end_frame=3, min_inlier_fraction=fraction))
    depths, _ = _depths(3)
    _, sres = _run(XSlamEngine(cfg, device="cpu"), depths)
    _, pres = _run(ShardedXSlamEngine(cfg, group=one_rank), depths)
    for i, (a, b) in enumerate(zip(sres, pres)):
        assert bool(a.align_ok) == bool(b.align_ok)
        if i > 0:
            assert bool(b.align_ok) == expect_ok
        np.testing.assert_allclose(a.camera2world.v.numpy(), b.camera2world.v.numpy(), atol=1e-3)


def test_dense_raycast_is_the_fixed_march_whatever_raycast_march_says(one_rank):
    """``xslam_tpu/parallel/engine.py:378`` and ``sharded.py:125``: the dense
    layout's sharded raycast always runs the fixed march and the secant2
    refine, so a ``hier2`` configuration gives the fixed march's run."""
    depths, _ = _depths(3)
    hier2 = torch_config(small_config(end_frame=3, raycast_march="hier2", raycast_hier_window=8))
    fixed = torch_config(small_config(end_frame=3))
    _, a = _run(ShardedXSlamEngine(hier2, group=one_rank), depths)
    _, b = _run(ShardedXSlamEngine(fixed, group=one_rank), depths)
    assert all(_bits(x.camera2world.v, y.camera2world.v) for x, y in zip(a, b))


@pytest.mark.parametrize("cap, ranks, want", [(2816, 1, 2816), (2816, 4, 704), (600, 4, 256), (100, 1, 256)])
def test_slab_brick_cap(cap, ranks, want):
    """``xslam_tpu/parallel/engine.py:322``: a slab's cap is ``max(256,
    fusion_brick_cap // n)``."""
    cfg = torch_config(small_config(fusion_mode="brick", fusion_brick_cap=cap))
    group = SpaceGroup(None, 0, ranks, torch.device("cpu"))
    assert ShardedXSlamEngine(cfg, group=group).brick_cap == want


def test_brick_overflow_is_reported_not_rerun(one_rank):
    """``xslam_tpu/parallel/engine.py:315-325``: the dense layout's sharded
    brick fusion never reruns densely. A slab past its cap keeps its ACTIVE
    bricks past the cap unfused and reports the summed flag, and the engine
    does not read ``fusion_overflow``."""
    cfg = torch_config(small_config(end_frame=3, fusion_mode="brick", fusion_brick_cap=1024))
    depths, _ = _depths(3)
    engine = ShardedXSlamEngine(cfg, group=one_rank)
    state, _ = _run(engine, depths[:2])
    vol = [p.clone() for p in state.volume]
    dense = [p.clone() for p in state.volume]
    from xslam_tpu_torch.geometry import se3
    from xslam_tpu_torch.ops import fusion

    c2v = se3.matmul(engine.world2volume, se3.inverse(state.world2camera))
    v2c = se3.inverse(c2v)
    depth_m = fusion.scale_depth(torch.as_tensor(depths[2]))
    args = (depth_m, se3.rotation(v2c), se3.translation(v2c), engine.intr, engine.local_cfg, 0.0, one_rank)
    flag, n_active = sharded_integrate(fusion.VolumeState(*vol), *args, fusion_mode="brick", brick_cap=4)
    sharded_integrate(fusion.VolumeState(*dense), *args)
    assert bool(flag) and int(n_active) > 4
    assert not torch.equal(vol[2], dense[2])  # bricks past the cap stay unfused: no dense rerun

    # the engine: a 128^3 volume at half the voxel (the same room) has some 440 ACTIVE bricks a frame, past the
    # slab's floor of 256 that fusion_brick_cap=100 gives at one rank
    def big(cap, overflow):
        return torch_config(small_config(end_frame=2, fusion_mode="brick", fusion_brick_cap=cap,
                                         fusion_overflow=overflow, tsdf_size=(128, 128, 128), voxel_size=0.06))

    runs = {}
    for overflow in ("flag", "dense"):
        sharded = ShardedXSlamEngine(big(100, overflow), group=one_rank)
        assert sharded.brick_cap == 256
        st, res = _run(sharded, depths[:2])
        runs[overflow] = (sharded.dense_volume(st), res)
    for res in runs["flag"][1] + runs["dense"][1]:
        assert bool(res.fusion_overflow) and int(res.fusion_active) > 256
    for x, y in zip(runs["flag"][1], runs["dense"][1]):
        assert _bits(x.camera2world.v, y.camera2world.v) and _bits(x.camera2world.g, y.camera2world.g)
    assert all(_bits(a, b) for a, b in zip(*(runs[k][0] for k in ("flag", "dense"))))
    # asked to rerun, the sharded engine gives the single engine's flagged run at the slab's cap, not its rerun
    flagged, _ = _run(XSlamEngine(big(256, "flag"), device="cpu"), depths[:2])
    rerun, _ = _run(XSlamEngine(big(256, "dense"), device="cpu"), depths[:2])
    assert all(_bits(a, b) for a, b in zip(runs["dense"][0], flagged.volume))
    assert not torch.equal(runs["dense"][0].weight, rerun.volume.weight)


def test_config_surface_parity_single_vs_sharded():
    from xslam_tpu_torch.io.config import SlamConfig
    from xslam_tpu_torch.models import kinfu
    from xslam_tpu_torch.parallel import engine, sharded

    def knobs(*mods):
        return set().union(*(re.findall(r"\bconfig\.([a-z_]+)\b", pathlib.Path(m.__file__).read_text())
                             for m in mods))

    fields = set(vars(SlamConfig()).keys()) | {"trunc_dist", "angle_thres_sine", "intrinsics", "world2volume"}
    single = knobs(kinfu) & fields
    sharded_knobs = knobs(engine, sharded) & fields
    assert single == sharded_knobs, (
        f"single-only={sorted(single - sharded_knobs)}, sharded-only={sorted(sharded_knobs - single)}")


def test_brick_layout_and_recovery_are_the_next_slices(one_rank):
    """The brick layout builds (A11b); a recovering engine wraps the sharded
    one and runs (A11c): two frames logged, both aligned."""
    brick = torch_config(small_config(volume_layout="brick", fusion_mode="brick"))
    engine = ShardedXSlamEngine(brick, group=one_rank)
    state = engine.init_state()
    assert engine.brick and tuple(state.volume.value.shape) == (8 * 8 * 8, 512)
    cfg = torch_config(small_config(reloc_after_failures=2))
    recovering = RecoveringEngine(cfg, engine=ShardedXSlamEngine(cfg, group=one_rank))
    depths, _ = _depths(2)
    state = recovering.init_state()
    for d in depths:
        state, res = recovering.process_frame(state, d)
        assert bool(res.align_ok)
    assert len(recovering.pose_log) == 2 and not recovering.recovery_events


def test_run_slam_sharded_on_the_cpu(tmp_path):
    cfg = yaml.safe_load(open(REPO / "configs" / "synthetic.yaml"))
    cfg.update(end_frame=3, tsdf_size_x=64, tsdf_size_y=64, tsdf_size_z=64, tsdf_voxel_size=0.12, depth_width=160,
               depth_height=120, fx=120.3, fy=-120.0, cx=79.5, cy=59.5, output_dir=str(tmp_path / "out") + "/",
               draw_pcd=False)
    path = tmp_path / "small.yaml"
    path.write_text(yaml.safe_dump(cfg))
    try:
        sharded = run_slam.main([str(path), "--device", "cpu", "--sharded"])
    finally:
        destroy_space_group()
    single = run_slam.main([str(path), "--device", "cpu"])
    assert isinstance(sharded.engine, ShardedXSlamEngine)
    assert sharded.ate == single.ate and sharded.ate < 0.06
    # the brick yaml in bench.py's configuration (num_levels 2 with the half-resolution model maps at 160x120)
    brick = tmp_path / "brick.yaml"
    cfg.update(volume_layout="brick", fusion_mode="brick", num_levels=2)
    brick.write_text(yaml.safe_dump(cfg))
    try:
        sharded = run_slam.main([str(brick), "--device", "cpu", "--sharded", *BENCH_ARGS])
    finally:
        destroy_space_group()
    single = run_slam.main([str(brick), "--device", "cpu", *BENCH_ARGS])
    assert isinstance(sharded.engine, ShardedXSlamEngine) and sharded.engine.brick
    assert sharded.ate == single.ate and sharded.ate < 0.06
