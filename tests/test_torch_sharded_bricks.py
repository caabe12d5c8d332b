"""The port's sharded engine on the brick layout (``xslam_tpu_torch.parallel``,
``volume_layout="brick"``) against the JAX package's ``ShardedXSlamEngine``
and against the port's own single engine, on the CPU at ``small_config``'s
scale (160x120, 64^3, ``model_map_level=1``, ``num_levels=2``, brick fusion).

- Two gloo ranks, each a process of its own, in one spawn of
  ``tests/sharded_rank.py`` that runs every 2-rank case in turn, while JAX's
  ``ShardedXSlamEngine(n_devices=2)`` runs the first of them. The bounds are
  ``tests/test_sharded.py``'s (``:89-139``, ``:141``, ``:269``): the poses
  within 1e-5 on frames 0-1 and 2e-2 after for ``skip`` (1e-3 on frames
  0-1 for ``hier_skip`` and the temporal march, which differ from the single
  engine at block edges; 1e-4 against JAX's engine, the port-against-JAX
  class of ``tests/test_torch_kinfu.py``), weights differing on fewer than 2e-3 of the
  voxels and the mean |value| difference below 1e-2 where both are
  observed, every frame aligned and no overflow, ``t_prev`` finite on more
  than half the pixels.
- The overflow case with ground-truth poses on a 128^3 volume at 0.06 m,
  where one slab passes its cap of 256 ACTIVE bricks and the other does
  not: under ``"dense"`` no overflow is reported and the volume is the
  single engine's within ``tests/test_sharded.py:34-45``'s bounds (weights
  differing on fewer than 1e-4 of the voxels, values within 5e-3); under
  ``"flag"`` both ranks report the flag, and the overflowing slab's weights
  differ from the single engine's on more voxels than that bound.
- The per-rank refresh at the stage: with anchors finite only in rank 1's
  block, rank 0 takes the ``hier2`` refresh and rank 1 the anchored march,
  each block the one-rank ``raycast_bricks`` of its own block and anchors
  bit for bit (the same block layout on both sides).
- One rank in this process: ``XSlamEngine``'s bits (poses in both lanes,
  flags, inliers, rows, every model map, ``t_prev``) on bench.py's
  configuration, its forced refresh, ``skip`` with TSDF normals,
  ``hier2_skip``, and the temporal march with the ``secant2`` refine and the
  first-event march; its ``process_frames`` the frame loop's bits.
- Without a spawn: the brick layout's slab cap ``min(nb_local, max(256, cap
  // n))``, its two ``ValueError``s, and the plain hooks against the JAX
  functions: the slabs' event masks (B19e) concatenated are JAX's
  ``event_brick_mask`` of the whole rows and their distances JAX's
  ``brick_distance_rows``, exactly; ``integrate_rows(x_offset=)`` of a slab
  JAX's within K2's tolerance.

Bits across block layouts (a block's rays against the whole image's) are
held on the card (``chip_smoke.py``), not here: the plain CPU path is not
steady in its bits from one tensor layout to another.
"""

import functools
import os
import pathlib
import pickle
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import SMALL_INTR, small_config, small_dataset
from tests.torch_port_helpers import to_torch, torch_config
from xslam_tpu.csfd.single import CSFD as JCSFD
from xslam_tpu.geometry import se3 as jse3
from xslam_tpu.ops import bricks as jbricks
from xslam_tpu.ops import fusion as jfusion
from xslam_tpu.ops import fusion_brick as jbrick
from xslam_tpu.parallel.engine import ShardedXSlamEngine as JaxShardedEngine
from xslam_tpu_torch.csfd.single import CSFD
from xslam_tpu_torch.geometry import se3
from xslam_tpu_torch.geometry.intrinsics import Intrinsics
from xslam_tpu_torch.models.kinfu import XSlamEngine
from xslam_tpu_torch.ops import bricks, fusion, kernels, raycast_bricks
from xslam_tpu_torch.parallel.engine import ShardedXSlamEngine
from xslam_tpu_torch.parallel.mesh import SpaceGroup, destroy_space_group, init_space_group

N_FRAMES = 4
REPO = pathlib.Path(__file__).resolve().parents[1]
# tests/test_sharded.py:89's brick configuration (the skip march), its other marches and bench.py's own
SKIP = dict(volume_layout="brick", fusion_mode="brick", fusion_brick_cap=6144, raycast_normals="screen",
            raycast_march="skip", model_map_level=1, icp_fixed_assoc=True, num_levels=2)
BENCH = dict(SKIP, fusion_brick_cap=2816, fusion_overflow="dense", raycast_march="temporal", raycast_refine="reuse")
# the overflow case: ground-truth poses on a 128^3 volume at half the voxel, a slab cap of 256 (the floor)
OVERFLOW = dict(SKIP, use_gt_pose=True, tsdf_size=(128, 128, 128), voxel_size=0.06, fusion_brick_cap=100)
JOBS = (("skip", SKIP), ("hier_skip", dict(SKIP, raycast_march="hier_skip")), ("bench", BENCH),
        ("refresh", None), ("flag", dict(OVERFLOW, fusion_overflow="flag")),
        ("dense", dict(OVERFLOW, fusion_overflow="dense")))


def _cfg(opts, n=N_FRAMES):
    return small_config(end_frame=n, **opts)


def _frames(n=N_FRAMES):
    ds = small_dataset(n, degrees_per_frame=0.5)
    return np.stack([ds.get_depth(i) for i in range(n)]), np.stack([ds.get_pose(i) for i in range(n)])


def _run(engine, depths, gt=None):
    state = engine.init_state()
    results = []
    for i, d in enumerate(depths):
        state, res = engine.process_frame(state, d, None if gt is None else gt[i])
        results.append(res)
    return state, results


def _bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 2-rank spawn over every job, JAX's sharded engine on the first
    meanwhile, and the port's single engine on each configuration."""
    depths, gt = _frames()
    tmp = tmp_path_factory.mktemp("ranks")
    jobs = [{"name": name, "stage": "refresh"} if opts is None else {"name": name, "config": torch_config(_cfg(opts))}
            for name, opts in JOBS]
    with open(tmp / "jobs.pkl", "wb") as f:
        pickle.dump(jobs, f)
    np.save(tmp / "depths.npy", depths)
    np.save(tmp / "gt.npy", gt.astype(np.float32))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "sharded_rank.py"), str(tmp / "jobs.pkl"),
                               str(tmp / "depths.npy"), str(tmp / "out"), "--rank", str(r), "--world-size", "2",
                               "--init-method", f"file://{tmp / 'rendezvous'}", "--device", "cpu",
                               "--gt", str(tmp / "gt.npy")],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    single = {}

    def run_single():  # the port's single engine on each configuration, beside JAX's compiles
        for name, opts in JOBS:
            if opts is not None and name != "flag":
                engine = XSlamEngine(torch_config(_cfg(opts)), device="cpu")
                state, res = _run(engine, depths, gt if opts.get("use_gt_pose") else None)
                vol = engine.dense_volume(state)
                single[name] = dict(poses=np.stack([r.camera2world.v.numpy() for r in res]),
                                    weight=vol.weight.numpy(), value=vol.value.numpy())

    thread = threading.Thread(target=run_single)
    thread.start()
    try:
        jeng = JaxShardedEngine(_cfg(SKIP), n_devices=2)
        jstate = jeng.init_state()
        for d in depths:
            jstate, res = jeng.process_frame(jstate, d)
            jeng.log_pose(res)
        jvol = jeng.dense_volume(jstate)
        jax_run = dict(poses=np.stack(jeng.pose_log), weight=np.asarray(jvol.weight), value=np.asarray(jvol.value))
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        thread.join()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert len(single) == 4
    assert all(p.returncode == 0 for p in procs), outs
    out = [dict(np.load(tmp / f"out.{r}.npz")) for r in range(2)]
    return dict(ranks=[{name: {k.split(".", 1)[1]: v for k, v in o.items() if k.startswith(name + ".")}
                        for name, _ in JOBS} for o in out], jax=jax_run, single=single, gt=gt)


def _hold(run, ref, early_atol):
    poses = run["pose_v"]
    for i, (p, q) in enumerate(zip(poses, ref["poses"])):
        np.testing.assert_allclose(p, q, atol=early_atol if i <= 1 else 2e-2)
    assert (run["weight"] != ref["weight"]).mean() < 2e-3
    both = (run["weight"] > 0) & (ref["weight"] > 0)
    assert np.abs(run["value"][both] - ref["value"][both]).mean() < 1e-2


@pytest.mark.parametrize("name, early_atol", [("skip", 1e-5), ("hier_skip", 1e-3), ("bench", 1e-3)])
def test_two_ranks_track_the_single_engine(ranks, name, early_atol):
    r0, r1 = (r[name] for r in ranks["ranks"])
    _hold(r0, ranks["single"][name], early_atol)
    assert r0["align_ok"].all() and not r0["overflow"].any()
    # every rank takes the same steps and holds the same assembled maps and anchors
    for key in ("pose_v", "pose_g", "align_ok", "inliers", "overflow", "active", "vmap", "nmap", "t_prev"):
        np.testing.assert_array_equal(r0[key], r1[key], key)
    np.testing.assert_array_equal(r0["local_active"] + r1["local_active"], r0["active"])
    assert list(r0["slab"]) == [0, 32] and list(r1["slab"]) == [32, 64]
    assert r0["t_prev"].shape == (60, 80) and np.isfinite(r0["t_prev"]).mean() > 0.5


def test_two_ranks_track_jax_sharded(ranks):
    """Against JAX's 2-device engine the first tracked frame takes the
    port-against-JAX engine tolerance, 1e-4 (``tests/test_torch_kinfu.py``):
    the two single engines already differ by 4.8e-5 there on this
    configuration (XLA and PyTorch round apart), where ``tests/
    test_sharded.py``'s 1e-5 holds two engines of one package."""
    _hold(ranks["ranks"][0]["skip"], ranks["jax"], 1e-4)


def test_per_rank_refresh(ranks):
    """Anchors finite only in rank 1's block at ``temporal_min_coverage=0.5``:
    rank 0 refreshes, rank 1 takes the anchored march, each block the one-rank
    call's on its own block, anchors and refresh, bit for bit."""
    r0, r1 = (r["refresh"] for r in ranks["ranks"])
    assert list(r0["refresh"]) == [True] and list(r1["refresh"]) == [False]
    for key in ("vmap_v", "vmap_g", "t_found"):
        np.testing.assert_array_equal(r0[key], r1[key], key)
    cfg = torch_config(_cfg(BENCH))
    rows = bricks.BrickVolume(*(torch.from_numpy(r0[f"rows_{k}"]) for k in ("value", "grad", "weight")))
    vol_cfg = XSlamEngine(cfg, device="cpu").vol_cfg
    intr = cfg.intrinsics.level(cfg.model_map_level)
    w = intr.width // 2
    anchor = torch.from_numpy(r0["t_anchor"])
    pose = kernels.unpack_ray_pose(torch.from_numpy(r0["pose"]))
    for k in range(2):
        vmap, _, t_found = raycast_bricks.raycast_bricks(
            rows, *pose, raycast_bricks.column_intrinsics(intr, k * w, w), vol_cfg,
            anchor[:, k * w:(k + 1) * w].contiguous(), refresh=k == 0, march_mode="temporal", refine_mode="reuse")
        cols = slice(k * w, (k + 1) * w)
        np.testing.assert_array_equal(vmap.v.numpy().view(np.int32), r0["vmap_v"][..., cols].view(np.int32))
        np.testing.assert_array_equal(vmap.g.numpy().view(np.int32), r0["vmap_g"][..., cols].view(np.int32))
        np.testing.assert_array_equal(t_found.numpy().view(np.int32), r0["t_found"][:, cols].view(np.int32))
    assert np.isfinite(r0["vmap_v"][0, :, :w]).mean() > 0.5  # the refresh finds the surface without anchors


def test_overflow_across_ranks(ranks):
    """One slab past its cap of 256 ACTIVE bricks, the other not: ``"dense"``
    reports nothing and is the single engine's exact volume; ``"flag"``
    reports the summed flag on both ranks and leaves the overflowing slab's
    ACTIVE bricks past the cap unfused."""
    flag = [r["flag"] for r in ranks["ranks"]]
    dense = [r["dense"] for r in ranks["ranks"]]
    over = [bool((r["local_active"] > 256).any()) for r in flag]
    assert over == [True, False] or over == [False, True], [r["local_active"] for r in flag]
    big = over.index(True)
    assert all(r["overflow"].all() for r in flag)  # the slab that fits reports the other's overflow
    assert list(flag[1 - big]["local_overflow"]) == [False] * N_FRAMES
    assert not any(r["overflow"].any() for r in dense)
    np.testing.assert_array_equal(flag[0]["pose_v"], ranks["gt"].astype(np.float32))
    ref = ranks["single"]["dense"]
    sw = ref["weight"]
    assert (dense[0]["weight"] != sw).mean() < 1e-4
    both = (dense[0]["weight"] > 0) & (sw > 0)
    np.testing.assert_allclose(dense[0]["value"][both], ref["value"][both], atol=5e-3)
    half = sw.shape[0] // 2
    slab = slice(big * half, (big + 1) * half)
    assert (flag[0]["weight"][slab] != sw[slab]).mean() > 1e-4
    other = slice((1 - big) * half, (2 - big) * half)
    assert (flag[0]["weight"][other] != sw[other]).mean() < 1e-4


@pytest.fixture
def one_rank():
    group = init_space_group("cpu")
    yield group
    destroy_space_group()


def _same_run(single_run, sharded_run):
    (sstate, sres), (pstate, pres) = single_run, sharded_run
    for a, b in zip(sres, pres):
        assert _bits(a.camera2world.v, b.camera2world.v) and _bits(a.camera2world.g, b.camera2world.g)
        assert bool(a.align_ok) == bool(b.align_ok) and int(a.inlier_count) == int(b.inlier_count)
        assert (a.anchor_coverage is None) == (b.anchor_coverage is None)
        if a.anchor_coverage is not None:
            assert _bits(a.anchor_coverage, b.anchor_coverage)
    assert all(_bits(a, b) for a, b in zip(sstate.volume, pstate.volume))
    for a, b in zip(sstate.vmaps_prev + sstate.nmaps_prev, pstate.vmaps_prev + pstate.nmaps_prev):
        assert _bits(a.v, b.v) and _bits(a.g, b.g)
    assert _bits(sstate.t_prev, pstate.t_prev)


@pytest.mark.parametrize("case, opts, n", [
    ("bench", BENCH, 4),
    ("bench refresh", dict(BENCH, raycast_temporal_min_coverage=2.0), 3),
    ("skip tsdf", dict(SKIP, raycast_normals="tsdf"), 3),
    ("hier2_skip", dict(SKIP, raycast_march="hier2_skip"), 3),
    ("temporal secant2 phase1", dict(BENCH, raycast_refine="secant2", raycast_temporal_phase1=4), 3),
])
def test_one_rank_is_the_single_engine_bit_for_bit(one_rank, case, opts, n):
    cfg = torch_config(_cfg(opts, n))
    depths, _ = _frames(n)
    single = _run(XSlamEngine(cfg, device="cpu"), depths)
    sharded = _run(ShardedXSlamEngine(cfg, group=one_rank), depths)
    _same_run(single, sharded)
    if case == "bench refresh":
        assert all(float(r.anchor_coverage) < 2.0 for r in sharded[1])


def test_one_rank_process_frames_is_the_loop(one_rank):
    cfg = torch_config(_cfg(BENCH))
    depths, _ = _frames()
    engine = ShardedXSlamEngine(cfg, group=one_rank)
    loop_state, loop = _run(engine, depths)
    state, first = engine.process_frames(engine.init_state(), depths[:2])
    state, second = engine.process_frames(state, depths[2:])
    assert _bits(torch.cat([first.camera2world.v, second.camera2world.v]),
                 torch.stack([r.camera2world.v for r in loop]))
    assert _bits(torch.cat([first.anchor_coverage, second.anchor_coverage]),
                 torch.stack([r.anchor_coverage for r in loop]))
    assert all(_bits(a, b) for a, b in zip(loop_state.volume, state.volume))
    assert _bits(loop_state.t_prev, state.t_prev)


@pytest.mark.parametrize("size, cap, n, want", [(64, 2816, 1, 512), (64, 2816, 2, 256), (64, 600, 4, 128),
                                                (128, 1000, 2, 500), (128, 100, 2, 256)])
def test_slab_brick_cap(size, cap, n, want):
    """``xslam_tpu/parallel/engine.py:285-286``: on the brick layout a slab's
    cap is ``min(nb_local, max(256, fusion_brick_cap // n))``."""
    cfg = torch_config(_cfg(dict(SKIP, fusion_brick_cap=cap, tsdf_size=(size,) * 3)))
    assert ShardedXSlamEngine(cfg, group=SpaceGroup(None, 0, n, torch.device("cpu"))).brick_cap == want


def test_brick_layout_refuses_unaligned_slabs_and_blocks():
    """``xslam_tpu/parallel/engine.py:61-66``: the X-slabs must align with the
    8-voxel bricks and the model maps' width must divide by the ranks."""
    group = SpaceGroup(None, 0, 16, torch.device("cpu"))  # 64 / 16: slabs of 4 voxels
    with pytest.raises(ValueError, match="8-voxel bricks"):
        ShardedXSlamEngine(torch_config(_cfg(SKIP)), group=group)
    group = SpaceGroup(None, 0, 3, torch.device("cpu"))  # 96 / 3: slabs of 32, but 80 columns over 3 ranks
    with pytest.raises(ValueError, match="does not divide"):
        ShardedXSlamEngine(torch_config(_cfg(dict(SKIP, tsdf_size=(96, 64, 64)))), group=group)


@pytest.fixture(scope="module")
def volume():
    """The port's brick rows after 3 frames of bench.py's configuration, the
    next frame's depth and volume-to-camera pose (value lane; a zero
    derivative)."""
    cfg = torch_config(_cfg(BENCH))
    depths, gt = _frames()
    engine = XSlamEngine(cfg, device="cpu")
    state, _ = _run(engine, depths[:3])
    w2v = np.asarray(cfg.world2volume, np.float32)
    v2c = np.linalg.inv(w2v @ np.linalg.inv(gt[0]) @ gt[3]).astype(np.float32)
    return dict(rows=state.volume, depth=depths[3], v2c=JCSFD(jnp.asarray(v2c), jnp.zeros((4, 4), jnp.float32)))


def test_slab_event_masks_and_distances_are_jax_s(volume):
    """B19e's plain hooks: the slabs' masks concatenated equal JAX's
    ``event_brick_mask`` of the whole rows, and their distance JAX's
    ``brick_distance_rows``, exactly."""
    rows, res = volume["rows"], (64, 64, 64)
    local = bricks.brick_grid((32, 64, 64))
    nb = local[0] * local[1] * local[2]
    masks = [bricks.event_mask(bricks.BrickVolume(*(p[k * nb:(k + 1) * nb] for p in rows)), (32, 64, 64))
             for k in range(2)]
    mask = torch.cat(masks)
    jrows = jbricks.BrickVolume(*(jnp.asarray(p.numpy()) for p in rows))
    assert mask.dtype == torch.uint8 and int(mask.sum()) > 0
    np.testing.assert_array_equal(mask.numpy().astype(bool), np.asarray(jbricks.event_brick_mask(jrows)))
    np.testing.assert_array_equal(bricks.skip_distance(mask, res).numpy(),
                                  np.asarray(jbricks.brick_distance_rows(jrows, res)))
    assert torch.equal(bricks.skip_distance(mask, res), bricks.skip_field(rows, res))


@functools.lru_cache(maxsize=None)
def _jax_integrate_rows(jcfg):
    """JAX's ``integrate_rows`` on a slab, jitted once for both slabs (the offset traced)."""
    return jax.jit(functools.partial(jbrick.integrate_rows, intr=SMALL_INTR, cfg=jcfg, cap=256))


@pytest.mark.parametrize("k", range(2))
def test_slab_integrate_rows_is_jax_s(volume, k):
    """``integrate_rows(x_offset=32 k)`` on slab k's rows against JAX's
    ``integrate_rows(x_offset=jnp.int32(32 k))`` (the sharded stage's traced
    offset), within K2's tolerance: weights equal on >= 99.99% of voxels,
    value and grad within 1e-5 where they agree
    (``tests/test_torch_shard_hooks.py``); the same overflow flag."""
    cfg = small_config()
    lres = (32, 64, 64)
    jcfg = jfusion.VolumeConfig(lres, cfg.voxel_size, cfg.trunc_dist, cfg.max_integration_weight)
    tcfg = fusion.VolumeConfig(lres, cfg.voxel_size, cfg.trunc_dist, cfg.max_integration_weight)
    nb = 4 * 8 * 8
    slab = [p[k * nb:(k + 1) * nb].clone() for p in volume["rows"]]
    r, t = jse3.rotation(volume["v2c"]), jse3.translation(volume["v2c"])
    jdm = jfusion.scale_depth(jnp.asarray(volume["depth"]))
    jvol, jflag = _jax_integrate_rows(jcfg)(jbricks.BrickVolume(*(jnp.asarray(p.numpy()) for p in slab)), jdm, r, t,
                       x_offset=jnp.int32(32 * k))
    tvol = bricks.BrickVolume(*slab)
    before = tvol.weight.clone()
    flag, n_active = fusion.integrate_rows(tvol, fusion.scale_depth(torch.from_numpy(volume["depth"])), to_torch(r),
                                           to_torch(t), Intrinsics(*SMALL_INTR), tcfg, cap=256, x_offset=32 * k)
    assert bool(flag) == bool(jflag) and int(n_active) > 0
    assert int((tvol.weight != before).sum()) > 1000  # the frame lands on this slab
    tw, jw = tvol.weight.numpy(), np.asarray(jvol.weight)
    assert np.mean(tw == jw) >= 0.9999
    same = tw == jw
    for a, b in ((tvol.value, jvol.value), (tvol.grad, jvol.grad)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same], atol=1e-5)


def test_raycast_bricks_rays_takes_packed_rows_and_defers_screen_normals(volume):
    """``raycast_bricks_rays(packed=, apply_screen=False)``, the JAX
    signature's sharded-path arguments: the skip march over jump-packed rows
    given from outside (the volume's weight not read) gives the volume's own
    maps bit for bit, and no screen normals are made."""
    engine = XSlamEngine(torch_config(_cfg(SKIP)), device="cpu")
    rows, res = volume["rows"], engine.vol_cfg.resolution
    c2v = CSFD(torch.from_numpy(np.linalg.inv(np.asarray(volume["v2c"].v))), torch.zeros((4, 4)))
    ray_dir, ray_start = kernels.camera_rays(se3.rotation(c2v), se3.translation(c2v), engine.intr.level(1))
    v2w = engine.volume2world
    args = (ray_start, ray_dir, se3.rotation(v2w), se3.translation(v2w), engine.vol_cfg)
    own = raycast_bricks.raycast_bricks_rays(rows, *args, return_hit=True)
    packed = bricks.pack_rows(rows.value, bricks.skip_field(rows, res))
    given = raycast_bricks.raycast_bricks_rays(bricks.BrickVolume(rows.value, rows.grad, None), *args, packed=packed,
                                               apply_screen=False, return_hit=True)
    assert own[1] is not None and given[1] is None
    assert _bits(own[0].v, given[0].v) and _bits(own[0].g, given[0].g) and _bits(own[2], given[2])


def test_column_intrinsics():
    """A block's ``cx`` is the float32 ``cx`` less its first column, exactly;
    a block outside the image, or a ``cx`` that the subtraction would round,
    raises."""
    intr = Intrinsics(*SMALL_INTR).level(1)
    block = raycast_bricks.column_intrinsics(intr, 40, 40)
    assert block == intr._replace(cx=kernels.f32(intr.cx) - 40, width=40)
    with pytest.raises(ValueError, match="not a block"):
        raycast_bricks.column_intrinsics(intr, 60, 40)
    with pytest.raises(ValueError, match="not a float32"):
        raycast_bricks.column_intrinsics(intr._replace(cx=0.1, width=1 << 20), 1 << 19, 8)
