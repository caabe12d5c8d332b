"""The profiled-frame check of ``chip_smoke.py`` on made-up profiler records
(the smoke itself needs the card): a record whose device events fall short
of the host's launch calls is retaken on the next frame, at most twice, and
the checks on the record it keeps stay as strict: a frame whose own launch
count is wrong, or with other device work between its ICP launches, fails
without a retake. Then the smoke's other host-side pieces: the kernel table,
B12's and its band pass's bounds, the phases' order, the backend runs' settings and the parser of
``run_slam``'s backend output."""

import os

import pytest

import chip_smoke

ITERATIONS = 12


def _record(launches: int, device: int = None, interloper: bool = False) -> dict:
    """A frame of ``launches`` host launch calls whose profiler kept
    ``device`` of them (all by default): 3 preprocess launches, the 12 ICP
    launches together, the rest after them."""
    names = ["bilateral_kernel", "depth_pyramid_kernel", "vertex_normal_maps_kernel"]
    names += ["icp_system_kernel"] * ITERATIONS
    if interloper:
        names.insert(5, "elementwise_kernel")
    names += ["elementwise_kernel"] * (launches - len(names))
    names = names[: launches if device is None else device]
    return dict(names=names, icp_at=[j for j, n in enumerate(names) if n == "icp_system_kernel"],
                host_calls=launches, stages={"preprocess": 3.0, "icp": 96.0})


@pytest.mark.parametrize("first, retaken, attempts, fails", [
    (_record(658), [], 1, None),  # consistent: no retake
    (_record(658, device=657), [_record(658)], 2, None),  # one event lost: retaken, then held
    (_record(658, device=657), [_record(658, device=640), _record(658)], 3, None),
    (_record(658, device=657), [_record(658, device=657), _record(658, device=657)], 3, "consistent record"),
    (_record(659), [], 1, "659 launches"),  # the frame's own count is wrong: no retake
    (_record(658, device=657), [_record(659)], 2, "659 launches"),
    (_record(658, interloper=True), [], 1, "other device work"),
])
def test_profiled_frame_record(first, retaken, attempts, fails):
    queue = list(retaken)
    rec, seen = chip_smoke.consistent_record(first, lambda: queue.pop(0))
    assert len(seen) == attempts and not queue
    assert seen[0] == dict(device_launches=len(first["names"]), host_launch_calls=first["host_calls"])
    if fails is None:
        chip_smoke.check_frame_record(rec, seen, ITERATIONS, 658)
    else:
        with pytest.raises(AssertionError, match=fails):
            chip_smoke.check_frame_record(rec, seen, ITERATIONS, 658)


def test_no_icp_event_is_a_garbled_record():
    """The profiler once kept no ICP event of a brick frame: the device count
    then falls short of the host's, and the frame is retaken."""
    lost = _record(660)
    lost["names"] = [n for n in lost["names"] if n != "icp_system_kernel"]
    lost["icp_at"] = []
    rec, seen = chip_smoke.consistent_record(lost, lambda: _record(660))
    assert len(seen) == 2
    chip_smoke.check_frame_record(rec, seen, ITERATIONS, 660)


def test_kernel_table_names_every_counted_wrapper():
    """Every wrapper's launch count has a row in the smoke's kernel table and
    every row a count; every row's path is one the smoke counts."""
    from xslam_tpu_torch.ops import kernels

    assert set(chip_smoke.KERNELS) == set(kernels.launch_counts)
    paths = {path for _, _, path in chip_smoke.KERNELS.values()}
    assert "relocalize path" in paths and paths <= {
        "main path", "main path, fixed association", "main path, brick fusion", "main path, bench",
        "main path, bench refresh", "main path, hier2", "main path, skip", "main path, hier", "main path, hier_skip",
        "main path, bench bilinear", "main path, ICL realistic", "main path, 7-Scenes realistic", "relocalize path",
        "probe path",
        *chip_smoke.SHARDED_RUNS, "main path, sharded bench refresh, 2 ranks", *chip_smoke.BRICK_RAYCASTS,
        *chip_smoke.B15_RUNS, "backend, blackout"}
    assert chip_smoke.KERNELS["raycast_refine_bricks"][2] == "main path, brick skip"  # K5r
    assert chip_smoke.KERNELS["window_march_first_event"][2] == "main path, bench phase1"  # B16
    assert set(chip_smoke.FRAME_LAUNCHES) <= {name for name, _ in chip_smoke.PHASES}
    assert chip_smoke.KERNELS["tsdf_loss"][:2] == ("xslam_tpu_torch/csrc/tsdf_loss.cu", "xslam_tpu/ops/tsdf_loss.py:65")


def test_b12_bound_counts():
    """B12's least work over a band: the band's indices and values, the
    depth, the poses and the sums once; the function's operations at each
    band voxel: the value lane, six first-derivative lanes and a
    second-derivative lane a pair (1 + 6 + 21 lanes) in REDUCE, the value
    lane alone in VALUE. At the smoke's 109,794 band voxels operations bound
    REDUCE (0.0059 ms) and bytes VALUE; the band pass reads the plane once
    (bytes, 0.0201 ms at 256^3); a call at 12 iterations about 0.10 ms."""
    c = chip_smoke
    n_bytes, ops = c._loss_bytes_ops(1000, 480 * 640, 21, "reduce")
    assert n_bytes == 1000 * 8 + 480 * 640 * 4 + 21 * 48 * 4 + 29 * 4
    assert ops == 1000 * (c.TSDF_LOSS_VALUE_OPS + c.TSDF_LOSS_SQRT_OPS + 6 * c.TSDF_LOSS_E1_OPS
                          + 21 * c.TSDF_LOSS_E12_OPS) == 3_588_000
    assert c._loss_bytes_ops(1000, 480 * 640, 1, "reduce")[1] == 1000 * (89 + 10 + 81 + 143)
    assert c._loss_bytes_ops(5, 4, 1, "value")[1] == 5 * c.TSDF_LOSS_VALUE_OPS
    reduce_ms, by = c.bound_ms(*c._loss_bytes_ops(109_794, 480 * 640, 21, "reduce"))
    assert by == "operations" and reduce_ms == pytest.approx(3588 * 109_794 / 67e9)
    assert c.bound_ms(*c._loss_bytes_ops(109_794, 480 * 640, 1, "value"))[1] == "bytes"
    band_ms, by = c.bound_ms(*c._band_bytes_ops(256 ** 3, 109_794))
    assert by == "bytes" and band_ms == pytest.approx((256 ** 3 + 109_795) * 4 / 3.35e9)
    assert 0.09 < c._call_bound_ms(256 ** 3, 109_794, 480 * 640, 12) < 0.11
    # the relocalize path launches B12 twice an iteration, once for the start's count, once at the end
    assert chip_smoke.RELOC_HOLDOUTS * (2 * chip_smoke.RELOC_ITERS + 2) == 78


class _Event:
    def __init__(self, name, device_type, start, end=None):
        from types import SimpleNamespace

        self.name, self.device_type = name, device_type
        self.time_range = SimpleNamespace(start=start, end=start if end is None else end)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


@pytest.mark.parametrize("spins_kept", [256, 200, 0])
def test_frame_record_leaves_the_lead_spins_out(spins_kept):
    """The spin kernels that open a profiled frame's window are left out of
    the record, whichever of them the profiler kept, and their launch calls
    are taken off the host's count: the frame's record is the frame's."""
    from torch.autograd import DeviceType

    lead = chip_smoke.PROFILE_LEAD
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [_Event("cudaLaunchKernel", cpu, t) for t in range(lead)]
    events += [_Event("at::cuda::(anonymous namespace)::spin_kernel(long)", cuda, t) for t in range(spins_kept)]
    frame = ["bilateral_kernel", "depth_pyramid_kernel"] + ["icp_system_kernel"] * ITERATIONS + ["fuse_kernel"]
    events += [_Event("preprocess", cpu, 1000, 1010)]
    events += [_Event("cudaLaunchKernel", cpu, 1001 + j) for j in range(len(frame))]
    events += [_Event(name, cuda, 2000 + j) for j, name in enumerate(frame)]
    rec = chip_smoke._frame_record(_Prof(events))
    assert rec["names"] == frame and rec["host_calls"] == len(frame)
    assert rec["icp_at"] == list(range(2, 2 + ITERATIONS))
    lost_one = [e for e in events if not (e.device_type == cuda and e.name == "bilateral_kernel")]
    rec = chip_smoke._frame_record(_Prof(lost_one))
    assert len(rec["names"]) == rec["host_calls"] - 1  # a lost frame event still shows


def test_backend_phases_come_last():
    """The three backend phases follow the realistic paths, after every earlier
    phase in its order; each runs a shipped backend config on data the port's
    generator renders, cut by ``--frames`` only."""
    names = [name for name, _ in chip_smoke.PHASES]
    assert names[-5:] == ["main path, 7-Scenes realistic", "backend, blackout", "backend, loop", "backend, realistic",
                          "backend, sharded blackout"]
    assert names[:3] == ["rounding", "bilateral_filter", "fuse_volume"] and len(names) == len(set(names)) == 60
    # B17's kernels after B13's; A12 on the bench run's final state, right after that run
    assert names[names.index("extract") + 1] == "B17 meshers"
    assert names[names.index("main path, bench") + 1] == "A12"
    # B18 after B12's kernel phase; the sharded BA after the two ranks' main path
    assert names[names.index("tsdf_loss") + 1] == "schur_cg"
    assert names[names.index("main path, sharded bench refresh, 2 ranks") + 1] == "sharded BA"
    # B19's hooks and column blocks after K4's phase, C3's four levels after them; the sharded main paths (one rank
    # in each setting, then two ranks on the card) after B15's settings
    assert names[names.index("icp_system") + 1: names.index("icp_system") + 4] == ["B19", "B19 columns", "four levels"]
    at_sharded = names.index(list(chip_smoke.B15_RUNS)[-1]) + 1
    assert names[at_sharded: at_sharded + 5] == [
        "main path, sharded", "main path, sharded fast", "main path, sharded bench", "main path, sharded bench refresh",
        "main path, sharded bench refresh, 2 ranks"]
    assert list(chip_smoke.SHARDED_RUNS) == names[at_sharded: at_sharded + 4]
    # B15: its kernels' phase after B11's, its main-path settings after the brick layout's other raycasts
    assert names[names.index("bilinear") + 1] == "B15"
    at_b15 = names.index(list(chip_smoke.BRICK_RAYCASTS)[-1]) + 1
    assert names[at_b15: at_b15 + 4] == list(chip_smoke.B15_RUNS)
    # the brick layout's other raycasts: K5r's and B16's phases after B5's, their main paths after bench bilinear
    assert names[names.index("skip") + 1: names.index("skip") + 3] == ["brick refine", "first-event window"]
    at = names.index("main path, bench bilinear") + 1
    assert names[at: at + 6] == list(chip_smoke.BRICK_RAYCASTS)
    runs = chip_smoke.BACKEND_RUNS
    assert {tag: config for tag, (config, _, _) in runs.items()} == {
        "blackout": "configs/ICL_blackout.yaml", "loop": "configs/ICL_loop_backend.yaml",
        "realistic": "configs/ICL_realistic_backend.yaml"}
    assert runs["blackout"][2] == ["0.0015", "--blackout", "30", "40"] and runs["blackout"][1] > chip_smoke.BLACKOUT[1]
    assert runs["loop"][2] == ["0.004", "--revisit"] and runs["loop"][1] <= 120
    for config, _, _ in runs.values():
        assert os.path.exists(os.path.join(chip_smoke.ROOT, config))


def test_kernel_table_rows_unchanged():
    """The table keeps its rows and paths; B12's band pass has its own row,
    on the relocalize path, two device kernels a launch; the bilinear branch
    (B11 in K2 and B3c), K3's strides, the dense layout's B14a-c, and the
    brick layout's K5r and B16, and B15's split (B15s), fine (B15f) and subcell
    (B15c) classifiers and B3c's MIXED and subcell variants have rows of their
    own, and so have B19's slab hooks (K2, B3b and B3c with a slab's offset,
    K3 and K5 in their slab modes, K5's finalize, K4's tail) on the sharded
    engine's main paths, and B19e's two kernels (B5a's mask over a slab, its
    distance over the gathered mask) on the two ranks' path, and B18's two
    passes on the blackout run's refinement, and B17's two meshers on the
    realistic runs, and B5b's ray form (a thread a ray) on the brick skip
    march (51 in all), each on the path that runs it."""
    assert list(chip_smoke.KERNELS) == [
        "bilateral_filter", "fuse_volume", "march_fixed", "raycast_refine", "resize_model_maps", "depth_pyramid",
        "depth_mips", "classify_bricks", "fuse_bricks", "vertex_normal_maps", "icp_system", "icp_associate",
        "window_march", "window_march_first_event", "raycast_refine_bricks", "fuse_volume_bilinear", "fuse_bricks_bilinear", "march_fixed_strided", "skip_field_dense",
        "march_skip_dense", "window_march_dense", "model_map_normals", "skip_field", "march_skip", "march_skip_rays",
        "extract_points",
        "mesh_tetra", "mesh_mc", "tsdf_loss", "tsdf_band", "classify_bricks_split", "classify_bricks_fine", "classify_subcells",
        "fuse_bricks_mixed", "fuse_bricks_subcell", "fuse_volume_slab", "classify_bricks_slab", "fuse_bricks_slab",
        "march_fixed_shard", "raycast_refine_shard", "raycast_finalize", "icp_tail", "event_mask", "skip_distance",
        "schur_cg_anchors", "schur_cg_keyframes", "probe_a", "probe_b", "probe_c", "probe_d", "probe_e"]
    assert chip_smoke.KERNELS["schur_cg_anchors"][::2] == chip_smoke.KERNELS["schur_cg_keyframes"][::2] == (
        "xslam_tpu_torch/csrc/schur_cg.cu", "backend, blackout")
    assert chip_smoke.KERNELS["event_mask"][2] == chip_smoke.KERNELS["skip_distance"][2] == (
        "main path, sharded bench refresh, 2 ranks")
    assert {k: chip_smoke.KERNELS[k][2] for k in ("fuse_volume_slab", "classify_bricks_slab", "fuse_bricks_slab",
                                                  "march_fixed_shard", "raycast_refine_shard", "raycast_finalize",
                                                  "icp_tail")} == {
        "fuse_volume_slab": "main path, sharded", "classify_bricks_slab": "main path, sharded fast",
        "fuse_bricks_slab": "main path, sharded fast", "march_fixed_shard": "main path, sharded",
        "raycast_refine_shard": "main path, sharded", "raycast_finalize": "main path, sharded",
        "icp_tail": "main path, sharded"}
    assert {k: chip_smoke.KERNELS[k][2] for k in ("fuse_volume_bilinear", "march_fixed_strided", "window_march_dense",
                                                  "skip_field_dense", "march_skip_dense", "fuse_bricks_bilinear")} == {
        "fuse_volume_bilinear": "main path, hier2", "march_fixed_strided": "main path, hier2",
        "window_march_dense": "main path, hier2", "skip_field_dense": "main path, skip",
        "march_skip_dense": "main path, skip", "fuse_bricks_bilinear": "main path, bench bilinear"}
    assert chip_smoke.KERNELS["tsdf_loss"][2] == chip_smoke.KERNELS["tsdf_band"][2] == "relocalize path"
    assert {k: chip_smoke.KERNELS[k][2] for k in ("classify_bricks_split", "classify_bricks_fine", "classify_subcells",
                                                  "fuse_bricks_mixed", "fuse_bricks_subcell")} == {
        "classify_bricks_split": "main path, bench split", "classify_bricks_fine": "main path, bench fine",
        "classify_subcells": "main path, bench subcell", "fuse_bricks_mixed": "main path, bench split",
        "fuse_bricks_subcell": "main path, bench subcell"}
    assert chip_smoke.DEVICE_KERNELS["tsdf_band"] == ("tsdf_band_count_kernel", "tsdf_band_list_kernel")
    assert {k: chip_smoke.KERNELS[k][2] for k in ("mesh_tetra", "mesh_mc")} == {
        "mesh_tetra": "main path, ICL realistic", "mesh_mc": "main path, 7-Scenes realistic"}
    assert chip_smoke.KERNELS["march_skip_rays"] == (
        "xslam_tpu_torch/csrc/skip.cu", "xslam_tpu/ops/raycast.py:254", "main path, brick skip")
    assert len(chip_smoke.KERNELS) == 51


def test_parse_backend_stdout():
    """What the backend phases read from ``run_slam.main``'s output."""
    text = ("frame num: 60\nstart slam!\nframe 30: align failed! (inliers=0)\nframe 31: align failed! (inliers=0)\n"
            "mean frame time = 14.250 ms (NVIDIA H100 80GB HBM3)\nATE RMSE = 0.01234 m\n"
            "refined ATE RMSE = 0.01100 m (12 keyframes, 1 loop closures)\n")
    got = chip_smoke.parse_backend_stdout(text)
    assert got == dict(align_failed=[30, 31], mean_frame_ms=14.25, ate_m=0.01234, refined_ate_m=0.011, keyframes=12,
                       loops=1, refinement_failed=False)
    failed = chip_smoke.parse_backend_stdout("ATE RMSE = 0.02000 m\nbackend refinement FAILED (ValueError): x\n")
    assert failed["refinement_failed"] and failed["refined_ate_m"] is None and failed["ate_m"] == 0.02
