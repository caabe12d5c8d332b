"""Smoke run of the PyTorch/CUDA port (``xslam_tpu_torch``) on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine with
one CUDA card, ``nvcc`` and PyTorch built for CUDA. Imports nothing of JAX or
of ``xslam_tpu``.

Phases, in order:

1. the card's name and power limit (``nvidia-smi``), the float32 precision
   pins, and how this PyTorch rounds ``x / c``, a 2x2 mean and a sum of three
   on the card, and ``c / x`` and ``torch.reciprocal``
   (``xslam_tpu_torch.apps.torch_rounding``): K3, K5, K6, K8 and B12
   repeat those roundings to equal their plain versions bit for bit, so the
   run fails here, and says why, where they are no longer PyTorch's;
2. build the CUDA kernels from ``xslam_tpu_torch/csrc`` (one
   ``torch.utils.cpp_extension.load`` of all sources) and print the build
   seconds;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the main path (one JSON line each): K1 on a 480x640 rendered frame
   (and its weight table against ``torch.exp`` of the tap's expression), K2 on the 256^3 volume after 3 fused frames (bit-equal, at
   the orbit's next pose, at a pose that looks along the volume from a
   corner and at the pose of the JAX package's window-coverage regression
   test), K3 on that volume (also bit-equal to its earlier design, timed
   beside it, on these rays and on rays with a NaN or an infinity), K5 (the secant refine
   with normals) on that volume at the shapes of ``model_map_level`` 0 and
   1, K6 (the model-map pyramid, every coarser level in one launch, on K5's
   maps of both configurations and at two shapes with odd halvings), K7
   (both coarser depth levels in one launch, at 480x640 and on crops of
   478x638 and 477x637) and K8 (vertex and normal maps) at every level
   shape of both configurations, the brick fusion kernels B3a (depth mips),
   B3b (classes and lists) and B3c (the brick pass) each against its plain
   version, B3c's volume also against K2's bit for bit at K2's three poses
   and with cap 64 in both overflow modes, and B3c's row variant (the brick
   layout) against K2 on the dense twin, bit for bit; B11, the bilinear
   branch (threshold 0.1), in K2 and in B3c's dense planes and rows against
   the plain versions, bit for bit, at the orbit frame and the volume
   corner, timed beside the nearest branch; B15 (the opt-in classifiers and
   subcell fusion): B15s, B15f, B15c and B3c's MIXED and subcell variants
   against their plain versions at K2's three poses and on a 640x480 depth
   step (its column the one where the plain split classifier makes the most
   MIXED bricks; MIXED must fire), every variant's volume K2's bit for bit
   on the planes and the rows, the bilinear branch against plain, a starved
   subcell capacity of 4 ("flag" as plain, "dense" as K2), timed beside B3b
   and B3c; K3 at strides 2 and 4 (bit-equal
   to the stride-1 march subsampled, to its earlier design and to one lane a
   ray; the wrapper's lanes a ray timed in turns against one lane, warm and
   cold, with the blocks launched and the warps an SM); the dense
   layout's B14a (distance), B14b (skip march, strides 1 and 2) and B14c
   (window repair, strides 2 and 1; its bound counts the distinct voxels its
   samples read) on the 256^3 volume along the 480x640 rays, bit for bit; the brick layout's
   raycast kernels on the brick rows of that volume at the bench path's
   shapes (240x320 model maps): B4 (the anchored window march) with its
   ``reuse`` refine on frame 3's depth anchors and without it at the
   refresh's half level, B4n (screen normals, computed in K6's launch) on
   B4's map with the pyramid's levels and with one, and on a 239x319 crop,
   B5a (the skip field) on every brick, B5b (the skip march, a warp a ray) at
   60x80 and on 7x9 rays against its plain version on every ray and at 60x80
   against the plain fixed march as the reference holds it, each bit for
   bit, timed warm and cold (B5b also with its rays' samples and rounds, and
   its latency floor from probe E's time a step); K5r (K5 over the brick
   rows) from the fixed march's hits at 240x320 and 480x640 against its
   plain version and against K5 on the dense twin, bit for bit, timed
   beside K5; B16 (the first-event window march) against
   ``march_temporal_compact`` with and without the ``reuse`` refine, bit for
   bit, timed beside B4 on the same anchors; B13 (point extraction:
   count, points, normals and the zero rows past the count) on that volume
   and on the dense twin of its brick rows, at run_slam's capacity of
   1,000,000 and at half the count, bit for bit, timed warm and cold; B17t
   and B17m (the meshers: marching tetrahedra and marching cubes) on the same
   three volumes at run_slam's capacity of 2,000,000 and at half the count
   against their plain versions, bit for bit (count, vertices, the zero rows),
   a second launch equal, timed warm and cold beside the plain version; K4
   (the ICP system, its tail, the association that
   a level's first launch writes, and the association kernel it is held
   against) on model maps raycast from that volume and the next frame's
   depth pyramid, at the three level shapes of both main-path
   configurations; B12 (the relocalization loss with its gradient and
   Hessian, 21 seed pairs a launch, over the band its band pass lists: the
   voxels that pass gt's test) on that volume and frame 3's depth at a pose
   near frame 3's true one, and on a 201x203x205 crop: the band equal to its
   plain version, FIELD bit-equal to the plain version on the mask for pairs
   0, 5, 10 and 20, the 28 sums within a float32 ulp and the count equal,
   VALUE's loss and count equal to REDUCE's, a second launch bit-identical,
   one pose within an ulp, poses whose lanes are not shared refused; the
   band pass, REDUCE and VALUE timed warm and cold; and the five gather
   probes;
4. the relocalize path: ``apps/relocalize_demo.main`` at its defaults
   (12 oracle-pose frames fused into the 256^3 volume, 3 held-out frames
   relocalized from perturbed poses, 12 Newton iterations, each
   evaluation one B12 launch): every loss history descends, B12 launches
   ``2 * iters + 2`` times a call and its band pass once, and holdout 0
   with 4 iterations through B12 and through its plain version on the card
   makes the same accept decisions and ``xi`` within 1e-5; B12 and the band
   pass timed on that map, and one ``relocalize`` call profiled (wall time
   against device time); then the
   odometry path:
   ``OdometryEngine`` (K1, K7, K8, K4) over 10 frames of the orbit, every
   frame aligned, ATE < 0.1 m;
5. the probe path: ``xslam_tpu_torch.apps.probe_gather.run`` on the card;
6. the main path, five times: ``XSlamEngine(load_config("configs/synthetic.yaml"))``
   runs 10 frames of the 640x480 synthetic orbit on the card, then 6 frames
   with ``icp_fixed_assoc=True, model_map_level=1``, then 10 frames with
   bench.py's fusion (``fusion_mode="brick"``, cap 2816,
   ``fusion_overflow="dense"``), then 10 frames in bench.py:78-95's whole
   configuration (the brick layout, the temporal march, the ``reuse``
   refine, screen normals), then 4 frames of it with
   ``raycast_temporal_min_coverage=2``, so that every frame takes the
   ``hier2`` refresh (B5a, B5b); in each run every frame must align, the ATE
   must stay under 0.02 m, the model maps must be finite where valid, every
   kernel must have launched as often as the run's frames and ICP
   iterations say, and a profiled frame must show nothing on the device
   between its ICP launches and make the frame's launches; the brick run
   must never overflow its cap and must give the first run's ATE to every
   digit (its volume is dense fusion's, bit for bit); the two bench runs
   print each frame's anchor coverage and must give the same ATE digits in a
   second run; in the bench run's second run frame 3's depth is a uint16
   tensor already on the card, and its pose must equal the first run's
   (host depth) bit for bit; after the bench run, "A12" takes its final
   state: ``export_model_maps_ply`` writes a point a valid pixel,
   ``export_current_maps_ply`` at levels 0 and 1 equals the plain functions'
   composition on the card bit for bit, ``Timer`` waits on a device sleep
   only when given a tensor, ``assert_state_sane`` passes and
   ``state_health`` on the card equals its CPU copy's. A profiled frame's
   window opens with 256 spin
   kernels, which take the first device events the profiler drops (more the
   longer the run has gone on) and are left out of the record. The
   profiler's record of a frame is trusted only where its device events are
   as many as the host's launch calls; where they differ, up to two more
   frames are profiled, and the run fails if none gives a consistent
   record; then the dense layout's settings over configs/synthetic.yaml:
   hier2 with screen normals and bilinear fusion (threshold 0.1) over 10
   frames, skip, hier and hier_skip over 4 frames each, bench.py's
   configuration with bilinear fusion over 4 frames (the same checks, each
   frame's launches held: 660, 660, 659, 661, 675); then the brick layout's
   other raycasts over 4 frames each (``BRICK_RAYCASTS``): bench.py's
   configuration with the ``secant2`` refine (K5r) and the ``skip``,
   ``hier_skip``, ``hier2_skip`` marches with screen normals, ``hier_skip``
   with TSDF normals and the temporal march, then bench.py's own with
   ``raycast_temporal_phase1=4`` (B16; whether its poses are the bench run's
   first four bit for bit is printed), each run twice for the same ATE
   digits (launches 662, 663, 664, 663, 676, 675); then B15's settings over
   4 frames each (``B15_RUNS``): bench.py's configuration with the split
   classifier, the fine one and the subcell stage (lists of 2816), and the
   dense layout's brick fusion with the fine classifier, each run twice for
   the same ATE digits, its poses the reference run's first four bit for bit
   (launches 675, 675, 676, 660); then process_frames
   over 6 frames in chunks of 3 and ``run_slam.main --scan 3`` against the
   frame loop, bit for bit;
7. the realistic paths, through the CLI's entry point ``run_slam.main`` on
   data the port's generator renders into a temporary directory (its own PNG
   writer; the loaders read them with its own PNG reader): 30 frames of
   configs/ICL_realistic.yaml's dataset (cut from 301) with ``--mesh
   tetra``: every pose file, ATE < 0.02 m, B13 launched once (``draw_pcd``),
   ``pcd.ply`` read back with B13's count, B13 on the final volume equal to
   the plain extraction, B17t launched once and ``mesh.ply`` with its
   triangles, B17t and B17m on the final volume equal to the plain meshers
   bit for bit (each timed with its peak memory), and a checkpoint after 15
   frames loaded into a new engine and run to the end giving the run's poses
   bit for bit; then 10 frames of configs/7scenes_realistic.yaml's
   (``SevenScenesDataset``) with ``--mesh mc``, ATE < 0.02 m, B17m launched
   once, its triangles the plain marching cubes' count;
8. the backend configs, through ``run_slam.main`` with ``--frames`` on data
   the port's generator renders first (three processes side by side, all
   waited for before the first run; ``BACKEND_RUNS``), each under a
   :class:`BackendProbe` that times and counts ``relocalize``,
   ``_depth_icp``, ``pose_graph_cg``, ``build_ba_problem`` and
   ``schur_ba_cg`` and profiles one ``schur_ba_cg`` call (its launches):
   configs/ICL_blackout.yaml over 60 frames with frames 30-39 blank (they
   fail to align, a relocalization after them re-enters its frame and every
   later frame aligns, B12 launches
   ``2 * reloc_iters + 2`` times a ``relocalize`` call and its band pass
   once, whether the
   re-entered frame launched B5a and B5b is printed, ATE and refined ATE
   < 0.05 m); configs/ICL_loop_backend.yaml on a revisit cut (a verified
   loop, finite BA residuals, a second ``refine_trajectory()`` bit-equal to
   the CLI's, ``pose_graph_cg`` and ``schur_ba_cg`` again with no host read
   under ``torch.cuda.set_sync_debug_mode("error")`` and bit-equal);
   configs/ICL_realistic_backend.yaml over 30 frames (no align failure, at
   least 2 keyframes). Each prints the refined line and writes a refined
   pose file a frame.

Also, after the B19 slab hooks: "B19 columns", the
sharded brick raycast's slab masks (B19e: ``event_mask`` over 2 and 4 slabs
of the 256^3 rows, ``skip_distance`` over their gathered mask, against
``skip_field`` and the plain versions, bit for bit) and column blocks (B19f:
every block of a 2- and a 4-way split of the 240x320 model maps, B5b at
strides 1, 2 and 4, B4 with the anchors with and without the ``reuse``
refine, B4's repairs at strides 2 and 1, B16 and K5r against their plain
versions on the block's rays bit for bit, B5b and K5r also against the whole
image's launch at the block's columns; the anchored marches' and repairs'
pixels differing from the whole image's at block edges printed; a block's
launches timed against the whole image's); then among the main paths the
sharded engine at world size 1 over NCCL in :data:`SHARDED_RUNS` (its dense
layout, the fast options, bench.py's configuration over 10 frames and its
forced refresh over 4, each ``XSlamEngine``'s poses, volume or rows, maps,
``t_prev`` and ATE digits bit for bit), and bench.py's configuration over two
ranks on this one card (two processes over gloo's CUDA collectives: every
frame aligned, the poses the single engine's within the column-blocked
marches' bounds, B19e's launches counted, the per-rank refresh at the stage).

The sharded backend and B18: after B12's kernel phase, "schur_cg" holds B18's
two passes (the Schur-complement CG's ``S x``) against their plain versions on
a seeded problem of the loop backend's shape (184,320 observations, 41
keyframes, 12,253 anchors, R = 4): each output within ``SCHUR_MAX_ULP`` (the ulp
histograms printed), ``S x`` also against the matvec before B18 (within
``B18_BEFORE_TOL`` of its scale), a second call's bits equal, each pass warm, cold, plain,
bound and ``torch.segment_reduce`` over its rows (a yardstick), one ``S x``'s
launches before B18 and through it, and ``schur_ba_cg`` through B18 against the
plain passes; after the two ranks' main path, "sharded BA" runs
``schur_ba(group=)`` and ``schur_ba_cg(group=)`` at one NCCL rank (the single
forms' bits) and over two gloo ranks on this card (within 1e-4); last,
"backend, sharded blackout" runs the blackout cut through ``run_slam
--sharded`` at one NCCL rank: the single run's ATE, recovery events,
keyframes and refined ATE to every digit. Every backend run's
``schur_ba_cg`` calls launch each B18 pass once a CG step (checked); B18's
rows in the kernel table count the single blackout run's launches.

The launch counts are set to 0 just before each path is driven and read just
after it.

Before the card's line and the kernel table, the run's wall seconds
(``"phase": "wall"``). The second-to-last line is the kernel table as one
JSON object; the last line is ``{"ok": true, "device": {...}}``, printed
only when every phase passed. Any failed phase exits 1 without it.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
HOLD_CYCLES = 30_000_000  # about 20 ms of device spinning at the card's clock
L2_FLUSH_BYTES = 128 << 20  # written before each cold launch: more than the H100's 50 MB of L2
N_FRAMES = 10
N_FRAMES_FIXED_ASSOC = 6
WARM_FRAMES = 2
N_FRAMES_BRICK = 10
N_FRAMES_BENCH = 10
N_FRAMES_REFRESH = 4
PROFILE_RETAKES = 2  # frames profiled again where the profiler's record of one disagrees with the host's calls
# spin kernels launched at the start of a profiled frame's window, before the frame (_lead_profile): the profiler
# drops the first device events of a window, more the longer the process has run (on an H100: 8 after 90 s, 18
# after 210 s); the spins take that loss and are left out of the frame's record
PROFILE_LEAD = 256
LEAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's device kernel
BRICK_CAP = 2816  # bench.py's fusion_brick_cap
# bench.py:78-95's configuration over configs/synthetic.yaml
BENCH_OPTIONS = dict(volume_layout="brick", fusion_mode="brick", fusion_brick_cap=BRICK_CAP, fusion_overflow="dense",
                     raycast_normals="screen", raycast_march="temporal", model_map_level=1, icp_fixed_assoc=True,
                     raycast_refine="reuse")
REFRESH_COVERAGE = 2.0  # raycast_temporal_min_coverage above 1: every frame takes the hier2 refresh
WINDOW = 12  # bench.py's raycast_temporal_window and raycast_hier_window
DEVICE_DEPTH_FRAME = 3  # the bench run's second run feeds this frame's depth as a tensor already on the card
# launches of a frame (the host's launch, copy and fill calls, each one device event; profile_step.py's count):
# as configs/synthetic.yaml says, with the cached association at half-resolution model maps (each level's
# first ICP launch writes it: no launch of its own), with brick fusion (B3a, B3b and B3c where K2 was, one
# launch each), and in bench.py's configuration (the brick layout, the temporal march: B4 where K3 and K5
# were, the anchors and their coverage, one copy for both flags; the screen normals B4n computed in K6's
# launch, so no launch of their own: 675, where B4n's own launch made it 676 before; on a refresh frame B5a,
# B5b and B4 once more); 3 of them in `preprocess` (K1, K7 once for both coarser levels, K8 once for all levels)
# The dense layout's marches (B14): skip is B14a (two device kernels, as B5a) and B14b where K3 was (two more),
# hier K3 at stride 2 and B14c (one more), hier_skip B14a, B14b at stride 2 and B14c (three more), hier2 K3 at
# stride 4 and B14c twice (two more); the screen normals ride in K6's launch and the bilinear branch in K2's or
# B3c's (none more)
FRAME_LAUNCHES = {"main path": 658, "main path, fixed association": 658, "main path, brick fusion": 660,
                  "main path, bench": 675, "main path, bench refresh": 679, "main path, hier2": 660,
                  "main path, skip": 660, "main path, hier": 659, "main path, hier_skip": 661,
                  "main path, bench bilinear": 675,
                  # the brick layout's other raycasts: no anchors, coverage or second flag off the temporal march
                  # (16 launches fewer, all outside the stages), B5a (two device kernels), B5b, B4 once
                  # (hier_skip) or twice (hier2_skip) and K5r where bench.py's frame has B4 (raycast 10, 11, 12
                  # launches for bench's 7); the temporal march with secant2 B4 and K5r; B16 where B4 was
                  "main path, brick skip": 662, "main path, brick hier_skip": 663,
                  "main path, brick hier2_skip": 664, "main path, brick hier_skip tsdf": 663,
                  "main path, brick temporal secant2": 676, "main path, bench phase1": 675,
                  # B15: the split (B15s) or fine (B15f) classifier where B3b was, and B3c's MIXED variant where
                  # B3c was; the subcell stage adds B15c's launch (and B3c's subcell variant where B3c was)
                  "main path, bench split": 675, "main path, bench fine": 675, "main path, bench subcell": 676,
                  "main path, brick fine": 660}
# the dense layout's settings (configs/synthetic.yaml with these options): the path's own, hier2 with screen normals
# and bilinear fusion over N_FRAMES; skip, hier and hier_skip (TSDF normals) and bench.py's configuration with
# bilinear fusion over N_FRAMES_MARCH each; process_frames over N_FRAMES_SCAN frames in chunks of SCAN_CHUNK
BILINEAR_THRESHOLD = 0.1
HIER2_OPTIONS = dict(raycast_march="hier2", raycast_normals="screen", bi_interpolate_threshold=BILINEAR_THRESHOLD)
DENSE_MARCHES = {"main path, skip": "skip", "main path, hier": "hier", "main path, hier_skip": "hier_skip"}
N_FRAMES_MARCH = 4
# the brick layout's other raycasts (bench.py's configuration with the march, refine and normals changed; the
# secant2 refine is K5r): skip, hier_skip and hier2_skip with screen normals, hier_skip with TSDF normals, the
# temporal march with secant2, and bench.py's configuration with the first-event march (B16); N_FRAMES_MARCH each
SECANT_OPTIONS = dict(BENCH_OPTIONS, raycast_refine="secant2")
BRICK_RAYCASTS = {
    "main path, brick skip": dict(SECANT_OPTIONS, raycast_march="skip"),
    "main path, brick hier_skip": dict(SECANT_OPTIONS, raycast_march="hier_skip"),
    "main path, brick hier2_skip": dict(SECANT_OPTIONS, raycast_march="hier2_skip"),
    "main path, brick hier_skip tsdf": dict(SECANT_OPTIONS, raycast_march="hier_skip", raycast_normals="tsdf"),
    "main path, brick temporal secant2": dict(SECANT_OPTIONS),
    "main path, bench phase1": dict(BENCH_OPTIONS, raycast_temporal_phase1=4),
}
# B15's options on the main path (N_FRAMES_MARCH each, twice for the same ATE digits): bench.py's configuration with
# the split classifier, the fine one, the subcell stage with lists of the cap (which cannot overflow), and the dense
# layout with bench.py's brick fusion and the fine classifier. Each volume is K2's bit for bit, so the bench
# settings' poses are the bench run's first frames bit for bit, and the dense layout's run has the first run's ATE
B15_RUNS = {
    "main path, bench split": dict(BENCH_OPTIONS, fusion_classify_split=True),
    "main path, bench fine": dict(BENCH_OPTIONS, fusion_classify_fine=True),
    "main path, bench subcell": dict(BENCH_OPTIONS, fusion_subcell_cap=BRICK_CAP),
    "main path, brick fine": dict(fusion_mode="brick", fusion_brick_cap=BRICK_CAP, fusion_overflow="dense",
                                  fusion_classify_fine=True),
}
N_FRAMES_SCAN = 6
SCAN_CHUNK = 3
PROBE_E_STEPS = 64  # probe E's dependent steps a ray (phase_probes): B5b's latency floor takes its time a step
PREPROCESS_LAUNCHES = 3
PROBES_SRC = "xslam_tpu_torch/csrc/gather_probes.cu"
POINT_CAPACITY = 1_000_000  # run_slam's draw_pcd capacity
MESH_CAPACITY = 2_000_000  # run_slam's --mesh capacity
# B17's least operations (csrc/mesh.cu): a cell's observed test (W > 0, |F| < 1 and the and, at its 8 corners) 24;
# its inside-codes, a compare and an or a corner, 6 tetrahedra of 4 corners 48 or the cube's 8 corners 16; a
# triangle's three vertices, each a difference, a division, the clamp's two, 1 - frac and per axis two corner
# positions (2 each) and the blend (3) 6 + 3 * 7 = 27, 81 a triangle
MESH_CELL_OPS = 24
MESH_CODE_OPS = {"mesh_tetra": 48, "mesh_mc": 16}
MESH_TRIANGLE_OPS = 81
MESH_SLAB = 16  # extract_mesh_mc's default X-slab, run_slam's
# the realistic paths: configs/ICL_realistic.yaml's dataset cut from 301 frames to 30 (ATE < 0.02 m, a checkpoint
# after 15 frames resumed to the end), configs/7scenes_realistic.yaml's to 10, both rendered by the port's generator
N_FRAMES_ICL = 30
CHECKPOINT_AT = 15
N_FRAMES_7SCENES = 10
# the backend configs, each cut by --frames from a dataset the port's generator renders (its noise and options as
# BASELINE.md:642, :665 rendered them): configs/ICL_blackout.yaml over 60 frames with frames 30-39 blank,
# configs/ICL_loop_backend.yaml on the shortest revisit cut that verified a loop on the H100 (98 frames; the cuts of
# 86-97 frames verify none), configs/ICL_realistic_backend.yaml over 30 frames
BLACKOUT = (30, 40)
N_FRAMES_LOOP = 98
BACKEND_RUNS = {"blackout": ("configs/ICL_blackout.yaml", 60, ["0.0015", "--blackout", str(BLACKOUT[0]),
                                                                 str(BLACKOUT[1])]),
                "loop": ("configs/ICL_loop_backend.yaml", N_FRAMES_LOOP, ["0.004", "--revisit"]),
                "realistic": ("configs/ICL_realistic_backend.yaml", 30, ["0.0015"])}
RENDER_TIMEOUT_S = 400
# B12: the offset of the tsdf_loss phase's pose from frame 3's true pose (xi), and the float32 operations that
# its function needs at a voxel that passes gt's test, counted from csrc/tsdf_loss.cu::voxel_loss with every
# term of a lifted constant's zero lanes dropped (compares, floors, rounds and converts included, the integer
# address arithmetic left out): the value lane 89 (camera point 18, 1 / z 2, image point 6, the cell and the
# nearest tap 10, the taps' tests 4, the bilinear weights and sum 19, the range 2, the ray's lambda 10, the two
# distances 8, the error 5, the front test, the select, the loss and its sums 5); one first-derivative lane 81
# and one second-derivative lane 143 (camera point 18 / 18, 1 / z 2 / 6, image point 8 / 16, bilinear sum
# 22 / 38, lambda 10 / 21, distances 16 / 35, error, loss and sum 5 / 9); the two square roots' derivative
# coefficients 10. The function needs the value lane once, the six first-derivative lanes once and one
# second-derivative lane a pair (1 + 6 + 21 lanes, the lanes the kernel runs); gt's test 3 a voxel (two compares
# and an absolute value)
TSDF_LOSS_OFFSET = (0.02, -0.01, 0.015, 0.01, -0.01, 0.005)
TSDF_LOSS_VALUE_OPS = 89
TSDF_LOSS_E1_OPS = 81
TSDF_LOSS_E12_OPS = 143
TSDF_LOSS_SQRT_OPS = 10
TSDF_BAND_OPS = 3
TSDF_LOSS_FIELD_PAIRS = (0, 5, 10, 20)  # (e0, e0), (e5, e5), (e1, e3), (e4, e5)
# the relocalize path: apps/relocalize_demo.py's defaults (12 map frames, 3 holdouts, 12 Newton iterations);
# holdout 0 again with 4 iterations through B12 and through its plain version; the odometry path's frames
RELOC_FRAMES = 12
RELOC_HOLDOUTS = 3
RELOC_ITERS = 12
RELOC_CHECK_ITERS = 4
N_FRAMES_ODOMETRY = 10

# kernel: (source, the TPU/XLA code it replaces, the path whose launches are reported); the association
# kernel runs on no path: each level's first icp_system launch writes the association, and the kernel is the
# reference that index is held against, so it is listed with its main-path count, 0
FOLDED = {"icp_associate": "icp_system"}
# the device kernels that one launch count of a wrapper stands for, listed where the wrapper's work is more
# than a kernel's name says: B3b's classes and ranks are one kernel
DEVICE_KERNELS = {"classify_bricks": ("classify_bricks_kernel",),
                  "skip_field": ("event_mask_kernel", "skip_distance_kernel"),
                  "skip_field_dense": ("event_mask_kernel", "skip_distance_kernel"),
                  "extract_points": ("extract_count_kernel", "extract_points_kernel", "extract_normals_kernel"),
                  "mesh_tetra": ("mesh_count_kernel", "mesh_scan_kernel", "mesh_rows_kernel"),
                  "mesh_mc": ("mesh_count_kernel", "mesh_scan_kernel", "mesh_rows_kernel"),
                  "tsdf_band": ("tsdf_band_count_kernel", "tsdf_band_list_kernel")}
KERNELS = {
    "bilateral_filter": ("xslam_tpu_torch/csrc/bilateral.cu", "xslam_tpu/ops/pallas_kernels.py:99", "main path"),
    "fuse_volume": ("xslam_tpu_torch/csrc/fusion.cu", "xslam_tpu/ops/fusion.py:108", "main path"),
    "march_fixed": ("xslam_tpu_torch/csrc/march.cu", "xslam_tpu/ops/raycast.py:136", "main path"),
    "raycast_refine": ("xslam_tpu_torch/csrc/refine.cu", "xslam_tpu/ops/raycast.py:901", "main path"),
    "resize_model_maps": ("xslam_tpu_torch/csrc/maps.cu", "xslam_tpu/models/kinfu.py:527-529,546", "main path"),
    "depth_pyramid": ("xslam_tpu_torch/csrc/maps.cu", "xslam_tpu/ops/preprocess.py:78", "main path"),
    "depth_mips": ("xslam_tpu_torch/csrc/bricks.cu", "xslam_tpu/ops/fusion_brick.py:60", "main path, brick fusion"),
    "classify_bricks": ("xslam_tpu_torch/csrc/bricks.cu", "xslam_tpu/ops/fusion_brick.py:219",
                        "main path, brick fusion"),
    "fuse_bricks": ("xslam_tpu_torch/csrc/bricks.cu", "xslam_tpu/ops/fusion_brick.py:636", "main path, brick fusion"),
    "vertex_normal_maps": ("xslam_tpu_torch/csrc/maps.cu", "xslam_tpu/ops/preprocess.py:115", "main path"),
    "icp_system": ("xslam_tpu_torch/csrc/icp.cu", "xslam_tpu/ops/icp.py:107", "main path"),
    "icp_associate": ("xslam_tpu_torch/csrc/icp.cu", "xslam_tpu/ops/icp.py:72", "main path, fixed association"),
    "window_march": ("xslam_tpu_torch/csrc/window.cu", "xslam_tpu/ops/raycast.py:579,787,1018", "main path, bench"),
    "window_march_first_event": ("xslam_tpu_torch/csrc/window.cu", "xslam_tpu/ops/raycast.py:621,1018",
                                 "main path, bench phase1"),
    "raycast_refine_bricks": ("xslam_tpu_torch/csrc/refine.cu, rows.cuh",
                              "xslam_tpu/ops/raycast.py:901,1132 + xslam_tpu/ops/raycast_bricks.py:196",
                              "main path, brick skip"),
    "fuse_volume_bilinear": ("xslam_tpu_torch/csrc/fusion.cu, fusion.cuh",
                             "xslam_tpu/ops/fusion.py:108,152-153 + xslam_tpu/ops/sampling.py:39", "main path, hier2"),
    "fuse_bricks_bilinear": ("xslam_tpu_torch/csrc/bricks.cu, fusion.cuh", "xslam_tpu/ops/fusion_brick.py:636,726-729",
                             "main path, bench bilinear"),
    "march_fixed_strided": ("xslam_tpu_torch/csrc/march.cu", "xslam_tpu/ops/raycast.py:136,546-550,570-573",
                            "main path, hier2"),
    "skip_field_dense": ("xslam_tpu_torch/csrc/skip.cu", "xslam_tpu/ops/raycast.py:207,240", "main path, skip"),
    "march_skip_dense": ("xslam_tpu_torch/csrc/skip.cu", "xslam_tpu/ops/raycast.py:254", "main path, skip"),
    "window_march_dense": ("xslam_tpu_torch/csrc/window.cu", "xslam_tpu/ops/raycast.py:787,518,555",
                           "main path, hier2"),
    "model_map_normals": ("xslam_tpu_torch/csrc/maps.cu", "xslam_tpu/ops/raycast.py:1087", "main path, bench"),
    "skip_field": ("xslam_tpu_torch/csrc/skip.cu", "xslam_tpu/ops/bricks.py:139,151", "main path, bench refresh"),
    "march_skip": ("xslam_tpu_torch/csrc/skip.cu", "xslam_tpu/ops/raycast.py:254", "main path, bench refresh"),
    # B5b's ray form, a thread a ray, over the brick skip march's 240x320 rays (B14b's launches take it too)
    "march_skip_rays": ("xslam_tpu_torch/csrc/skip.cu", "xslam_tpu/ops/raycast.py:254", "main path, brick skip"),
    "extract_points": ("xslam_tpu_torch/csrc/extract.cu", "xslam_tpu/ops/extract.py:59", "main path, ICL realistic"),
    # B17: run_slam --mesh tetra on the ICL run, --mesh mc on the 7-Scenes run
    "mesh_tetra": ("xslam_tpu_torch/csrc/mesh.cu", "xslam_tpu/ops/extract.py:154", "main path, ICL realistic"),
    "mesh_mc": ("xslam_tpu_torch/csrc/mesh.cu", "xslam_tpu/ops/extract.py:332", "main path, 7-Scenes realistic"),
    # B12's count stands for tsdf_loss_kernel (REDUCE, VALUE) and tsdf_field_kernel (FIELD, on no path)
    "tsdf_loss": ("xslam_tpu_torch/csrc/tsdf_loss.cu", "xslam_tpu/ops/tsdf_loss.py:65", "relocalize path"),
    "tsdf_band": ("xslam_tpu_torch/csrc/tsdf_loss.cu", "xslam_tpu/ops/tsdf_loss.py:99", "relocalize path"),
    "classify_bricks_split": ("xslam_tpu_torch/csrc/bricks.cu", "xslam_tpu/ops/fusion_brick.py:172,219,404-463",
                              "main path, bench split"),
    "classify_bricks_fine": ("xslam_tpu_torch/csrc/bricks.cu", "xslam_tpu/ops/fusion_brick.py:489",
                             "main path, bench fine"),
    "classify_subcells": ("xslam_tpu_torch/csrc/bricks.cu", "xslam_tpu/ops/fusion_brick.py:730-791",
                          "main path, bench subcell"),
    "fuse_bricks_mixed": ("xslam_tpu_torch/csrc/bricks.cu, fusion.cuh", "xslam_tpu/ops/fusion_brick.py:636,682-688",
                          "main path, bench split"),
    "fuse_bricks_subcell": ("xslam_tpu_torch/csrc/bricks.cu, fusion.cuh", "xslam_tpu/ops/fusion_brick.py:636,758-821",
                            "main path, bench subcell"),
    # B19: the sharded engine's slab hooks, at world size 1 over NCCL (the slab is the volume, offset 0)
    "fuse_volume_slab": ("xslam_tpu_torch/csrc/fusion.cu, fusion.cuh", "xslam_tpu/ops/fusion.py:99-100",
                         "main path, sharded"),
    "classify_bricks_slab": ("xslam_tpu_torch/csrc/bricks.cu", "xslam_tpu/ops/fusion_brick.py:209-210",
                             "main path, sharded fast"),
    "fuse_bricks_slab": ("xslam_tpu_torch/csrc/bricks.cu, fusion.cuh", "xslam_tpu/ops/fusion_brick.py:669,721",
                         "main path, sharded fast"),
    "march_fixed_shard": ("xslam_tpu_torch/csrc/march.cu", "xslam_tpu/ops/raycast.py:136-200",
                          "main path, sharded"),
    "raycast_refine_shard": ("xslam_tpu_torch/csrc/refine.cu", "xslam_tpu/ops/raycast.py:901-932",
                             "main path, sharded"),
    "raycast_finalize": ("xslam_tpu_torch/csrc/refine.cu", "xslam_tpu/ops/raycast.py:1132", "main path, sharded"),
    "icp_tail": ("xslam_tpu_torch/csrc/icp.cu", "xslam_tpu/parallel/sharded.py:163-222 + xslam_tpu/ops/icp.py:294",
                 "main path, sharded"),
    # B19e: B5a's two kernels apart, over a rank's slab of rows and over the gathered mask (two ranks on the card)
    "event_mask": ("xslam_tpu_torch/csrc/skip.cu", "xslam_tpu/parallel/sharded.py:314-316 + xslam_tpu/ops/bricks.py:129",
                   "main path, sharded bench refresh, 2 ranks"),
    "skip_distance": ("xslam_tpu_torch/csrc/skip.cu",
                      "xslam_tpu/parallel/sharded.py:317 + xslam_tpu/ops/bricks.py:141,156",
                      "main path, sharded bench refresh, 2 ranks"),
    # B18: the two passes of S x in schur_ba_cg, launched by the blackout run's refinement
    "schur_cg_anchors": ("xslam_tpu_torch/csrc/schur_cg.cu", "xslam_tpu/models/ba.py:602-605", "backend, blackout"),
    "schur_cg_keyframes": ("xslam_tpu_torch/csrc/schur_cg.cu", "xslam_tpu/models/ba.py:606-608",
                           "backend, blackout"),
    "probe_a": (PROBES_SRC, "apps/probe_pallas_gather.py:56", "probe path"),
    "probe_b": (PROBES_SRC, "apps/probe_pallas_gather.py:77", "probe path"),
    "probe_c": (PROBES_SRC, "apps/probe_pallas_gather.py:98", "probe path"),
    "probe_d": (PROBES_SRC, "apps/probe_pallas_gather.py:121", "probe path"),
    "probe_e": (PROBES_SRC, "apps/probe_pallas_gather.py:142", "probe path"),
}


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events. The
    stream is first held busy for some 20 ms, so that the host queues the
    calls ahead of the device and a kernel shorter than the host's launch
    pace is timed at its own length, not the host's."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_cold_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` as a caller finds it after other work: the
    L2 cache is flushed by writing a scratch buffer larger than it before
    each call, and only the call itself is timed, by CUDA events around it,
    on a stream held busy as in :func:`time_ms`."""
    scratch = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(HOLD_CYCLES)
    for i, (start, end) in enumerate(events):
        scratch.fill_(float(i))
        start.record()
        fn()
        end.record()
    events[-1][1].synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def frac_equal(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of equal entries (NaN equal to NaN), counted exactly: a float32
    mean on the card multiplies by a rounded reciprocal (0.99999994 for 13,983
    equal entries)."""
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return int(same.sum()) / same.numel()


def max_abs(a: torch.Tensor, b: torch.Tensor, mask=None) -> float:
    d = (a - b).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, d)
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.numel() else 0.0


def max_ulp(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in float32 steps between ``a`` and ``b`` where both
    are numbers (0: equal everywhere they are)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    both = ~torch.isnan(a) & ~torch.isnan(b)
    d = (ordered(a) - ordered(b)).abs()[both]
    return int(d.max()) if d.numel() else 0


def same_nans(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(torch.isnan(a), torch.isnan(b)))


def csrc_constant(source: str, name: str) -> int:
    """A ``constexpr int`` of a kernel source under ``xslam_tpu_torch/csrc``."""
    with open(os.path.join(ROOT, "xslam_tpu_torch", "csrc", source)) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    check(m is not None, f"{source} has no constexpr int {name}")
    return int(m.group(1))


def emit(tag: str, **fields):
    print(json.dumps({"phase": tag, **fields}), flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


# ----------------------------------------------------------------------------
def phase_rounding(ctx):
    from xslam_tpu_torch.apps import torch_rounding

    report = torch_rounding.measure(ctx["device"])
    emit("PyTorch's rounding on the card", **report)
    off = torch_rounding.not_followed(report)
    check(not off, f"torch {torch.__version__} no longer rounds as the kernels K3, K5, K6, K8 and B12 repeat it "
                   f"(csrc/rays.cuh, refine.cu, maps.cu, tsdf_loss.cu follow torch 2.11): {off}")


def _bilateral_table_ulp(table: torch.Tensor) -> int:
    """K1's weight table against ``torch.exp`` of the tap's expression as the
    plain version writes it, in float32 steps; its last column must be 0."""
    from xslam_tpu_torch.ops import preprocess

    r = preprocess.BILATERAL_R
    inv_ss = 0.5 / (preprocess.SIGMA_SPACE * preprocess.SIGMA_SPACE)
    inv_sc = 0.5 / (preprocess.SIGMA_COLOR * preprocess.SIGMA_COLOR)
    space2 = sorted({dy * dy + dx * dx for dy in range(r + 1) for dx in range(r + 1)})
    diff = torch.arange(table.numel() // len(space2), dtype=torch.float32, device=table.device)
    rows = [torch.exp(-(float(np.float32(s2) * np.float32(inv_ss)) + (diff * diff) * inv_sc)) for s2 in space2]
    table = table.view(len(space2), -1)
    check(bool((table[:, -1] == 0).all()), "K1's weight table does not end in a zero column")
    return max_ulp(table, torch.stack(rows))


def phase_bilateral(ctx):
    from xslam_tpu_torch.ops import kernels, preprocess

    depth = torch.as_tensor(ctx["depths"][0], device=ctx["device"])
    out = kernels.bilateral_filter(depth)
    ref = preprocess.bilateral_filter(depth)
    torch.cuda.synchronize()
    err, eq = max_abs(out, ref), frac_equal(out, ref)
    ms = time_ms(lambda: kernels.bilateral_filter(depth), 50)
    plain = time_ms(lambda: preprocess.bilateral_filter(depth), 3)
    H, W = depth.shape
    bms, by = bound_ms(H * W * (2 + 4), H * W * 169 * 8)

    table_ulp = _bilateral_table_ulp(kernels.bilateral_weights(depth.device))
    emit("K1 bilateral_filter", shape=[H, W], max_abs_err=err, frac_equal=eq, ms=ms, plain_ms=plain,
         bound_ms=bms, bound_by=by, library_ms=None, library_note="no single PyTorch call computes it",
         weight_table_max_ulp=table_ulp)
    check(err <= 1.0 and eq > 0.999, f"K1 disagrees with its plain version: max {err}, equal {eq}")
    check(table_ulp <= 1, f"K1's weight table is {table_ulp} float32 steps from torch.exp of the tap's expression")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)


def _seeded_c2v(ctx, c2v: np.ndarray, rng):
    """The dual camera->volume pose ``c2v`` with a seeded derivative lane, so
    the kernels' grad lane carries real values."""
    from xslam_tpu_torch.csfd.single import CSFD

    g = torch.as_tensor((1e-2 * rng.standard_normal((4, 4))).astype(np.float32), device=ctx["device"])
    g[3] = 0.0
    return CSFD(torch.as_tensor(np.asarray(c2v, np.float32), device=ctx["device"]), g)


def _v2c(ctx, pose_c2w: np.ndarray, rng):
    """Dual volume->camera and camera->volume poses of a ground-truth camera
    (:func:`_seeded_c2v`)."""
    from xslam_tpu_torch.geometry import se3

    w2v = np.asarray(ctx["config"].world2volume, np.float32)
    c2v = _seeded_c2v(ctx, (w2v @ pose_c2w).astype(np.float32), rng)
    return se3.inverse(c2v), c2v


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera-to-volume pose of a camera at ``eye`` looking at ``target``."""
    z = (target - eye) / np.linalg.norm(target - eye)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    c2v = np.eye(4)
    c2v[:3, :3] = np.stack([x, np.cross(z, x), z], axis=1)
    c2v[:3, 3] = eye
    return c2v


def _regression_pose() -> np.ndarray:
    """The camera-to-world pose on which the JAX package's brick fusion once
    left dense fusion by 22 voxels (its window-coverage regression test):
    Rx Ry Rz of the angles, then the translation, carried here as numbers."""
    ang = np.array([-0.13110635, -0.27977643, -0.03972851])
    c, s = np.cos(ang), np.sin(ang)
    rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
    ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
    rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
    c2w = np.eye(4)
    c2w[:3, :3] = rx @ ry @ rz
    c2w[:3, 3] = [0.29632427, -0.26935779, -0.4479787]
    return c2w


def phase_fusion(ctx):
    from xslam_tpu_torch.csfd.single import CSFD
    from xslam_tpu_torch.geometry import se3
    from xslam_tpu_torch.io.synthetic import default_scene, render_depth
    from xslam_tpu_torch.ops import fusion, kernels

    cfg, eng, dev = ctx["config"], ctx["engine_cfg"], ctx["device"]
    intr = cfg.intrinsics
    rng = np.random.default_rng(0)
    vol = fusion.create_volume(eng, dev)
    poses = [np.linalg.inv(ctx["gt"][0]) @ p for p in ctx["gt"]]
    for i in range(3):
        v2c, _ = _v2c(ctx, poses[i], rng)
        depth_m = fusion.scale_depth(torch.as_tensor(ctx["depths"][i], device=dev))
        fusion.integrate(vol, depth_m, se3.rotation(v2c), se3.translation(v2c), intr, eng)
    ctx["volume"] = vol
    orbit_v2c, _ = _v2c(ctx, poses[3], rng)

    def dual_v2c(c2v: np.ndarray) -> CSFD:
        return se3.inverse(_seeded_c2v(ctx, c2v, rng))

    # (name, volume->camera pose, depth in metres): the orbit's next frame; a camera in a corner of
    # the volume that looks at its middle, on a seeded depth; the regression pose, on the scene it sees
    w2v = np.asarray(cfg.world2volume, np.float64)
    extent = np.asarray(eng.resolution, np.float64) * eng.voxel_size
    seeded = rng.uniform(300.0, 6000.0, (intr.height, intr.width))
    seeded[rng.random(seeded.shape) < 0.1] = 0.0
    regression = _regression_pose()
    cases = [
        ("orbit frame 3", orbit_v2c, ctx["depths"][3]),
        ("volume corner", dual_v2c(_look_at(np.full(3, 0.2), extent / 2)), seeded.astype(np.uint16)),
        ("window-coverage regression pose", dual_v2c(w2v @ regression),
         render_depth(default_scene(), regression, intr)),
    ]
    ctx["fusion_cases"] = cases
    table = None
    for name, v2c, depth_u16 in cases:
        r, t = se3.rotation(v2c), se3.translation(v2c)
        depth_m = fusion.scale_depth(torch.as_tensor(depth_u16, device=dev))
        args = (depth_m, r, t, intr, eng.voxel_size, eng.trunc_dist, eng.max_weight)
        a = [x.clone() for x in vol]
        b = [x.clone() for x in vol]
        kernels.fuse_volume(*a, *args)
        kernels.fuse_volume_plain(*b, *args)
        torch.cuda.synchronize()
        equal = [bool(torch.equal(x, y)) for x, y in zip(a, b)]
        err_v, err_g = max_abs(a[0], b[0]), max_abs(a[1], b[1])
        updated = int((b[2] != vol.weight).sum())
        keep = fusion.tile_keep_mask(r, t, intr, eng.resolution, eng.voxel_size)
        kept_voxels = int(keep.sum()) * int(np.prod(fusion.FUSE_TILE))
        ms = time_ms(lambda: kernels.fuse_volume(*a, *args), 20)
        plain = time_ms(lambda: kernels.fuse_volume_plain(*b, *args), 2)
        # What the kernel needs: every voxel projects (69 operations up to the
        # pixel gate); an updated voxel does 60 more and reads and writes its
        # three planes (24 B). Voxels that pass the pixel gate and then fail the
        # depth or truncation test are not counted, so this is a lower bound.
        n_bytes = depth_m.numel() * 4 + 24 * 4 + updated * 24
        bms, by = bound_ms(n_bytes, a[0].numel() * 69 + updated * 60)
        bound_note = "every voxel to its pixel gate"
        if ms < bms:  # the tile test spared more than that: count the voxels of the tiles it kept
            bms, by = bound_ms(n_bytes, kept_voxels * 69 + updated * 60)
            bound_note = "the voxels of the kept tiles to their pixel gate"
        del a, b
        emit("K2 fuse_volume", case=name, shape=list(vol.value.shape), planes_bit_equal=equal,
             max_abs_err_value=err_v, max_abs_err_grad=err_g, voxels_updated=updated,
             tiles_kept_fraction=float(keep.float().mean()), ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
             bound_counts=bound_note, library_ms=None, library_note="no single PyTorch call computes it")
        check(all(equal), f"K2 is not bit-equal to its plain version at {name}: value, grad, weight {equal}")
        check(updated > 100_000, f"K2's case {name} updates only {updated} voxels")
        if table is None:
            table = dict(max_abs_err=max(err_v, err_g), ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)
            ctx["fuse_volume_ms"] = ms
    return table


def _bricks_equal(a, b) -> bool:
    """Two BrickClasses hold the same classes, ranks, counts, flag, lists
    (each list up to its count: the kernel leaves the rest unwritten) and
    windows (the split classifier's)."""
    n_active, n_work = (int(x) for x in b.totals)
    return ((a.aux is None) == (b.aux is None) and (a.aux is None or bool(torch.equal(a.aux, b.aux)))
            and bool(torch.equal(a.cls, b.cls)) and bool(torch.equal(a.rank, b.rank))
            and bool(torch.equal(a.totals, b.totals)) and bool(a.overflow) == bool(b.overflow)
            and bool(torch.equal(a.active_ids[:n_active], b.active_ids[:n_active]))
            and bool(torch.equal(a.work_ids[:n_work], b.work_ids[:n_work])))


def phase_bricks(ctx):
    """B3a, B3b and B3c against their plain versions, and B3c's volume
    against K2's, on the volume of three fused frames at K2's three poses:
    the mip table and the classes and lists equal; the fused planes equal
    K2's with ``==`` and equal NaN masks, bit for bit (the sign of zero
    counted apart); with cap 64, ``"flag"`` equals the plain version and
    ``"dense"`` equals K2. B3b runs twice back to back, the second time on
    the next pose's table, and both results equal the plain version's: the
    status words the first launch leaves carry its epoch and count for
    nothing in the second. Each
    kernel timed from prepared arguments beside K2 on the same frame, warm
    and cold (L2 flushed before each launch, as the frame finds its inputs);
    B3a beside ``torch.amax`` over its 8 px tiles and B3b beside
    ``torch.cumsum`` over its ACTIVE flags, yardsticks. The classes are taken
    with a cap of every brick (the volume corner's seeded depth makes some
    5,700 bricks ACTIVE, past bench.py's 2816), so B3c fuses every ACTIVE
    brick exactly at each pose."""
    from xslam_tpu_torch.geometry import se3
    from xslam_tpu_torch.ops import bricks, fusion, kernels
    from xslam_tpu_torch.ops import fusion_brick as fb

    cfg, eng, dev = ctx["config"], ctx["engine_cfg"], ctx["device"]
    intr = cfg.intrinsics
    vol = ctx["volume"]
    res = list(eng.resolution)
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    H, W = intr.height, intr.width
    layout = fb.mip_layout(H, W)
    fargs = kernels.fusion_args(intr, eng.voxel_size, eng.trunc_dist, eng.max_weight)
    cap = int(np.prod(eng.resolution)) // fb.BRICK ** 3
    rows = {}
    cases = ctx["fusion_cases"]
    frames = []  # (depth in metres, fusion pose, B3a's table) of each case
    for _, v2c, depth_u16 in cases:
        depth_m = fusion.scale_depth(torch.as_tensor(depth_u16, device=dev))
        frames.append((depth_m, kernels.fusion_pose(se3.rotation(v2c), se3.translation(v2c)), fb.depth_mips(depth_m)))
    for i, (name, v2c, _) in enumerate(cases):
        r, t = se3.rotation(v2c), se3.translation(v2c)
        depth_m, pose, table = frames[i]
        table_plain = fb.depth_mips_plain(depth_m)
        # B3b twice back to back, the second time on the next case's table and pose
        classes = fb.classify_bricks(table, pose, intr, eng, cap)
        _, pose_next, table_next = frames[(i + 1) % len(frames)]
        second = fb.classify_bricks(table_next, pose_next, intr, eng, cap)
        classes_plain = fb.rank_bricks_plain(fb.classify_bricks_plain(table_plain, pose, intr, eng), cap)
        second_plain = fb.rank_bricks_plain(fb.classify_bricks_plain(table_next, pose_next, intr, eng), cap)
        k2 = [x.clone() for x in vol]
        brick = [x.clone() for x in vol]
        plain = [x.clone() for x in vol]
        kernels.fuse_volume(*k2, depth_m, r, t, intr, eng.voxel_size, eng.trunc_dist, eng.max_weight)
        fb.fuse_bricks(*brick, depth_m, pose, intr, eng, classes, cap, True)
        fb.fuse_bricks_plain(*plain, depth_m, pose, intr, eng, classes_plain, cap, True)
        # the row variant (the brick layout) on the brick rows of the same pre-frame volume
        rows_b = bricks.from_dense(*vol)
        fb.fuse_bricks(*rows_b, depth_m, pose, intr, eng, classes, cap, True)
        torch.cuda.synchronize()
        rows_k2 = bricks.from_dense(*k2)
        bits_rows = [bool(torch.equal(a.view(torch.int32), b.view(torch.int32))) for a, b in zip(rows_b, rows_k2)]
        del rows_k2
        table_equal = bool(torch.equal(table, table_plain))
        classes_equal = _bricks_equal(classes, classes_plain)
        second_equal = _bricks_equal(second, second_plain)
        second_differs = not bool(torch.equal(classes_plain.cls, second_plain.cls))
        eq_k2 = [bool(torch.equal(a, b)) and same_nans(a, b) for a, b in zip(brick, k2)]
        bits_k2 = [bool(torch.equal(a.view(torch.int32), b.view(torch.int32))) for a, b in zip(brick, k2)]
        zero_sign = sum(int(((a == b) & (a.view(torch.int32) != b.view(torch.int32))).sum()) for a, b in zip(brick, k2))
        eq_plain = [bool(torch.equal(a, b)) for a, b in zip(brick, plain)]
        n_active, n_work = (int(x) for x in classes.totals)
        counts = torch.bincount(classes.cls.reshape(-1), minlength=4).tolist()
        updated = int((k2[2] != vol.weight).sum())

        # cap 64: the frame overflows; "flag" leaves the bricks past the cap unfused, "dense" fuses it exactly
        small = fb.classify_bricks(table, pose, intr, eng, 64)
        flag_k, flag_p, dense_k = ([x.clone() for x in vol] for _ in range(3))
        fb.fuse_bricks(*flag_k, depth_m, pose, intr, eng, small, 64, False)
        fb.fuse_bricks_plain(*flag_p, depth_m, pose, intr, eng, small, 64, False)
        fb.fuse_bricks(*dense_k, depth_m, pose, intr, eng, small, 64, True)
        torch.cuda.synchronize()
        flag_equal = all(bool(torch.equal(a, b)) for a, b in zip(flag_k, flag_p))
        flag_unfused = not all(bool(torch.equal(a, b)) for a, b in zip(flag_k, k2))
        dense_equal = all(bool(torch.equal(a.view(torch.int32), b.view(torch.int32))) for a, b in zip(dense_k, k2))
        del flag_k, flag_p, dense_k, plain

        # each kernel from prepared arguments, the plain versions and K2 beside them
        out_table = torch.empty_like(table)
        scratch = fb.classify_bricks(table, pose, intr, eng, cap)
        b_scratch = fb.classify_scratch(dev, classes.rank.numel())
        b_tiles = fb.classify_tiles(classes.rank.numel())
        lv, consts = fb._layout_ints(layout), fb.classify_consts(intr, eng)
        active_flags = (classes.cls.reshape(-1) == fb.ACTIVE).to(torch.int32)

        def run(kernel, *args):
            err_code = getattr(ext, kernel)(*args, stream)
            check(err_code == 0, f"{kernel} launch failed: cudaError {err_code}")

        def run_b():  # each launch with its own epoch, as the wrapper gives them
            run("classify_bricks", table, pose, scratch.cls, b_scratch.words, *b_scratch.next_launch(),
                scratch.rank, scratch.active_ids, scratch.work_ids, scratch.totals, scratch.overflow, H, W, lv,
                consts, cap)
            b_scratch.launched(b_tiles)

        ms_a = time_ms(lambda: run("depth_mips", depth_m, out_table, lv), 100)
        ms_b = time_ms(run_b, 100)
        # as the frame finds them: the depth image, the table and the lists out of L2
        cold_a = time_cold_ms(lambda: run("depth_mips", depth_m, out_table, lv), 50)
        cold_b = time_cold_ms(run_b, 50)
        ms_c = time_ms(lambda: run("fuse_bricks", *brick, depth_m, pose, classes.cls, classes.rank, classes.work_ids,
                                   classes.totals, classes.overflow, *fargs, cap, True, res, False, 0.0, 0), 20)
        ms_rows = time_ms(lambda: run("fuse_bricks", *rows_b, depth_m, pose, classes.cls, classes.rank,
                                      classes.work_ids, classes.totals, classes.overflow, *fargs, cap, True, res, True,
                                      0.0, 0), 20)
        ms_k2 = time_ms(lambda: kernels.fuse_volume(*k2, depth_m, r, t, intr, eng.voxel_size, eng.trunc_dist,
                                                    eng.max_weight), 20)
        # as the frame finds them: the planes out of L2 (B3c's work bricks, ~19 MB at the orbit, fit in it)
        cold_c = time_cold_ms(lambda: run("fuse_bricks", *brick, depth_m, pose, classes.cls, classes.rank,
                                          classes.work_ids, classes.totals, classes.overflow, *fargs, cap, True, res,
                                          False, 0.0, 0), 20)
        cold_rows = time_cold_ms(lambda: run("fuse_bricks", *rows_b, depth_m, pose, classes.cls, classes.rank,
                                             classes.work_ids, classes.totals, classes.overflow, *fargs, cap, True, res,
                                             True, 0.0, 0), 20)
        cold_k2 = time_cold_ms(lambda: kernels.fuse_volume(*k2, depth_m, r, t, intr, eng.voxel_size, eng.trunc_dist,
                                                           eng.max_weight), 20)
        # a yardstick for B3a, not a library call for it: one of its 22 levels and one of its three statistics
        lib_a = time_ms(lambda: torch.amax(depth_m[:H - H % 8, :W - W % 8].reshape(H // 8, 8, W // 8, 8), dim=(1, 3)),
                        100)
        # a yardstick for B3b: the prefix of its ACTIVE flags, one of its two lists' ranks, without the classes
        lib_b = time_ms(lambda: torch.cumsum(active_flags, 0, dtype=torch.int32), 100)
        check(bool(torch.equal(torch.cumsum(active_flags, 0, dtype=torch.int32)[active_flags.bool()] - 1,
                               classes.rank.reshape(-1)[active_flags.bool()])),
              f"B3b's ranks differ from torch.cumsum over its ACTIVE flags at {name}")
        plain_a = time_ms(lambda: fb.depth_mips_plain(depth_m), 3)
        plain_b = time_ms(lambda: fb.rank_bricks_plain(fb.classify_bricks_plain(table, pose, intr, eng), cap), 3)
        plain_c = time_ms(lambda: fb.fuse_bricks_plain(*brick, depth_m, pose, intr, eng, classes, cap, True), 2)
        # bounds: B3a the image once and the table; 22 x 3 operations a pixel. B3b the table once, the pose,
        # a class and a rank out a brick, the listed ids, the counts and the flag; ~600 operations a brick
        # (eight corners' projections and planes, the intervals, the level scan). B3c the depth image and 24 B
        # a voxel it updates; 69 operations a voxel of the work list to its gate, 60 more an exact update
        n_bricks = classes.rank.numel()
        b_a = bound_ms(depth_m.numel() * 4 + table.numel() * 4, depth_m.numel() * 3 * len(layout.sizes))
        b_b = bound_ms(table.numel() * 4 + pose.numel() * 4 + n_bricks * 8 + (n_active + n_work) * 4 + 9,
                       n_bricks * 600)
        b_c = bound_ms(depth_m.numel() * 4 + updated * 24, n_work * 512 * 69 + n_active * 512 * 60)
        emit("B3 brick fusion", case=name, classes=dict(zip(("none", "far", "active", "far_partial"), counts)),
             n_active=n_active, n_work=n_work, cap=cap, table_rows=layout.rows, table_equal=table_equal,
             classes_and_lists_equal=classes_equal, back_to_back_equal=second_equal,
             back_to_back_classes_differ=second_differs, equal_to_k2=eq_k2, bit_equal_to_k2=bits_k2,
             sign_of_zero_differences=zero_sign, equal_to_plain=eq_plain, voxels_updated=updated,
             rows_bit_equal_to_k2=bits_rows,
             cap64=dict(n_active=int(small.totals[0]), overflow=bool(small.overflow), flag_equal_to_plain=flag_equal,
                        flag_leaves_bricks_unfused=flag_unfused, dense_bit_equal_to_k2=dense_equal),
             ms=dict(depth_mips=ms_a, classify_bricks=ms_b, fuse_bricks=ms_c, sum=ms_a + ms_b + ms_c,
                     fuse_volume=ms_k2, fuse_bricks_rows=ms_rows),
             cold_ms=dict(depth_mips=cold_a, classify_bricks=cold_b, fuse_bricks=cold_c, fuse_volume=cold_k2,
                          fuse_bricks_rows=cold_rows),
             plain_ms=dict(depth_mips=plain_a, classify_bricks=plain_b, fuse_bricks=plain_c),
             bound_ms=dict(depth_mips=b_a, classify_bricks=b_b, fuse_bricks=b_c),
             library_ms=dict(depth_mips=lib_a, classify_bricks=lib_b, fuse_bricks=None),
             library_note="yardsticks, no single PyTorch call computes any of the three: depth_mips torch.amax "
                          "over the 8 px tiles (one of 22 levels, the max alone); classify_bricks torch.cumsum "
                          "over the cls == ACTIVE flags (one of its two lists' ranks, without the classes)")
        check(table_equal, f"B3a's table differs from its plain version at {name}")
        check(classes_equal, f"B3b's classes or lists differ from its plain version at {name}")
        check(second_equal and second_differs,
              f"B3b's second launch, back to back on the next pose's table, at {name}: equal to plain "
              f"{second_equal}, other classes than the first {second_differs}")
        check(all(eq_k2) and all(bits_k2), f"B3c's volume is not K2's bit for bit at {name}: == {eq_k2}, bits {bits_k2}")
        check(all(eq_plain), f"B3c's volume differs from its plain version at {name}: {eq_plain}")
        check(all(bits_rows), f"B3c's row variant is not K2's volume bit for bit at {name}: {bits_rows}")
        check(bool(small.overflow) and flag_equal and flag_unfused and dense_equal,
              f"cap 64 at {name}: overflow {bool(small.overflow)}, flag == plain {flag_equal}, flag leaves bricks "
              f"unfused {flag_unfused}, dense == K2 {dense_equal}")
        check(not bool(classes.overflow) and updated > 100_000,
              f"{name}: overflow, or too few updates ({n_active} ACTIVE bricks, {updated} voxels)")
        if not rows:
            rows = {
                "depth_mips": dict(max_abs_err=0.0, ms=ms_a, cold_ms=cold_a, plain_ms=plain_a, bound_ms=b_a[0],
                                   bound_by=b_a[1], library_ms=lib_a),
                "classify_bricks": dict(max_abs_err=0.0, ms=ms_b, cold_ms=cold_b, plain_ms=plain_b, bound_ms=b_b[0],
                                        bound_by=b_b[1], library_ms=lib_b),
                "fuse_bricks": dict(max_abs_err=0.0, ms=ms_c, cold_ms=cold_c, rows_ms=ms_rows, rows_cold_ms=cold_rows,
                                    plain_ms=plain_c, bound_ms=b_c[0], bound_by=b_c[1]),
            }
        del k2, brick, rows_b
    return rows


def _bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool(torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))


# the operations B11 adds to an updated voxel, counted from csrc/fusion.cuh::bilinear_depth and sample_at<true>:
# the spread 7, the tests 5, the dual weights 6, the complements 4, the four weight products 16, the four corner
# products 16, the three sums 6, the SDF's depth-derivative term 2
BILINEAR_OPS = 62


def phase_bilinear(ctx):
    """B11, the bilinear branch of fusion (``bi_threshold`` 0.1), in K2 and in
    B3c (dense planes and brick rows) against the plain versions, bit for bit
    on value, grad and weight, on the volume of three fused frames at the
    orbit's frame 3 (its rendered depth) and at the volume-corner pose (a
    seeded depth with 10% holes, so that blocks with a zero corner fall back
    to the nearest depth); B3c's classes taken with a cap of every brick.
    The branch must change the derivative lane against the nearest branch's.
    Each timed warm and cold beside the nearest branch on the same frame
    (K2 and B3c with the nearest depth: their rows' ranges must hold). The
    voxels where B3c parts from K2 under bilinear sampling (the classes'
    proofs allow the nearest sample's half pixel) are counted."""
    from xslam_tpu_torch.geometry import se3
    from xslam_tpu_torch.ops import bricks, fusion, kernels
    from xslam_tpu_torch.ops import fusion_brick as fb

    cfg, eng, dev = ctx["config"], ctx["engine_cfg"], ctx["device"]
    intr, vol, thr = cfg.intrinsics, ctx["volume"], BILINEAR_THRESHOLD
    cap = int(np.prod(eng.resolution)) // fb.BRICK ** 3
    rows = {}
    for name, v2c, depth_u16 in ctx["fusion_cases"][:2]:
        r, t = se3.rotation(v2c), se3.translation(v2c)
        depth_m = fusion.scale_depth(torch.as_tensor(depth_u16, device=dev))
        args = (depth_m, r, t, intr, eng.voxel_size, eng.trunc_dist, eng.max_weight)
        pose = kernels.fusion_pose(r, t)
        classes = fb.classify_bricks(fb.depth_mips(depth_m), pose, intr, eng, cap)
        k2, plain, near = ([x.clone() for x in vol] for _ in range(3))
        kernels.fuse_volume(*k2, *args, thr)
        kernels.fuse_volume_plain(*plain, *args, thr)
        kernels.fuse_volume(*near, *args)
        brick, brick_plain = ([x.clone() for x in vol] for _ in range(2))
        fb.fuse_bricks(*brick, depth_m, pose, intr, eng, classes, cap, True, thr)
        fb.fuse_bricks_plain(*brick_plain, depth_m, pose, intr, eng, classes, cap, True, thr)
        rows_b = bricks.from_dense(*vol)
        fb.fuse_bricks(*rows_b, depth_m, pose, intr, eng, classes, cap, True, thr)
        torch.cuda.synchronize()
        k2_bits = [_bits(a, b) for a, b in zip(k2, plain)]
        brick_bits = [_bits(a, b) for a, b in zip(brick, brick_plain)]
        rows_bits = [_bits(a, fb.to_bricks(b)) for a, b in zip(rows_b, brick_plain)]
        updated = int((k2[2] != vol.weight).sum())
        changed = int(((k2[1] != near[1]) & (k2[2] != vol.weight)).sum())
        parted = int(((brick[2] != k2[2]) | (brick[0] != k2[0])).sum())
        n_active, n_work = (int(x) for x in classes.totals)

        def k2_bilinear():
            kernels.fuse_volume(*k2, *args, thr)

        def k2_nearest():
            kernels.fuse_volume(*near, *args)

        def b3c(planes, bilinear):
            return lambda: fb.fuse_bricks(*planes, depth_m, pose, intr, eng, classes, cap, True, thr if bilinear else 0.0)

        ms = dict(k2=time_ms(k2_bilinear, 20), k2_nearest=time_ms(k2_nearest, 20),
                  b3c=time_ms(b3c(brick, True), 20), b3c_nearest=time_ms(b3c(brick, False), 20),
                  b3c_rows=time_ms(b3c(rows_b, True), 20))
        cold = dict(k2=time_cold_ms(k2_bilinear, 20), k2_nearest=time_cold_ms(k2_nearest, 20),
                    b3c=time_cold_ms(b3c(brick, True), 20), b3c_nearest=time_cold_ms(b3c(brick, False), 20),
                    b3c_rows=time_cold_ms(b3c(rows_b, True), 20))
        plain_ms = dict(k2=time_ms(lambda: kernels.fuse_volume_plain(*plain, *args, thr), 2),
                        b3c=time_ms(lambda: fb.fuse_bricks_plain(*brick_plain, depth_m, pose, intr, eng, classes,
                                                                 cap, True, thr), 2))
        # bounds: as K2's and B3c's rows count them, with B11's operations at each updated voxel and its four
        # depth reads there (L2-resident: the image is counted once)
        n_bytes = depth_m.numel() * 4 + 24 * 4 + updated * 24
        b_k2 = bound_ms(n_bytes, vol.value.numel() * 69 + updated * (60 + BILINEAR_OPS))
        b_b3c = bound_ms(n_bytes, n_work * 512 * 69 + n_active * 512 * (60 + BILINEAR_OPS))
        emit("B11 bilinear fusion", case=name, threshold=thr, voxels_updated=updated,
             voxels_whose_grad_the_branch_changed=changed, k2_bit_equal_to_plain=k2_bits,
             b3c_bit_equal_to_plain=brick_bits, b3c_rows_bit_equal_to_plain=rows_bits,
             voxels_where_b3c_parts_from_k2=parted, n_active=n_active, n_work=n_work, ms=ms, cold_ms=cold,
             plain_ms=plain_ms, bound_ms=dict(k2=b_k2[0], b3c=b_b3c[0]), bound_by=dict(k2=b_k2[1], b3c=b_b3c[1]),
             library_ms=None, library_note="no single PyTorch call computes it")
        check(all(k2_bits) and all(brick_bits) and all(rows_bits),
              f"B11 at {name}: K2 {k2_bits}, B3c {brick_bits}, B3c rows {rows_bits} bit-equal to plain")
        # the orbit's rendered depth is smooth, so the interpolant is taken; the corner's seeded depth jumps
        # by metres between neighbours, so its blocks fall back to the nearest depth
        check(updated > 100_000 and (changed > 1000 or name != "orbit frame 3"),
              f"B11 at {name}: {updated} voxels updated, {changed} with a grad the bilinear branch changed")
        if not rows:
            rows = {
                "fuse_volume_bilinear": dict(max_abs_err=0.0, ms=ms["k2"], cold_ms=cold["k2"], plain_ms=plain_ms["k2"],
                                             bound_ms=b_k2[0], bound_by=b_k2[1], nearest_ms=ms["k2_nearest"],
                                             nearest_cold_ms=cold["k2_nearest"]),
                "fuse_bricks_bilinear": dict(max_abs_err=0.0, ms=ms["b3c"], cold_ms=cold["b3c"],
                                             rows_ms=ms["b3c_rows"], rows_cold_ms=cold["b3c_rows"],
                                             plain_ms=plain_ms["b3c"], bound_ms=b_b3c[0], bound_by=b_b3c[1],
                                             nearest_ms=ms["b3c_nearest"], nearest_cold_ms=cold["b3c_nearest"]),
            }
        del k2, plain, near, brick, brick_plain, rows_b
    return rows


# the operations B15 adds to B3b's ~600 a box: the split classifier's per-cell tests (the rect and its clips 13, two
# lambda intervals 24, the far and none tests 8, a cell; four cells) and its word; the fine classifier's 8 boxes a
# brick; the subcell classifier's 8 boxes a candidate; the MIXED variant's window test at a gated voxel (two rounds,
# the cells and the bit)
CLASSIFY_BOX_OPS = 600
SPLIT_CELL_OPS = 45
MIXED_VOXEL_OPS = 12
STARVED_SUBCELL_CAP = 4


def _step_depth(column: int, H: int, W: int) -> np.ndarray:
    """A near strip (1.0 m) left of ``column``, far (4.2 m) right of it: a
    depth step that a window's cell edge can meet, as the JAX package's
    MIXED test draws it."""
    depth = np.full((H, W), 4200, np.uint16)
    depth[:, :column] = 1000
    return depth


def phase_b15(ctx):
    """B15 on the card: the split classifier (B15s), the fine classifier
    (B15f), the subcell classifier and lists (B15c) and B3c's MIXED and
    subcell variants against their plain versions, on the volume of three
    fused frames at K2's three poses and on a 640x480 frame with a depth step
    seen from the volume's centre along +z, its column the one (of every
    eighth) where the plain split classifier makes the most MIXED bricks
    (MIXED must fire there). Each classifier's classes, ranks, lists, counts
    and flags (and B15s's windows) equal the plain version's on every brick,
    subcell and list entry; the subcell stage runs on the first cap
    candidates of the coarse classes (cap 2816 where the frame's ACTIVE
    bricks fit it, else every brick) with a list capacity of the cap. B3c's
    variants (split: MIXED; subcell; split and subcell; fine: B3c itself)
    equal the plain version on the dense planes and K2's volume bit for bit
    on the dense planes and the rows; at the orbit frame also with the
    bilinear branch (threshold 0.1) against the plain version. A starved
    subcell capacity of 4 at the orbit frame: "flag" equals the plain
    version and leaves voxels unfused, "dense" equals K2. Each kernel is
    timed warm and cold beside B3b and B3c on the same frame, from prepared
    arguments; bounds by operations for the classifiers, by bytes for the
    brick pass."""
    from xslam_tpu_torch.csfd.single import CSFD
    from xslam_tpu_torch.geometry import se3
    from xslam_tpu_torch.ops import bricks, fusion, kernels
    from xslam_tpu_torch.ops import fusion_brick as fb

    cfg, eng, dev = ctx["config"], ctx["engine_cfg"], ctx["device"]
    intr, vol = cfg.intrinsics, ctx["volume"]
    H, W = intr.height, intr.width
    rng = np.random.default_rng(20)
    n_bricks = int(np.prod(eng.resolution)) // fb.BRICK ** 3
    # the step frame: the camera at the volume's centre looking along +z, the column picked by the plain classifier
    c2v = np.asarray(cfg.world2volume, np.float32)
    step_v2c = se3.inverse(_seeded_c2v(ctx, c2v, rng))
    step_pose = kernels.fusion_pose(se3.rotation(step_v2c), se3.translation(step_v2c))
    mixed_at = {}
    for column in range(8, W - 7, 8):
        table = fb.depth_mips_plain(fusion.scale_depth(torch.as_tensor(_step_depth(column, H, W), device=dev)))
        mixed_at[column] = int((fb.classify_bricks_full_plain(table, step_pose, intr, eng, split=True).cls
                                == fb.MIXED).sum())
    column = max(mixed_at, key=lambda c: (mixed_at[c], -c))
    check(mixed_at[column] > 0, f"MIXED fires at no column of the step frame: {mixed_at}")
    cases = list(ctx["fusion_cases"]) + [("depth step", step_v2c, _step_depth(column, H, W))]

    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    layout = fb.mip_layout(H, W)
    lv, consts, sub_consts = fb._layout_ints(layout), fb.classify_consts(intr, eng), fb.subcell_consts(eng)
    fargs = kernels.fusion_args(intr, eng.voxel_size, eng.trunc_dist, eng.max_weight)
    res = list(eng.resolution)
    rows_out = {}

    def run(kernel, *args):
        err_code = getattr(ext, kernel)(*args, stream)
        check(err_code == 0, f"{kernel} launch failed: cudaError {err_code}")

    def copy(classes):
        return classes._replace(overflow=classes.overflow.clone())

    for name, v2c, depth_u16 in cases:
        r, t = se3.rotation(v2c), se3.translation(v2c)
        depth_m = fusion.scale_depth(torch.as_tensor(depth_u16, device=dev))
        pose = kernels.fusion_pose(r, t)
        table = fb.depth_mips(depth_m)
        coarse = fb.classify_bricks(table, pose, intr, eng, n_bricks)
        n_active = int(coarse.totals[0])
        cap = BRICK_CAP if n_active <= BRICK_CAP else n_bricks
        # B15s, B15f against their plain versions (the classes, ranks, lists, counts, flag and windows)
        split = fb.classify_bricks(table, pose, intr, eng, cap, split=True)
        full = fb.classify_bricks_full_plain(table, pose, intr, eng, split=True)
        split_plain = fb.rank_bricks_plain(full.cls, cap)._replace(aux=fb.pack_aux(full).reshape(-1, fb.AUX_INTS))
        fine = fb.classify_bricks(table, pose, intr, eng, cap, fine=True)
        fine_plain = fb.rank_bricks_plain(fb.classify_bricks_fine_plain(table, pose, intr, eng), cap)
        split_equal, fine_equal = _bricks_equal(split, split_plain), _bricks_equal(fine, fine_plain)
        # B15c on the coarse classes at cap, lists of the cap; also on the split and the fine classes
        coarse = fb.classify_bricks(table, pose, intr, eng, cap)
        subcell_equal = []
        for classes in (coarse, split, fine):
            k_classes, p_classes = copy(classes), copy(classes)
            sub = fb.classify_subcells(table, pose, intr, eng, k_classes, cap, cap)
            sub_plain = fb.classify_subcells_plain(table, pose, intr, eng, p_classes, cap, cap)
            subcell_equal.append(all(bool(torch.equal(a, b)) for a, b in zip(sub, sub_plain))
                                 and bool(k_classes.overflow) == bool(p_classes.overflow))
        sub = fb.classify_subcells(table, pose, intr, eng, copy(coarse), cap, cap)
        split_sub = fb.classify_subcells(table, pose, intr, eng, copy(split), cap, cap)
        fine_sub = fb.classify_subcells(table, pose, intr, eng, copy(fine), cap, cap)

        # B3c's variants: (classes, subcells) on the dense planes against plain and K2, and on the rows against K2
        k2 = [x.clone() for x in vol]
        kernels.fuse_volume(*k2, depth_m, r, t, intr, eng.voxel_size, eng.trunc_dist, eng.max_weight)
        k2_rows = bricks.from_dense(*k2)
        variants = {"split": (split, None), "subcell": (coarse, sub), "split_subcell": (split, split_sub),
                    "fine": (fine, None), "fine_subcell": (fine, fine_sub)}
        equal = {}
        for key, (classes, subcells) in variants.items():
            kern, plain = [x.clone() for x in vol], [x.clone() for x in vol]
            fb.fuse_bricks(*kern, depth_m, pose, intr, eng, classes, cap, True, 0.0, subcells, cap)
            fb.fuse_bricks_plain(*plain, depth_m, pose, intr, eng, classes, cap, True, 0.0, subcells, cap)
            rows_b = bricks.from_dense(*vol)
            fb.fuse_bricks(*rows_b, depth_m, pose, intr, eng, classes, cap, True, 0.0, subcells, cap)
            torch.cuda.synchronize()
            equal[key] = dict(plain=all(_bits(a, b) for a, b in zip(kern, plain)),
                              k2=all(_bits(a, b) for a, b in zip(kern, k2)),
                              rows_k2=all(_bits(a, b) for a, b in zip(rows_b, k2_rows)))
            del kern, plain, rows_b
        # the bilinear branch at the orbit frame: against the plain version
        bilinear_equal = None
        if name == "orbit frame 3":
            bilinear_equal = {}
            for key in ("split", "subcell"):
                classes, subcells = variants[key]
                kern, plain = [x.clone() for x in vol], [x.clone() for x in vol]
                fb.fuse_bricks(*kern, depth_m, pose, intr, eng, classes, cap, True, BILINEAR_THRESHOLD, subcells, cap)
                fb.fuse_bricks_plain(*plain, depth_m, pose, intr, eng, classes, cap, True, BILINEAR_THRESHOLD, subcells,
                                     cap)
                rows_b, rows_p = bricks.from_dense(*vol), bricks.from_dense(*vol)
                fb.fuse_bricks(*rows_b, depth_m, pose, intr, eng, classes, cap, True, BILINEAR_THRESHOLD, subcells,
                               cap)
                fb.fuse_bricks_plain(*rows_p, depth_m, pose, intr, eng, classes, cap, True, BILINEAR_THRESHOLD,
                                     subcells, cap)
                torch.cuda.synchronize()
                bilinear_equal[key] = all(_bits(a, b) for a, b in zip(kern, plain)) and all(
                    _bits(a, b) for a, b in zip(rows_b, rows_p))
                del kern, plain, rows_b, rows_p
        # a starved subcell capacity at the orbit frame: "flag" as the plain version, leaving voxels unfused;
        # "dense" K2's volume
        starved = None
        if name == "orbit frame 3":
            k_classes, p_classes, d_classes = copy(coarse), copy(coarse), copy(coarse)
            k_sub = fb.classify_subcells(table, pose, intr, eng, k_classes, cap, STARVED_SUBCELL_CAP)
            p_sub = fb.classify_subcells_plain(table, pose, intr, eng, p_classes, cap, STARVED_SUBCELL_CAP)
            d_sub = fb.classify_subcells(table, pose, intr, eng, d_classes, cap, STARVED_SUBCELL_CAP)
            flag_k, flag_p, dense_k = ([x.clone() for x in vol] for _ in range(3))
            fb.fuse_bricks(*flag_k, depth_m, pose, intr, eng, k_classes, cap, False, 0.0, k_sub, STARVED_SUBCELL_CAP)
            fb.fuse_bricks_plain(*flag_p, depth_m, pose, intr, eng, p_classes, cap, False, 0.0, p_sub,
                                 STARVED_SUBCELL_CAP)
            fb.fuse_bricks(*dense_k, depth_m, pose, intr, eng, d_classes, cap, True, 0.0, d_sub, STARVED_SUBCELL_CAP)
            torch.cuda.synchronize()
            starved = dict(overflow=bool(k_classes.overflow), lists_overflow=bool(k_sub.overflow),
                           lists_equal=all(bool(torch.equal(a, b)) for a, b in zip(k_sub, p_sub)),
                           flag_equal_to_plain=all(_bits(a, b) for a, b in zip(flag_k, flag_p)),
                           voxels_left_unfused=int(((k2[2] != vol.weight) & (flag_k[2] == vol.weight)).sum()),
                           dense_bit_equal_to_k2=all(_bits(a, b) for a, b in zip(dense_k, k2)))
            del flag_k, flag_p, dense_k

        # the kernels timed from prepared arguments, B3b and B3c beside them, at the orbit frame (the main path's
        # shapes)
        ms = cold = plain_ms = None
        if name == "orbit frame 3":
            n = n_bricks
            scratch = fb.classify_scratch(dev, n)
            out = fb.classify_bricks(table, pose, intr, eng, cap, split=True)

            def classify(kernel, *extra, tail=(), fine=False):
                tiles = fb.classify_tiles(n, fine)

                def go():
                    run(kernel, table, pose, out.cls, scratch.words, *scratch.next_launch(), out.rank,
                        out.active_ids, out.work_ids, out.totals, out.overflow, *extra, H, W, lv, consts, *tail, cap)
                    scratch.launched(tiles)
                return go

            sub_out = fb.classify_subcells(table, pose, intr, eng, copy(coarse), cap, cap)
            sub_scratch = fb.subcell_scratch(table.device, cap)
            sub_flag = coarse.overflow.clone()

            def subcells():
                run("classify_subcells", table, pose, coarse.active_ids, coarse.totals, sub_flag, sub_scratch.words,
                    *sub_scratch.next_launch(), sub_out.cls, sub_out.rank, sub_out.counts, sub_out.overflow,
                    *(s // fb.BRICK for s in res), H, W, lv, consts, sub_consts, cap, cap, 0)
                sub_scratch.launched(fb.subcell_blocks(cap))

            planes = [x.clone() for x in vol]

            def fuse(kernel, classes, *extra):
                return lambda: run(kernel, *planes, depth_m, pose, classes.cls, classes.rank, classes.work_ids,
                                   classes.totals, classes.overflow, *extra, *fargs, cap, True, res, False, 0.0, 0)

            timed = {
                "classify_bricks": classify("classify_bricks"),
                "classify_bricks_split": classify("classify_bricks_split", out.aux),
                "classify_bricks_fine": classify("classify_bricks_fine", tail=(sub_consts[1],), fine=True),
                "classify_subcells": subcells,
                "fuse_bricks": fuse("fuse_bricks", coarse),
                "fuse_bricks_mixed": fuse("fuse_bricks_mixed", split, split.aux),
                "fuse_bricks_subcell": fuse("fuse_bricks_subcell", coarse,
                                            torch.empty(0, dtype=torch.int32, device=dev), sub.cls, sub.rank, cap),
            }
            ms = {k: time_ms(fn, 50 if k.startswith("classify") else 20) for k, fn in timed.items()}
            cold = {k: time_cold_ms(fn, 20) for k, fn in timed.items()}
            plain_ms = {
                "classify_bricks_split": time_ms(
                    lambda: fb.classify_bricks_full_plain(table, pose, intr, eng, split=True), 2),
                "classify_bricks_fine": time_ms(lambda: fb.classify_bricks_fine_plain(table, pose, intr, eng), 2),
                "classify_subcells": time_ms(
                    lambda: fb.classify_subcells_plain(table, pose, intr, eng, copy(coarse), cap, cap), 2),
                "fuse_bricks_mixed": time_ms(
                    lambda: fb.fuse_bricks_plain(*planes, depth_m, pose, intr, eng, split, cap, True), 2),
                "fuse_bricks_subcell": time_ms(
                    lambda: fb.fuse_bricks_plain(*planes, depth_m, pose, intr, eng, coarse, cap, True, 0.0, sub, cap),
                    2),
            }
            del planes
        # bounds: the classifiers by operations (B3b's ~600 a box; B15s four cells' tests more a brick; B15f 8
        # boxes a brick; B15c 8 boxes a candidate row), their bytes the table, the pose, the classes, ranks and
        # lists out (B15s its windows, B15c the (rows, 8) classes and ranks); the brick pass by bytes, the depth
        # image and 24 B a voxel it updates, 69 operations a work brick's voxel to its gate, 60 more an exact
        # update (B15s's MIXED voxels its window test instead; B15c's the listed subcells' 64 voxels)
        n = n_bricks
        table_b = table.numel() * 4 + pose.numel() * 4
        n_split = [int(x) for x in split.totals]
        n_fine = [int(x) for x in fine.totals]
        n_rows = min(n_active, cap)
        updated = int((k2[2] != vol.weight).sum())
        n_mixed = int((split.cls == fb.MIXED).sum())
        listed = int(sub.counts.sum())
        bounds = {
            "classify_bricks_split": bound_ms(table_b + n * 12 + sum(n_split) * 4 + 9,
                                              n * (CLASSIFY_BOX_OPS + 4 * SPLIT_CELL_OPS)),
            "classify_bricks_fine": bound_ms(table_b + n * 8 + sum(n_fine) * 4 + 9, n * 8 * CLASSIFY_BOX_OPS),
            "classify_subcells": bound_ms(table_b + n_rows * 4 + cap * 64 + 41, n_rows * 8 * CLASSIFY_BOX_OPS),
            "fuse_bricks_mixed": bound_ms(depth_m.numel() * 4 + updated * 24,
                                          n_split[1] * 512 * 69 + n_split[0] * 512 * 60 + n_mixed * 512 * MIXED_VOXEL_OPS),
            "fuse_bricks_subcell": bound_ms(depth_m.numel() * 4 + updated * 24,
                                            int(coarse.totals[1]) * 512 * 69 + listed * 64 * 60),
        }
        counts = torch.bincount(split.cls.reshape(-1), minlength=5).tolist()
        emit("B15 classifiers and subcell fusion", case=name, step_column=column if name == "depth step" else None,
             classes_split=dict(zip(("none", "far", "active", "far_partial", "mixed"), counts)),
             n_active=dict(coarse=n_active, split=n_split[0], fine=n_fine[0]), cap=cap,
             subcells_listed=listed, subcell_counts=sub.counts.tolist(), split_equal_to_plain=split_equal,
             fine_equal_to_plain=fine_equal, subcells_equal_to_plain=subcell_equal, fuse_variants=equal,
             bilinear_equal_to_plain=bilinear_equal, starved_subcell_cap=starved, voxels_updated=updated, ms=ms,
             cold_ms=cold, plain_ms=plain_ms, bound_ms={k: b[0] for k, b in bounds.items()},
             bound_by={k: b[1] for k, b in bounds.items()}, library_ms=None,
             library_note="no single PyTorch call computes any of them")
        check(split_equal and fine_equal and all(subcell_equal),
              f"B15 classifiers at {name}: split {split_equal}, fine {fine_equal}, subcells {subcell_equal}")
        check(all(all(v.values()) for v in equal.values()), f"B3c's B15 variants at {name}: {equal}")
        check(bilinear_equal is None or all(bilinear_equal.values()), f"B15 bilinear at {name}: {bilinear_equal}")
        check(starved is None or (starved["overflow"] and starved["lists_overflow"] and starved["lists_equal"]
                                  and starved["flag_equal_to_plain"] and starved["voxels_left_unfused"] > 0
                                  and starved["dense_bit_equal_to_k2"]), f"starved subcell cap at {name}: {starved}")
        check(name != "depth step" or n_mixed > 0, f"MIXED does not fire at the depth step's column {column}")
        # the split classifier only adds proofs to B3b's; the fine one may list more (a brick whose subcells mix
        # NONE with far ones stays ACTIVE, where B3b may prove it FAR_PARTIAL: the depth step)
        check(n_split[0] <= n_active, f"{name}: ACTIVE bricks coarse {n_active}, split {n_split[0]}")
        if ms is not None:
            for k in plain_ms:
                rows_out[k] = dict(max_abs_err=0.0, ms=ms[k], cold_ms=cold[k], plain_ms=plain_ms[k],
                                   bound_ms=bounds[k][0], bound_by=bounds[k][1], classify_bricks_ms=ms["classify_bricks"],
                                   classify_bricks_cold_ms=cold["classify_bricks"], fuse_bricks_ms=ms["fuse_bricks"],
                                   fuse_bricks_cold_ms=cold["fuse_bricks"])
            rows_out["classify_bricks_fine"].update(lanes=fb.FINE_LANES, threads=fb.FINE_THREADS,
                                                    blocks=fb.classify_tiles(n, True))
        del k2, k2_rows
    return rows_out


def phase_dense_marches(ctx):
    """The dense layout's B14 kernels against their plain versions on the
    256^3 volume of three fused frames along the 480x640 camera rays at the
    orbit's frame 3 (seeded derivative lane): B14a's distance equal to
    ``brick_distance_field`` on every brick; B14b at stride 1 (``skip``) and
    2 (``hier_skip``'s coarse pass) equal to ``march_skip_plain`` over
    ``skip_volume``'s packing on every ray, both events, and with the plain
    fixed march's accepted rays and ``t_found`` on them; B14c at stride 2
    (``hier2``'s middle repair, window 12, anchored at K3's stride-4 hits) and
    1 (its last repair, the configuration's ``raycast_hier_window``, anchored
    at that), both events bit for bit, its bound by the distinct voxels
    ``_window_repair``'s samples read (its share of that bound printed).
    Each timed warm and cold. Then the
    skip march's two forms (a warp a ray, a thread a ray; B14b and B5b) on
    both layouts at 4,800, 19,200, 76,800 and 307,200 rays (the dense planes
    along the 480x640 rays at strides 8, 4, 2, 1; the brick rows along the
    240x320 model maps' at strides 4, 2, 1 and the 480x640 at 1): each form
    bit-equal to the other and to ``march_skip_plain``, timed warm in turns
    (warp, thread, thread, warp) and cold; B5b's ray form at the brick skip
    march's 240x320 is the ``march_skip_rays`` row."""
    from xslam_tpu_torch.csfd.single import CSFD
    from xslam_tpu_torch.ops import bricks, kernels, raycast
    from xslam_tpu_torch.ops import raycast_bricks as rb
    from xslam_tpu_torch.ops.kernels import INF_T

    cfg, eng, dev = ctx["config"], ctx["engine_cfg"], ctx["device"]
    vol, intr, res = ctx["volume"], cfg.intrinsics, tuple(eng.resolution)
    pose, parts = _ray_pose(ctx, 1)
    ray_dir, ray_start = kernels.camera_rays(parts[0], parts[1], intr)
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    nb = bricks.brick_grid(res)
    n = nb[0] * nb[1] * nb[2]
    f32, step = kernels.f32, eng.trunc_dist * 0.8
    cam = kernels.camera_args(intr)
    lanes = csrc_constant("skip.cu", "LANES")

    # B14a
    dist = raycast.skip_field_dense(vol, res)
    dist_plain = raycast.brick_distance_field(vol.value, vol.weight).reshape(-1)
    torch.cuda.synchronize()
    dist_equal = bool(torch.equal(dist, dist_plain))
    mask, dk = torch.empty(n, dtype=torch.uint8, device=dev), torch.empty_like(dist)

    def run_field():
        check(ext.skip_field_dense(vol.value, vol.weight, mask, dk, *nb, stream) == 0, "skip_field_dense failed")

    f_ms, f_cold = time_ms(run_field, 50), time_cold_ms(run_field, 30)
    f_plain = time_ms(lambda: raycast.brick_distance_field(vol.value, vol.weight), 3)
    f_bound = bound_ms(2 * vol.value.numel() * 4 + n * 4,
                       vol.value.numel() * 3 + n * 3 * (2 * bricks.DIST_CAP + 1))
    emit("B14a skip_field_dense", bricks=n, distance_equal_on_every_brick=dist_equal,
         distance_histogram=torch.bincount(dist_plain, minlength=bricks.DIST_CAP + 1).tolist(), ms=f_ms,
         cold_ms=f_cold, plain_ms=f_plain, bound_ms=f_bound[0], bound_by=f_bound[1], library_ms=None,
         library_note="no single PyTorch call computes it")
    check(dist_equal, "B14a's distances differ from brick_distance_field")

    # B14b at strides 1 and 2
    packed_read = raycast._dense_reader(raycast.pack_dense(vol.value, dist_plain))
    skip_rows = {}
    for s in (1, 2):
        hit = raycast.march_skip_dense(vol, dist, pose, intr, eng, stride=s)
        dirs = ray_dir.v[:, ::s, ::s]
        stats = {"lanes": lanes}
        plain = raycast.march_skip_plain(ray_start, dirs, eng, packed_read, res, stats=stats)
        ff, fd = kernels.march_fixed_plain(vol.value, ray_start, CSFD(dirs, dirs), eng.voxel_size,
                                           eng.trunc_dist)
        torch.cuda.synchronize()
        eq = _lanes_equal(f"B14b (stride {s})", {"t_found": (hit.t_found, plain.t_found),
                                                 "t_dead": (hit.t_dead, plain.t_dead)})
        acc_k = hit.t_found < torch.clamp(hit.t_dead, max=INF_T)
        acc_f = ff < torch.clamp(fd, max=INF_T)
        accept_equal = bool(torch.equal(acc_k, acc_f))
        found_equal = accept_equal and bool(torch.equal(hit.t_found[acc_k], ff[acc_f]))
        Hs, Ws = hit.t_found.shape
        tf, td = torch.empty_like(hit.t_found), torch.empty_like(hit.t_dead)
        margs = (*nb, s, kernels.march_steps(eng.trunc_dist), f32(eng.voxel_size),
                 kernels.reciprocal_f32(eng.voxel_size), f32(step), f32(bricks.BRICK * eng.voxel_size / step), *cam,
                 int(raycast.skip_ray_form(Hs, Ws)))

        def run_march(margs=margs, tf=tf, td=td):
            check(ext.march_skip_dense(vol.value, dist, pose, tf, td, *margs, stream) == 0, "march_skip_dense failed")

        m_ms, m_cold = time_ms(run_march, 50), time_cold_ms(run_march, 30)
        m_plain = time_ms(lambda: raycast.march_skip_plain(ray_start, dirs, eng, packed_read, res), 3)
        m_bound = bound_ms(Hs * Ws * 8 + 192, Hs * Ws * 60 + stats["samples"] * 25)
        emit("B14b march_skip_dense", stride=s, shape=[Hs, Ws], **eq,
             form="a thread a ray" if raycast.skip_ray_form(Hs, Ws) else f"a warp a ray ({lanes} lanes)",
             accepted_rays_equal_to_fixed_march=accept_equal, t_found_equal_to_fixed_march_on_accepted_rays=found_equal,
             hit_fraction=float(acc_k.float().mean()), samples=stats["samples"],
             longest_ray_rounds=int(stats["ray_rounds"].max()), mean_ray_samples=float(stats["ray_samples"].double().mean()),
             ms=m_ms, cold_ms=m_cold, plain_ms=m_plain, bound_ms=m_bound[0], bound_by=m_bound[1], library_ms=None,
             library_note="no single PyTorch call computes it")
        check(accept_equal and found_equal, f"B14b (stride {s}) against the plain fixed march: accepted rays "
                                            f"{accept_equal}, t_found on them {found_equal}")
        skip_rows[s] = dict(max_abs_err=eq["max_abs_err"], ms=m_ms, cold_ms=m_cold, plain_ms=m_plain,
                            bound_ms=m_bound[0], bound_by=m_bound[1], ray_form=raycast.skip_ray_form(Hs, Ws))

    # the skip march's two forms on both layouts, in turns; the brick rows take the same distances (brick order)
    rows = _bench_inputs(ctx)[0]  # the same fused volume's brick rows
    rows_read = rb._value_reader(bricks.pack_rows(rows.value, dist_plain), res)
    lvl1 = intr.level(1)
    spc = f32(bricks.BRICK * eng.voxel_size / step)
    forms = {}
    for layout, cintr, s in (("dense", intr, 8), ("dense", intr, 4), ("dense", intr, 2), ("dense", intr, 1),
                             ("rows", lvl1, 4), ("rows", lvl1, 2), ("rows", lvl1, 1), ("rows", intr, 1)):
        plane, dense = (vol.value, 1) if layout == "dense" else (rows.value, 0)
        Hs, Ws = kernels.strided(cintr.height, s), kernels.strided(cintr.width, s)
        outs = [(torch.empty((Hs, Ws), dtype=torch.float32, device=dev),
                 torch.empty((Hs, Ws), dtype=torch.float32, device=dev)) for _ in range(2)]
        fargs = (*nb, s, kernels.march_steps(eng.trunc_dist), f32(eng.voxel_size),
                 kernels.reciprocal_f32(eng.voxel_size), f32(step), spc, *kernels.camera_args(cintr))
        march = ext.march_skip_dense if dense else ext.march_skip

        def run_form(form, plane=plane, outs=outs, fargs=fargs, march=march):
            check(march(plane, dist, pose, *outs[form], *fargs, form, stream) == 0,
                  f"the skip march (form {form}) failed")

        run_form(0), run_form(1)
        cdir, cstart = kernels.camera_rays(parts[0], parts[1], cintr)
        cdirs = cdir.v[:, ::s, ::s]
        stats = {"lanes": lanes}
        plain = raycast.march_skip_plain(cstart, cdirs, eng, packed_read if dense else rows_read, res, stats=stats)
        torch.cuda.synchronize()
        forms_equal = all(_bits(a, b) for a, b in zip(outs[0], outs[1]))
        plain_equal = all(_bits(a, b) for a, b in zip(outs[1], (plain.t_found, plain.t_dead)))
        turns = [time_ms(lambda: run_form(f), 50) for f in (0, 1, 1, 0)]
        cold = [time_cold_ms(lambda: run_form(f), 30) for f in (0, 1)]
        picked = raycast.skip_ray_form(Hs, Ws)
        emit("skip march forms", layout=layout, rays=Hs * Ws, shape=[Hs, Ws], stride=s,
             forms_bit_equal=forms_equal, bit_equal_to_plain=plain_equal, lanes_ms=[turns[0], turns[3]],
             rays_ms=[turns[1], turns[2]], lanes_cold_ms=cold[0], rays_cold_ms=cold[1],
             picked="a thread a ray" if picked else "a warp a ray", samples=stats["samples"],
             mean_ray_samples=float(stats["ray_samples"].double().mean()),
             longest_ray_samples=int(stats["ray_samples"].max()))
        check(forms_equal and plain_equal, f"skip march forms ({layout}, {Hs}x{Ws}): the forms equal "
                                           f"{forms_equal}, the ray form equal to plain {plain_equal}")
        forms[(layout, Hs * Ws, cintr.width)] = dict(lanes_ms=[turns[0], turns[3]], rays_ms=[turns[1], turns[2]],
                                                     lanes_cold_ms=cold[0], rays_cold_ms=cold[1], stats=stats,
                                                     plain=(cstart, cdirs))
    # the brick skip march's 240x320 in the ray form: the march_skip_rays row
    brick_skip = forms[("rows", lvl1.height * lvl1.width, lvl1.width)]
    cstart, cdirs = brick_skip["plain"]
    r_plain = time_ms(lambda: raycast.march_skip_plain(cstart, cdirs, eng, rows_read, res), 3)
    n_rays = lvl1.height * lvl1.width
    r_bound = bound_ms(n_rays * 8 + 192, n_rays * 60 + brick_skip["stats"]["samples"] * 25)
    rays_row = dict(max_abs_err=0.0, ms=min(brick_skip["rays_ms"]), cold_ms=brick_skip["rays_cold_ms"],
                    plain_ms=r_plain, bound_ms=r_bound[0], bound_by=r_bound[1], shape=[lvl1.height, lvl1.width],
                    lanes_ms=min(brick_skip["lanes_ms"]), lanes_cold_ms=brick_skip["lanes_cold_ms"])
    for sd, key in ((1, ("dense", intr.height * intr.width, intr.width)),
                    (2, ("dense", intr.height * intr.width // 4, intr.width))):
        skip_rows[sd].update(lanes_ms=min(forms[key]["lanes_ms"]), lanes_cold_ms=forms[key]["lanes_cold_ms"])
    del rows_read

    # B14c: hier2's middle repair (stride 2, window 12) on K3's stride-4 hits, then its last (stride 1)
    coarse = raycast.RaycastHit(*kernels.march_fixed(vol.value, pose, intr, eng.voxel_size, eng.trunc_dist, stride=4))
    window_rows = {}
    for s, window in ((2, raycast.HIER2_MID_WINDOW), (1, cfg.raycast_hier_window)):
        hit = raycast.window_march_dense(vol, pose, intr, eng, coarse, window, stride=s)
        stats = {}
        plain = raycast._window_repair(ray_start, ray_dir.v[:, ::s, ::s], coarse, window, eng,
                                       raycast._dense_reader(vol.value), res, stats=stats)
        torch.cuda.synchronize()
        eq = _lanes_equal(f"B14c (stride {s})", {"t_found": (hit.t_found, plain.t_found),
                                                 "t_dead": (hit.t_dead, plain.t_dead)})
        Hs, Ws = hit.t_found.shape
        ch, cw = coarse.t_found.shape
        tf, td = torch.empty_like(hit.t_found), torch.empty_like(hit.t_dead)
        wargs = (*nb, Hs, Ws, ch, cw, s, window, f32(eng.voxel_size), kernels.reciprocal_f32(eng.voxel_size), f32(step),
                 kernels.reciprocal_f32(step), *cam)

        def run_window(c=coarse, wargs=wargs, tf=tf, td=td):
            check(ext.window_march_dense(vol.value, vol.grad, pose, c.t_found, c.t_dead, None, None, tf, td, *wargs,
                                         stream) == 0, "window_march_dense failed")

        w_ms, w_cold = time_ms(run_window, 50), time_cold_ms(run_window, 30)
        w_plain = time_ms(lambda: raycast._window_repair(ray_start, ray_dir.v[:, ::s, ::s], coarse, window, eng,
                                                         raycast._dense_reader(vol.value), res), 3)
        # bytes: the coarse hits in, both times out, the pose, the distinct voxels the samples read (4 B each);
        # operations: ~60 to make a ray, ~20 a sample
        w_bound = bound_ms(ch * cw * 8 + Hs * Ws * 8 + 192 + stats["voxels"] * 4,
                           Hs * Ws * 60 + stats["samples"] * 20)
        emit("B14c window_march_dense", stride=s, window=window, shape=[Hs, Ws], coarse_shape=[ch, cw], **eq,
             hit_fraction=float((hit.t_found < torch.clamp(hit.t_dead, max=INF_T)).float().mean()),
             samples=stats["samples"], voxels=stats["voxels"], ms=w_ms, cold_ms=w_cold, plain_ms=w_plain,
             bound_ms=w_bound[0], bound_by=w_bound[1], share_of_bound=w_bound[0] / w_ms, library_ms=None,
             library_note="no single PyTorch call computes it")
        window_rows[s] = dict(max_abs_err=eq["max_abs_err"], ms=w_ms, cold_ms=w_cold, plain_ms=w_plain,
                              bound_ms=w_bound[0], bound_by=w_bound[1], window=window, voxels=stats["voxels"])
        coarse = hit
    return {
        "skip_field_dense": dict(max_abs_err=0.0, ms=f_ms, cold_ms=f_cold, plain_ms=f_plain, bound_ms=f_bound[0],
                                 bound_by=f_bound[1]),
        "march_skip_dense": dict(skip_rows[1], stride=1, stride_2=skip_rows[2]),
        "march_skip_rays": rays_row,
        "window_march_dense": dict(window_rows[1], stride=1, stride_2=window_rows[2]),
    }


def _march_bytes_ops(vol_value, start, dirs, t_found, t_dead, eng, rows=None, core=None):
    """What this run's march must read: the distinct voxels its rays sample
    up to the step where both events are known, plus rays in and times out;
    with ``rows`` (a slab's [first, stop) x rows) only the voxels it holds;
    with ``core`` (its [core_start, core_end) x rows) only the samples a
    slab's events need: those inside the volume in the core rows, and the
    one before each (its sign)."""
    from xslam_tpu_torch.ops.kernels import INF_T, RAY_MIN_M, march_steps

    X, Y, Z = vol_value.shape
    step = np.float32(eng.trunc_dist * 0.8)
    n = march_steps(eng.trunc_dist)

    def k_of(t):
        return torch.round((t - RAY_MIN_M) / float(step)).long()

    both = (t_found < INF_T) & (t_dead < INF_T)
    k_stop = torch.where(both, torch.maximum(k_of(t_found), k_of(t_dead)), n - 1).reshape(-1)
    d = dirs.reshape(3, -1)
    ks = torch.arange(-1, n, device=d.device, dtype=torch.float32)
    t = RAY_MIN_M + (ks + 1)[:, None] * float(step)  # sample times, the first at 0.2 m
    p = start[:, None, None] + d[:, None, :] * t[None]
    g = torch.floor(p / eng.voxel_size).long()
    g[:, 0] = torch.stack([g[0, 0].clamp(0, X - 1), g[1, 0].clamp(0, Y - 1), g[2, 0].clamp(0, Z - 1)])
    live = (ks[:, None] <= k_stop[None].float())
    inside = (g[0] >= 0) & (g[0] < X) & (g[1] >= 0) & (g[1] < Y) & (g[2] >= 0) & (g[2] < Z)
    if core is not None:
        owned = inside & (g[0] >= core[0]) & (g[0] < core[1])
        live = live & (owned | torch.cat([owned[1:], torch.zeros_like(owned[:1])]))
    if rows is not None:
        inside = inside & (g[0] >= rows[0]) & (g[0] < rows[1])
    idx = (g[0] * Y + g[1]) * Z + g[2]
    distinct = int(torch.unique(idx[live & inside]).numel())
    samples = int(live.sum())
    rays = d.shape[1]
    # the pose in, two times out a ray; some 60 operations to make a ray, 20 a sample
    return distinct * 4 + rays * 8 + 96, rays * 60 + samples * 20, samples


def _ray_pose(ctx, seed: int, c2v_np=None):
    """The packed pose of K3 and K5 at the orbit's frame 3, or at the
    camera->volume pose ``c2v_np``, with a seeded derivative lane, and its
    parts."""
    from xslam_tpu_torch.csfd.single import lift
    from xslam_tpu_torch.geometry import se3
    from xslam_tpu_torch.ops import kernels

    rng = np.random.default_rng(seed)
    if c2v_np is None:
        _, c2v = _v2c(ctx, np.linalg.inv(ctx["gt"][0]) @ ctx["gt"][3], rng)
    else:
        c2v = _seeded_c2v(ctx, c2v_np, rng)
    w2v = lift(torch.as_tensor(np.asarray(ctx["config"].world2volume, np.float32), device=ctx["device"]))
    v2w = se3.inverse(w2v)
    parts = (se3.rotation(c2v), se3.translation(c2v), se3.rotation(v2w), se3.translation(v2w))
    return kernels.pack_ray_pose(*parts), parts


def phase_march(ctx):
    from xslam_tpu_torch.csfd.single import CSFD
    from xslam_tpu_torch.ops import kernels
    from xslam_tpu_torch.ops.kernels import INF_T

    cfg, eng = ctx["config"], ctx["engine_cfg"]
    vol, intr = ctx["volume"], cfg.intrinsics
    pose, parts = _ray_pose(ctx, 1)
    ray_dir, ray_start = kernels.camera_rays(parts[0], parts[1], intr)
    tf, td = kernels.march_fixed(vol.value, pose, intr, eng.voxel_size, eng.trunc_dist)
    pf, pd = kernels.march_fixed_plain(vol.value, ray_start, ray_dir, eng.voxel_size, eng.trunc_dist)
    torch.cuda.synchronize()
    eq_f, eq_d = frac_equal(tf, pf), frac_equal(td, pd)
    both = (tf < INF_T) & (pf < INF_T)
    err = max_abs(tf, pf, both)
    hits = float((tf < torch.clamp(td, max=INF_T)).float().mean())
    ms = time_ms(lambda: kernels.march_fixed(vol.value, pose, intr, eng.voxel_size, eng.trunc_dist), 50)
    plain = time_ms(
        lambda: kernels.march_fixed_plain(vol.value, ray_start, ray_dir, eng.voxel_size, eng.trunc_dist), 3)
    n_bytes, n_ops, samples = _march_bytes_ops(vol.value, ray_start.v, ray_dir.v, tf, td, eng)
    bms, by = bound_ms(n_bytes, n_ops)

    # the earlier design (direction planes from memory, one load in flight) on the same rays: equal bits asked
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(ctx["device"]).cuda_stream
    n_steps, vs, step = kernels.march_steps(eng.trunc_dist), kernels.f32(eng.voxel_size), kernels.f32(eng.trunc_dist * 0.8)
    start, dirs = ray_start.v.contiguous(), ray_dir.v.contiguous()
    cf, cd = torch.empty_like(tf), torch.empty_like(td)

    def chain():
        check(ext.march_fixed_chain(vol.value, start, dirs, cf, cd, n_steps, vs, step, stream) == 0,
              "march_fixed_chain launch failed")

    chain_ms = time_ms(chain, 50)
    chain_equal = bool(torch.equal(tf, cf)) and bool(torch.equal(td, cd))
    # rays with a NaN or an infinity never enter the new kernel's loop: the same outputs asked
    # as from the earlier design, which marches them (every sample lies outside)
    odd_equal = True
    for at, bad in ((4, float("nan")), (4, float("inf")), (18, float("inf"))):  # rotation, rotation, origin
        odd_pose = pose.clone()
        odd_pose[at] = bad  # every ray is hit
        odd_dir, odd_start = kernels.camera_rays(*kernels.unpack_ray_pose(odd_pose)[:2], intr)
        of, od = kernels.march_fixed(vol.value, odd_pose, intr, eng.voxel_size, eng.trunc_dist)
        check(ext.march_fixed_chain(vol.value, odd_start.v.contiguous(), odd_dir.v.contiguous(), cf, cd, n_steps, vs,
                                    step, stream) == 0, "march_fixed_chain launch failed")
        odd_equal = odd_equal and bool(torch.equal(of, cf)) and bool(torch.equal(od, cd))
    chain()  # cf, cd back to the real rays' outputs
    emit("K3 march_fixed", shape=list(tf.shape), nan_and_inf_rays_equal_to_earlier_design=odd_equal,
         t_found_frac_equal=eq_f, t_dead_frac_equal=eq_d,
         max_abs_err_t_found=err, hit_fraction=hits, samples=samples, bytes_needed=n_bytes, ms=ms,
         plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
         library_note="no single PyTorch call computes it",
         earlier_design_ms=chain_ms, bit_equal_to_earlier_design=chain_equal,
         rays_differing_from_earlier_design=int(((tf != cf) | (td != cd)).sum()))
    check(eq_f >= 0.999 and eq_d >= 0.999, f"K3 disagrees with its plain version: {eq_f}, {eq_d}")
    check(hits > 0.5, f"K3 found surfaces on only {hits:.3f} of the rays")
    check(chain_equal and odd_equal,
          f"K3 is not bit-equal to its earlier design: {chain_equal}, NaN and inf rays {odd_equal}")

    # K3 at the hierarchical marches' strides (hier's 2, hier2's 4): the rays of every s-th pixel, so the
    # stride-1 march's events at those pixels and the earlier design's on the strided rays, bit for bit; the
    # wrapper's lanes a ray (march_group_kernel) against one lane a ray (K3's body) through the binding, bit for
    # bit, timed in turns (one lane, the wrapper's, the wrapper's, one lane), warm and cold
    group_threads = csrc_constant("march.cu", "GROUP_THREADS")
    sms = torch.cuda.get_device_properties(ctx["device"]).multi_processor_count
    strided = {}
    for s in (2, 4):
        def run_s(s=s):
            return kernels.march_fixed(vol.value, pose, intr, eng.voxel_size, eng.trunc_dist, stride=s)

        sf, sd = run_s()
        H_s, W_s = sf.shape
        lanes = kernels.march_lanes(H_s, W_s, s)
        one_f, one_d = torch.empty_like(sf), torch.empty_like(sd)

        def run_lanes(g, out=(one_f, one_d), s=s):
            check(ext.march_fixed(vol.value, pose, out[0], out[1], s, n_steps, vs, step, *kernels.camera_args(intr),
                                  [], g, stream) == 0, f"march_fixed at {g} lanes a ray failed to launch")

        run_lanes(1)
        dirs_s = ray_dir.v[:, ::s, ::s].contiguous()
        pf_s, pd_s = kernels.march_fixed_plain(vol.value, ray_start, CSFD(dirs_s, dirs_s), eng.voxel_size,
                                               eng.trunc_dist)
        cf_s, cd_s = torch.empty_like(sf), torch.empty_like(sd)
        check(ext.march_fixed_chain(vol.value, start, dirs_s, cf_s, cd_s, n_steps, vs, step, stream) == 0,
              "march_fixed_chain launch failed")
        torch.cuda.synchronize()
        sub_equal = bool(torch.equal(sf, tf[::s, ::s])) and bool(torch.equal(sd, td[::s, ::s]))
        chain_s = bool(torch.equal(sf, cf_s)) and bool(torch.equal(sd, cd_s))
        one_lane_s = _bits(sf, one_f) and _bits(sd, one_d)
        eq_s = min(frac_equal(sf, pf_s), frac_equal(sd, pd_s))
        err_s = max_abs(sf, pf_s, (sf < INF_T) & (pf_s < INF_T))
        turns = [time_ms(fn, 50) for fn in (lambda: run_lanes(1), run_s, run_s, lambda: run_lanes(1))]
        cold_turns = [time_cold_ms(fn, 30) for fn in (lambda: run_lanes(1), run_s, run_s, lambda: run_lanes(1))]
        ms_s, cold_s = min(turns[1:3]), min(cold_turns[1:3])
        plain_s = time_ms(lambda: kernels.march_fixed_plain(vol.value, ray_start, CSFD(dirs_s, dirs_s),
                                                            eng.voxel_size, eng.trunc_dist), 3)
        nb_s, no_s, samples_s = _march_bytes_ops(vol.value, ray_start.v, dirs_s, sf, sd, eng)
        b_s = bound_ms(nb_s, no_s)
        blocks = {1: -(-W_s // 32) * -(-H_s // 8), lanes: -(-H_s * W_s * lanes // group_threads)}
        threads = {1: 256, lanes: group_threads}
        emit("K3 march_fixed strided", stride=s, shape=list(sf.shape), lanes=lanes,
             bit_equal_to_stride_1_subsampled=sub_equal, bit_equal_to_earlier_design=chain_s,
             bit_equal_to_one_lane=one_lane_s, frac_equal_to_plain=eq_s, max_abs_err_t_found=err_s,
             samples=samples_s, ms=ms_s, cold_ms=cold_s, one_lane_ms=[turns[0], turns[3]],
             lanes_ms=turns[1:3], one_lane_cold_ms=[cold_turns[0], cold_turns[3]], lanes_cold_ms=cold_turns[1:3],
             blocks={g: blocks[g] for g in (1, lanes)},
             warps_per_sm={g: blocks[g] * threads[g] / 32 / sms for g in (1, lanes)},
             plain_ms=plain_s, bound_ms=b_s[0], bound_by=b_s[1],
             library_ms=None, library_note="no single PyTorch call computes it")
        check(sub_equal and chain_s and one_lane_s and eq_s >= 0.999,
              f"K3 at stride {s}: stride 1 subsampled {sub_equal}, earlier design {chain_s}, one lane a ray "
              f"{one_lane_s}, plain {eq_s}")
        strided[s] = dict(max_abs_err=err_s, ms=ms_s, cold_ms=cold_s, plain_ms=plain_s, bound_ms=b_s[0],
                          bound_by=b_s[1], lanes=lanes, one_lane_ms=min(turns[0], turns[3]))
    return {"march_fixed": dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by),
            "march_fixed_strided": dict(strided[2], stride=2, stride_4=strided[4])}


def _refine_bytes_ops(vol, ray_start, ray_dir, t_found, accept, eng):
    """What this run's refine must move and do: the distinct voxels that the
    accepted pixels' eight trilinears tap (both planes, 8 B each), two times
    in and four (3,) float32 vectors out a pixel, the pose; some 8 x 16 x 6
    operations an accepted pixel."""
    from xslam_tpu_torch.ops import raycast

    X, Y, Z = vol.value.shape
    voxel, step = eng.voxel_size, eng.trunc_dist * 0.8
    t = t_found[accept]
    d = ray_dir.v[:, accept]
    s = ray_start.v[:, None]

    def tsdf_at(p):
        from xslam_tpu_torch.csfd.single import lift
        return raycast.trilinear_tsdf_shard(vol.value, vol.grad, lift(p[0]), lift(p[1]), lift(p[2]), voxel).v

    p0, p1 = s + d * t, s + d * (t + step)
    ft, ftdt = tsdf_at(p0), tsdf_at(p1)
    vertex = s + d * (t - step * ft / (ftdt - ft))
    points = [p0, p1]
    for axis in range(3):
        for sign in (1.0, -1.0):
            q = vertex.clone()
            q[axis] += sign * voxel * 0.5
            points.append(q)
    cells = []
    for p in points:
        g = torch.floor(torch.nan_to_num(p) / voxel)
        g = g - (torch.nan_to_num(p) < (g + 0.5) * voxel).float()
        g = g.long()
        ok = ((g >= 0) & (g < torch.tensor([X - 1, Y - 1, Z - 1], device=g.device)[:, None])).all(dim=0)
        g = g[:, ok]
        base = (g[0] * Y + g[1]) * Z + g[2]
        cells.append(torch.cat([base + dx * Y * Z + dy * Z + dz for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]))
    distinct = int(torch.unique(torch.cat(cells)).numel())
    n_pix, n_acc = accept.numel(), int(accept.sum())
    return distinct * 8 + n_pix * (8 + 48) + 192, n_acc * 8 * 16 * 6 + n_pix * 4, distinct


def _planar_volume(ctx, offset: float):
    """A volume whose TSDF is the plane z = (Z / 2 + offset) voxels, linear
    over 0.5 m on either side (so the secant is exact to rounding), with the
    taps' +1e-5 bias taken out of its place: the refined vertices lie within a
    few ulps of a plane of voxel centres (offset 3.5) or of cell edges (3),
    where the rounding of v / voxel and of v +- half a voxel decides the cells
    (not at Z / 2 = 128 voxels: there, at a power of two, the roundings all
    agree and no sample leaves the rule). Its derivative plane is seeded; and
    the camera->volume pose of a camera 2.5 m in front of it, looking along
    +z."""
    from xslam_tpu_torch.ops import fusion

    eng, dev = ctx["engine_cfg"], ctx["device"]
    X, Y, Z = eng.resolution
    vs = eng.voxel_size
    z_plane = (Z // 2 + offset) * vs - 1e-5 * 0.5
    zc = (torch.arange(Z, dtype=torch.float32, device=dev) + 0.5) * vs
    value = ((z_plane - zc) / 0.5).clamp(-1.0, 1.0).expand(X, Y, Z).contiguous()
    gen = torch.Generator(device=dev).manual_seed(5)
    grad = 1e-2 * torch.randn((X, Y, Z), generator=gen, device=dev)
    c2v = np.eye(4)
    c2v[:3, 3] = [X * vs / 2 + 0.013, Y * vs / 2 - 0.021, z_plane - 2.5]
    return fusion.VolumeState(value, grad, torch.ones_like(value)), c2v


def phase_refine(ctx):
    """K5 against ``refine`` + ``finalize_maps``, bit for bit (every lane
    equal, NaN masks equal): on the fused volume at the orbit's frame 3 at the
    image shapes of ``model_map_level`` 0 and 1 (timed; its outputs also feed
    K6's phase), and on two planar volumes whose vertices lie within a few
    ulps of voxel centres and of cell edges; on the second, some 2.7% of the
    normal samples leave the rule of the shared block and read their own taps
    (the count is printed; the orbit has a few in a million)."""
    from xslam_tpu_torch.ops import kernels, raycast
    from xslam_tpu_torch.ops.kernels import INF_T

    cfg, eng, dev = ctx["config"], ctx["engine_cfg"], ctx["device"]
    planes = {name: _planar_volume(ctx, offset) for name, offset in (("plane on voxel centres", 3.5),
                                                                     ("plane on cell edges", 3.0))}
    cases = [("orbit frame 3", 0, ctx["volume"], None), ("orbit frame 3", 1, ctx["volume"], None)]
    cases += [(name, 0, vol, c2v) for name, (vol, c2v) in planes.items()]
    table, ctx["model_maps"] = None, {}
    direct = torch.zeros(1, dtype=torch.int32, device=dev)
    for name, L, vol, c2v in cases:
        pose, parts = _ray_pose(ctx, 3, c2v)
        intr = cfg.intrinsics.level(L)
        t_found, t_dead = kernels.march_fixed(vol.value, pose, intr, eng.voxel_size, eng.trunc_dist)
        ray_dir, ray_start = kernels.camera_rays(parts[0], parts[1], intr)
        accept = t_found < torch.clamp(t_dead, max=INF_T)

        def plain_fn():
            return raycast.finalize_maps(*raycast.refine(vol, ray_start, ray_dir, t_found, accept, parts[2], parts[3], eng))

        direct.zero_()
        out = raycast.raycast_refine(vol, pose, t_found, t_dead, intr, eng, direct=direct)
        ref = plain_fn()
        torch.cuda.synchronize()
        lanes = {"vmap.v": (out[0].v, ref[0].v), "vmap.g": (out[0].g, ref[0].g),
                 "nmap.v": (out[1].v, ref[1].v), "nmap.g": (out[1].g, ref[1].g)}
        eq = {k: frac_equal(a, b) for k, (a, b) in lanes.items()}
        ulp = {k: max_ulp(a, b) for k, (a, b) in lanes.items()}
        nans = all(same_nans(a, b) for a, b in lanes.values())
        err = max(max_abs(a, b) for a, b in lanes.values())
        valid = float((~torch.isnan(out[1].v[0])).float().mean())
        n_direct = int(direct.item())
        row = dict(case=name, model_map_level=L, shape=[intr.height, intr.width], frac_equal=eq, max_ulp=ulp,
                   nan_masks_equal=nans, max_abs_err=err, accepted_fraction=float(accept.float().mean()),
                   normal_valid_fraction=valid, direct_samples=n_direct,
                   direct_fraction_of_normal_samples=n_direct / max(1, 6 * int((~torch.isnan(out[1].v[0])).sum())))
        if name == "orbit frame 3":
            ms = time_ms(lambda: raycast.raycast_refine(vol, pose, t_found, t_dead, intr, eng), 50)
            plain = time_ms(plain_fn, 3)
            n_bytes, n_ops, distinct = _refine_bytes_ops(vol, ray_start, ray_dir, t_found, accept, eng)
            bms, by = bound_ms(n_bytes, n_ops)
            row.update(distinct_voxels=distinct, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
                       library_note="no single PyTorch call computes it")
            ctx["model_maps"][L] = out
            if L == 0:
                table = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)
        emit("K5 raycast_refine", **row)
        check(nans and min(eq.values()) == 1.0 and max(ulp.values()) == 0,
              f"K5 is not bit-equal to its plain version ({name}, L={L}): equal {eq}, ulp {ulp}, NaN masks {nans}")
        check(valid > 0.5, f"K5: normals on only {valid:.3f} of the pixels ({name}, L={L})")
        check(name != "plane on cell edges" or n_direct > 0,
              "K5: no normal sample on the plane of cell edges read its own taps: the exact path went untested")
    return table


def _bench_inputs(ctx):
    """The path-shaped inputs of the brick layout's raycast kernels: the
    brick rows of the fused volume, the packed pose at the orbit's frame 3
    (seeded derivative lane) and its parts, the model maps' intrinsics
    (level 1, 240x320), and frame 3's depth anchors (its level-1 vertex
    distances, no fallback), as the engine makes them."""
    from xslam_tpu_torch.ops import bricks, kernels, raycast_bricks

    if "bench_inputs" not in ctx:
        cfg, dev = ctx["config"], ctx["device"]
        rows = bricks.from_dense(*ctx["volume"])
        pose, parts = _ray_pose(ctx, 7)
        intr = cfg.intrinsics.level(1)
        depths = kernels.depth_pyramid(kernels.bilateral_filter(torch.as_tensor(ctx["depths"][3], device=dev)), 2)
        vmaps, _ = kernels.vertex_normal_pyramid([cfg.intrinsics, intr], depths)
        none = torch.full((intr.height, intr.width), float("inf"), dtype=torch.float32, device=dev)
        ctx["bench_inputs"] = (rows, pose, parts, intr, raycast_bricks.anchor_map(vmaps[1], none))
    return ctx["bench_inputs"]


def _lanes_equal(tag: str, lanes: dict) -> dict:
    eq = {k: frac_equal(a, b) for k, (a, b) in lanes.items()}
    ulp = {k: max_ulp(a, b) for k, (a, b) in lanes.items()}
    nans = all(same_nans(a, b) for a, b in lanes.values())
    err = max(max_abs(a, b) for a, b in lanes.values())
    check(nans and min(eq.values()) == 1.0 and max(ulp.values()) == 0,
          f"{tag} is not bit-equal to its plain version: equal {eq}, ulp {ulp}, NaN masks {nans}")
    return dict(frac_equal=eq, max_ulp=ulp, nan_masks_equal=nans, max_abs_err=err)


def phase_window(ctx):
    """B4 against its plain versions, bit for bit, at the bench
    path's shapes: B4 with the refine, the temporal frame's march (240x320
    rays anchored at frame 3's depth) against ``march_temporal`` and the
    ``reuse`` refine through the pair taps; B4 without it, the refresh's half
    level (120x160 rays anchored at the plain skip march's quarter-level
    hits) against ``_window_repair``. Each timed from prepared arguments,
    warm and cold (L2 flushed before each launch)."""
    from xslam_tpu_torch.ops import bricks, kernels, raycast
    from xslam_tpu_torch.ops import raycast_bricks as rb

    eng, dev = ctx["engine_cfg"], ctx["device"]
    res = eng.resolution
    rows, pose, parts, intr, t_anchor = _bench_inputs(ctx)
    ray_dir, ray_start = kernels.camera_rays(parts[0], parts[1], intr)
    read = rb._value_reader(rows.value, res)
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    nb = bricks.brick_grid(res)
    H, W = intr.height, intr.width
    f32, step = kernels.f32, eng.trunc_dist * 0.8
    consts = (f32(eng.voxel_size), kernels.reciprocal_f32(eng.voxel_size), f32(step), kernels.reciprocal_f32(step),
              *kernels.camera_args(intr))

    # with the refine: the temporal frame
    vmap, t_found = rb.window_march(rows, pose, intr, eng, t_anchor, WINDOW, refine=True)
    stats = {}

    def plain_refine():
        out = raycast.march_temporal(t_anchor, ray_start, ray_dir, eng, WINDOW, read, res, True, stats)
        return rb._reuse_maps(rows, ray_start, ray_dir, out, parts[2], parts[3], eng)

    vp, hp = plain_refine()
    torch.cuda.synchronize()
    refine_eq = _lanes_equal("B4 (with the refine)", {"vmap.v": (vmap.v, vp.v), "vmap.g": (vmap.g, vp.g),
                                                      "t_found": (t_found, hp.t_found)})
    valid = float(torch.isfinite(vmap.v[0]).float().mean())
    accepted = int(torch.isfinite(vmap.v[0]).sum())
    vv, vg, tf = torch.empty_like(vmap.v), torch.empty_like(vmap.g), torch.empty_like(t_found)

    def run_refine():
        check(ext.window_march(rows.value, rows.grad, pose, t_anchor, None, vv, vg, tf, None, *nb, H, W, H // 2,
                               W // 2, 1, WINDOW, *consts, stream) == 0, "window_march launch failed")

    ms = time_ms(run_refine, 50)
    cold = time_cold_ms(run_refine, 30)
    plain = time_ms(plain_refine, 3)
    # bytes: the anchors in, t_found and the dual vertex map out, the pose; operations: ~60 to make a ray, ~20
    # a sample (this run's: a ray stops once both events are known), ~250 a refined pixel (the secant, one dual
    # trilinear, the vertex)
    refine_bound = bound_ms(H * W * (4 + 4 + 24) + 192, H * W * 60 + stats["samples"] * 20 + accepted * 250)
    check(valid > 0.5, f"B4: vertices at only {valid:.3f} of the pixels")

    # without: the refresh's half level, from the plain skip march's hits at a quarter
    dist = bricks.brick_distance_rows(rows, res)
    q = rb.SKIP_STRIDE
    coarse = raycast.march_skip_plain(ray_start, ray_dir.v[:, ::q, ::q], eng,
                                      rb._value_reader(bricks.pack_rows(rows.value, dist), res), res)
    mid = rb.window_march(rows, pose, intr, eng, coarse.t_found, WINDOW, anchor_dead=coarse.t_dead, stride=2)
    mstats = {}
    mp = raycast._window_repair(ray_start, ray_dir.v[:, ::2, ::2], coarse, WINDOW, eng, read, res, stats=mstats)
    torch.cuda.synchronize()
    half_eq = _lanes_equal("B4 (without the refine)", {"t_found": (mid.t_found, mp.t_found),
                                                       "t_dead": (mid.t_dead, mp.t_dead)})
    Hm, Wm = mid.t_found.shape
    ch, cw = coarse.t_found.shape
    mf, md = torch.empty_like(mid.t_found), torch.empty_like(mid.t_dead)

    def run_half():
        check(ext.window_march(rows.value, rows.grad, pose, coarse.t_found, coarse.t_dead, None, None, mf, md, *nb,
                               Hm, Wm, ch, cw, 2, WINDOW, *consts, stream) == 0, "window_march launch failed")

    half_ms = time_ms(run_half, 50)
    half_cold = time_cold_ms(run_half, 30)
    half_bound = bound_ms(ch * cw * 8 + Hm * Wm * 8 + 192, Hm * Wm * 60 + mstats["samples"] * 20)

    ctx["bench_vmap"] = vmap  # B4n's input in the normals phase

    emit("B4 window_march", case="orbit frame 3, depth anchors", shape=[H, W], window=WINDOW, **refine_eq,
         vertex_valid_fraction=valid, samples=stats["samples"], ms=ms, cold_ms=cold, plain_ms=plain,
         bound_ms=refine_bound[0], bound_by=refine_bound[1], library_ms=None,
         library_note="no single PyTorch call computes it",
         half_level=dict(shape=[Hm, Wm], coarse_shape=[ch, cw], samples=mstats["samples"], ms=half_ms,
                         cold_ms=half_cold, bound_ms=half_bound[0], bound_by=half_bound[1], **half_eq))
    return {
        "window_march": dict(max_abs_err=refine_eq["max_abs_err"], ms=ms, cold_ms=cold, plain_ms=plain,
                             bound_ms=refine_bound[0], bound_by=refine_bound[1], half_level_ms=half_ms,
                             half_level_cold_ms=half_cold, half_level_bound_ms=half_bound[0]),
    }


def phase_normals(ctx):
    """B4n in K6's launch (``model_map_pyramid`` with no normals given)
    against its plain chain, ``screen_normals_plain`` then
    ``resize_model_maps`` level after level, bit for bit at every level: on
    B4's 240x320 vertex map of the bench frame with the pyramid's levels and
    with one level (no coarser level, the normals still due), and on a
    239x319 crop of it (an odd last row and column, which no level-1 pixel
    owns). Timed from prepared arguments, warm and cold, beside K6 alone on
    the same map with the plain normals given."""
    from xslam_tpu_torch.csfd.single import CSFD
    from xslam_tpu_torch.models.kinfu import model_map_pyramid, resize_model_maps
    from xslam_tpu_torch.ops import kernels, raycast

    dev, levels = ctx["device"], ctx["config"].num_levels
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    vmap = ctx.pop("bench_vmap")
    crop = CSFD(vmap.v[:, :239, :319].contiguous(), vmap.g[:, :239, :319].contiguous())
    worst = 0.0
    for case, vm, n_levels in (("bench frame", vmap, levels), ("bench frame, one level", vmap, 1),
                               ("crop 239x319", crop, levels)):
        vmaps, nmaps = model_map_pyramid(vm, None, n_levels)
        plain_v, plain_n = [vm], [raycast.screen_normals_plain(vm)]
        for _ in range(1, n_levels):
            v, n = resize_model_maps(plain_v[-1], plain_n[-1])
            plain_v.append(v)
            plain_n.append(n)
        torch.cuda.synchronize()
        check(len(vmaps) == len(nmaps) == n_levels and vmaps[0] is vm, f"B4n in K6 ({case}): {len(vmaps)} levels")
        for level in range(n_levels):
            pairs = [(nmaps[level].v, plain_n[level].v), (nmaps[level].g, plain_n[level].g)]
            if level:
                pairs += [(vmaps[level].v, plain_v[level].v), (vmaps[level].g, plain_v[level].g)]
            nans, eq, ulp, err = _compare("B4n in K6's launch", pairs, case=case, level=level,
                                          shape=list(nmaps[level].v.shape[1:]),
                                          normal_valid_fraction=float(torch.isfinite(nmaps[level].v[0]).float().mean()))
            check(nans and ulp == 0 and eq == 1.0,
                  f"B4n in K6 is not bit-equal to its plain chain ({case}, level {level}): equal {eq}, ulp {ulp}")
            worst = max(worst, err)
    valid = float(torch.isfinite(nmaps[0].v[0]).float().mean())
    check(valid > 0.5, f"B4n: normals at only {valid:.3f} of the pixels")

    # the launch from prepared arguments, warm and cold, beside K6 alone on the plain normals
    H, W = vmap.v.shape[-2:]
    shapes = [(H >> level, W >> level) for level in range(1, levels)]
    offsets, size = kernels.map_pyramid_layout(shapes, 4)
    offsets = [o for level in offsets for o in level]
    out, out6 = (torch.empty(size, dtype=torch.float32, device=dev) for _ in range(2))
    nv, ng = torch.empty_like(vmap.v), torch.empty_like(vmap.g)
    n0 = raycast.screen_normals_plain(vmap)

    def run_fused():
        check(ext.model_map_normals(vmap.v, vmap.g, nv, ng, out, offsets, levels, stream) == 0,
              "model_map_normals launch failed")

    def run_k6():
        check(ext.model_map_pyramid(vmap.v, vmap.g, n0.v, n0.g, out6, offsets, levels, stream) == 0,
              "model_map_pyramid launch failed")

    def plain_chain():
        v, n = vmap, raycast.screen_normals_plain(vmap)
        for _ in range(1, levels):
            v, n = resize_model_maps(v, n)

    ms, k6_ms = time_ms(run_fused, 100), time_ms(run_k6, 100)
    cold, k6_cold = time_cold_ms(run_fused, 30), time_cold_ms(run_k6, 30)
    plain = time_ms(plain_chain, 3)
    out_px = sum(h * w for h, w in shapes)
    # the vertex map in and its normals out (both lanes, 48 B a pixel), the coarser levels' four maps out; ~150
    # operations a normal, ~120 an output pixel
    bms, by = bound_ms(H * W * 48 + out_px * 48, H * W * 150 + out_px * 120)
    emit("B4n in K6's launch", shape=[H, W], levels=levels, ms=ms, cold_ms=cold, plain_ms=plain, bound_ms=bms,
         bound_by=by, library_ms=None, library_note="no single PyTorch call computes it", k6_alone_ms=k6_ms,
         k6_alone_cold_ms=k6_cold, normal_valid_fraction=valid)
    return {"model_map_normals": dict(max_abs_err=worst, ms=ms, cold_ms=cold, plain_ms=plain, bound_ms=bms,
                                      bound_by=by, k6_alone_ms=k6_ms, k6_alone_cold_ms=k6_cold)}


def phase_brick_refine(ctx):
    """K5r (K5 over the brick rows) against its plain version, ``refine``
    through the pair taps then ``finalize_maps``, and against K5 on the dense
    twin of the same rows, bit for bit (every lane, NaN masks equal): on the
    bench orbit's brick volume at frame 3 along the 480x640 and 240x320 rays
    (``model_map_level`` 0 and 1), from the fixed march's hits (K3 on the
    dense twin: the skip march's events). Timed from prepared arguments, warm
    and cold, beside K5 on the same hits; bound as K5's (``_refine_bytes_ops``)."""
    from xslam_tpu_torch.ops import bricks, kernels, raycast
    from xslam_tpu_torch.ops import raycast_bricks as rb
    from xslam_tpu_torch.ops.kernels import INF_T

    cfg, eng, dev = ctx["config"], ctx["engine_cfg"], ctx["device"]
    rows, pose, parts = _bench_inputs(ctx)[:3]
    vol = ctx["volume"]
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    nb = bricks.brick_grid(eng.resolution)
    f32 = kernels.f32
    consts = (f32(eng.voxel_size), kernels.reciprocal_f32(eng.voxel_size), f32(eng.voxel_size * 0.5),
              f32(eng.trunc_dist * 0.8))
    direct = torch.zeros(1, dtype=torch.int32, device=dev)
    table = None
    for L in (1, 0):
        intr = cfg.intrinsics.level(L)
        t_found, t_dead = kernels.march_fixed(vol.value, pose, intr, eng.voxel_size, eng.trunc_dist)
        ray_dir, ray_start = kernels.camera_rays(parts[0], parts[1], intr)
        accept = t_found < torch.clamp(t_dead, max=INF_T)

        def plain_fn():
            return rb._secant_maps(rows, ray_start, ray_dir, raycast.RaycastHit(t_found, t_dead), parts[2], parts[3],
                                   eng)

        direct.zero_()
        out = rb.raycast_refine_bricks(rows, pose, t_found, t_dead, intr, eng, direct=direct)
        ref = plain_fn()
        k5 = raycast.raycast_refine(vol, pose, t_found, t_dead, intr, eng)
        torch.cuda.synchronize()
        lanes = {"vmap.v": (out[0].v, ref[0].v), "vmap.g": (out[0].g, ref[0].g),
                 "nmap.v": (out[1].v, ref[1].v), "nmap.g": (out[1].g, ref[1].g)}
        plain_eq = _lanes_equal("K5r (against its plain version)", lanes)
        dense_eq = _lanes_equal("K5r (against K5 on the dense twin)", {
            "vmap.v": (out[0].v, k5[0].v), "vmap.g": (out[0].g, k5[0].g),
            "nmap.v": (out[1].v, k5[1].v), "nmap.g": (out[1].g, k5[1].g)})
        valid = float((~torch.isnan(out[1].v[0])).float().mean())
        check(valid > 0.5, f"K5r: normals on only {valid:.3f} of the pixels (level {L})")
        H, W = intr.height, intr.width
        o = [torch.empty((3, H, W), dtype=torch.float32, device=dev) for _ in range(4)]
        o5 = [torch.empty((3, H, W), dtype=torch.float32, device=dev) for _ in range(4)]

        def run_k5r():
            check(ext.raycast_refine_bricks(rows.value, rows.grad, pose, t_found, t_dead, *o, None, *nb, *consts,
                                            *kernels.camera_args(intr), stream) == 0,
                  "raycast_refine_bricks launch failed")

        def run_k5():
            check(ext.raycast_refine(vol.value, vol.grad, pose, t_found, t_dead, *o5, None, *consts,
                                     *kernels.camera_args(intr), stream) == 0, "raycast_refine launch failed")

        ms, k5_ms = time_ms(run_k5r, 50), time_ms(run_k5, 50)
        cold, k5_cold = time_cold_ms(run_k5r, 30), time_cold_ms(run_k5, 30)
        plain = time_ms(plain_fn, 3)
        n_bytes, n_ops, distinct = _refine_bytes_ops(vol, ray_start, ray_dir, t_found, accept, eng)
        bms, by = bound_ms(n_bytes, n_ops)
        emit("K5r raycast_refine_bricks", case="bench orbit frame 3, fixed-march hits", model_map_level=L,
             shape=[H, W], plain=plain_eq, k5_on_dense_twin=dense_eq, accepted_fraction=float(accept.float().mean()),
             normal_valid_fraction=valid, direct_samples=int(direct.item()), distinct_voxels=distinct, ms=ms,
             cold_ms=cold, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
             library_note="no single PyTorch call computes it", k5_ms=k5_ms, k5_cold_ms=k5_cold)
        row = dict(max_abs_err=plain_eq["max_abs_err"], ms=ms, cold_ms=cold, plain_ms=plain, bound_ms=bms,
                   bound_by=by, k5_ms=k5_ms, k5_cold_ms=k5_cold)
        if L == 1:
            table = row  # the shape of the brick layout's model maps (bench.py: model_map_level 1)
        else:
            table["level_0"] = row
    return {"raycast_refine_bricks": table}


def phase_first_event(ctx):
    """B16 (the first-event window march) against ``march_temporal_compact``,
    bit for bit, at the bench path's shapes (240x320 rays anchored at frame
    3's depth): without the refine (both events of every ray) and with the
    ``reuse`` refine (the vertex map's lanes, which the crossing's two samples
    f0 and f1 make, and ``t_found``); every ray records at most one event.
    Timed from prepared arguments, warm and cold, beside B4 on the same
    anchors."""
    from xslam_tpu_torch.ops import bricks, kernels, raycast
    from xslam_tpu_torch.ops import raycast_bricks as rb
    from xslam_tpu_torch.ops.kernels import INF_T

    eng, dev = ctx["engine_cfg"], ctx["device"]
    res = eng.resolution
    rows, pose, parts, intr, t_anchor = _bench_inputs(ctx)
    ray_dir, ray_start = kernels.camera_rays(parts[0], parts[1], intr)
    read = rb._value_reader(rows.value, res)
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    nb = bricks.brick_grid(res)
    H, W = intr.height, intr.width
    f32, step = kernels.f32, eng.trunc_dist * 0.8
    consts = (f32(eng.voxel_size), kernels.reciprocal_f32(eng.voxel_size), f32(step), kernels.reciprocal_f32(step),
              *kernels.camera_args(intr))

    hit = rb.window_march(rows, pose, intr, eng, t_anchor, WINDOW, first_event=True)
    stats = {}
    plain_hit = raycast.march_temporal_compact(t_anchor, ray_start, ray_dir, eng, WINDOW, read_fn=read, shape=res,
                                               stats=stats)
    vmap, t_found = rb.window_march(rows, pose, intr, eng, t_anchor, WINDOW, refine=True, first_event=True)

    def plain_refine():
        out = raycast.march_temporal_compact(t_anchor, ray_start, ray_dir, eng, WINDOW, read_fn=read, shape=res,
                                             return_samples=True)
        return rb._reuse_maps(rows, ray_start, ray_dir, out, parts[2], parts[3], eng)

    vp, hp = plain_refine()
    # the crossing's two samples, which the kernel keeps in registers and feeds to the refine (so they reach its
    # vertex map): the plain version's, on the crossing rays
    _, f0, f1 = raycast.march_temporal_compact(t_anchor, ray_start, ray_dir, eng, WINDOW, read_fn=read, shape=res,
                                               return_samples=True)
    crossed = plain_hit.t_found < INF_T
    f0_f1 = dict(crossings=int(crossed.sum()), f0_positive=bool((f0[crossed] > 0).all()),
                 f1_negative=bool((f1[crossed] < 0).all()), refined_from_them=int(torch.isfinite(vp.v[0]).sum()))
    torch.cuda.synchronize()
    march_eq = _lanes_equal("B16 (without the refine)", {"t_found": (hit.t_found, plain_hit.t_found),
                                                         "t_dead": (hit.t_dead, plain_hit.t_dead)})
    refine_eq = _lanes_equal("B16 (with the refine)", {"vmap.v": (vmap.v, vp.v), "vmap.g": (vmap.g, vp.g),
                                                       "t_found": (t_found, hp.t_found)})
    found, dead = hit.t_found < INF_T, hit.t_dead < INF_T
    check(not bool((found & dead).any()), "B16 recorded two events on a ray")
    check(f0_f1["f0_positive"] and f0_f1["f1_negative"], f"B16's plain version: crossing samples {f0_f1}")
    valid = float(torch.isfinite(vmap.v[0]).float().mean())
    check(valid > 0.5, f"B16: vertices at only {valid:.3f} of the pixels")
    tf, td = torch.empty_like(hit.t_found), torch.empty_like(hit.t_dead)
    vv, vg, tr = torch.empty_like(vmap.v), torch.empty_like(vmap.g), torch.empty_like(t_found)

    def launcher(name, refine):
        fn = getattr(ext, name)
        outs = (vv, vg, tr, None) if refine else (None, None, tf, td)

        def run():
            check(fn(rows.value, rows.grad, pose, t_anchor, None, *outs, *nb, H, W, H // 2, W // 2, 1, WINDOW, *consts,
                     stream) == 0, f"{name} launch failed")
        return run

    timings = {}
    for name in ("window_march_first_event", "window_march"):
        for refine in (False, True):
            run = launcher(name, refine)
            timings[(name, refine)] = (time_ms(run, 50), time_cold_ms(run, 30))
    plain = time_ms(plain_refine, 3)
    accepted = int(torch.isfinite(vmap.v[0]).sum())
    # as B4's: the anchors in, t_found and the dual vertex map out, the pose; ~60 operations to make a ray, ~20 a
    # sample (this run's: a ray stops at its first event), ~250 a refined pixel
    bms, by = bound_ms(H * W * (4 + 4 + 24) + 192, H * W * 60 + stats["samples"] * 20 + accepted * 250)
    ms, cold = timings[("window_march_first_event", True)]
    emit("B16 window_march_first_event", case="orbit frame 3, depth anchors", shape=[H, W], window=WINDOW,
         march=march_eq, refine=refine_eq, rays_found=int(found.sum()), rays_dead=int(dead.sum()),
         rays_without_event=int((~found & ~dead).sum()), f0_f1=f0_f1, samples=stats["samples"],
         vertex_valid_fraction=valid,
         ms=ms, cold_ms=cold, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
         library_note="no single PyTorch call computes it",
         march_alone_ms=timings[("window_march_first_event", False)][0],
         march_alone_cold_ms=timings[("window_march_first_event", False)][1],
         b4_same_anchors=dict(refine_ms=timings[("window_march", True)][0],
                              refine_cold_ms=timings[("window_march", True)][1],
                              march_alone_ms=timings[("window_march", False)][0],
                              march_alone_cold_ms=timings[("window_march", False)][1]))
    return {"window_march_first_event": dict(max_abs_err=max(march_eq["max_abs_err"], refine_eq["max_abs_err"]),
                                             ms=ms, cold_ms=cold, plain_ms=plain, bound_ms=bms, bound_by=by,
                                             march_alone_ms=timings[("window_march_first_event", False)][0],
                                             b4_same_anchors_ms=timings[("window_march", True)][0])}


def phase_skip(ctx):
    """B5a and B5b against their plain versions at the bench path's shapes:
    B5a's distance equal to ``brick_distance_rows`` on every brick; B5b (the
    refresh's 60x80 rays, a quarter of the model maps' in each axis) equal to
    ``march_skip_plain`` over ``pack_rows`` on every ray, both events, and to
    the plain fixed march over the dense twin on the same rays as the
    reference holds them (``tests/test_march_skip.py``): the same accepted
    rays, and the same ``t_found`` on each. The skip march stops at its first
    event, so a ray that crosses keeps no death, and a ray that leaves the
    volume through empty space dies where its jump lands past the face: those
    rays' other event differs from the fixed march's, and is counted. Each timed from prepared arguments, warm and cold."""
    from xslam_tpu_torch.csfd.single import CSFD
    from xslam_tpu_torch.geometry.intrinsics import Intrinsics
    from xslam_tpu_torch.ops import bricks, kernels, raycast
    from xslam_tpu_torch.ops import raycast_bricks as rb
    from xslam_tpu_torch.ops.kernels import INF_T, RAY_MIN_M

    eng, dev = ctx["engine_cfg"], ctx["device"]
    res = eng.resolution
    rows, pose, parts, intr, _ = _bench_inputs(ctx)
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    nb = bricks.brick_grid(res)
    n = nb[0] * nb[1] * nb[2]

    dist = bricks.skip_field(rows, res)
    dist_plain = bricks.brick_distance_rows(rows, res)
    torch.cuda.synchronize()
    dist_equal = bool(torch.equal(dist, dist_plain))
    histogram = torch.bincount(dist_plain, minlength=bricks.DIST_CAP + 1).tolist()
    mask, dk = torch.empty(n, dtype=torch.uint8, device=dev), torch.empty_like(dist)

    def run_field():
        check(ext.skip_field(rows.value, rows.weight, mask, dk, *nb, stream) == 0, "skip_field launch failed")

    f_ms = time_ms(run_field, 50)
    f_cold = time_cold_ms(run_field, 30)
    f_plain = time_ms(lambda: bricks.brick_distance_rows(rows, res), 3)
    # the value and weight rows once, a distance out a brick; ~3 operations a voxel, three separable 1-D min
    # passes of 2 * DIST_CAP + 1 taps a brick
    f_bound = bound_ms(2 * rows.value.numel() * 4 + n * 4,
                       rows.value.numel() * 3 + n * 3 * (2 * bricks.DIST_CAP + 1))

    q = rb.SKIP_STRIDE
    lanes = csrc_constant("skip.cu", "LANES")
    packed_read = rb._value_reader(bricks.pack_rows(rows.value, dist_plain), res)

    def plain_skip(case_intr, stats=None):
        ray_dir, ray_start = kernels.camera_rays(parts[0], parts[1], case_intr)
        dirs = CSFD(ray_dir.v[:, ::q, ::q], ray_dir.g[:, ::q, ::q])
        return raycast.march_skip_plain(ray_start, dirs.v, eng, packed_read, res, stats=stats), ray_start, dirs

    hit = rb.march_skip(rows, dist, pose, intr, eng)
    stats = {"lanes": lanes}
    plain, ray_start, dirs = plain_skip(intr, stats)
    ff, fd = kernels.march_fixed_plain(ctx["volume"].value, ray_start, dirs, eng.voxel_size, eng.trunc_dist)
    # one odd, few-ray shape: 7 x 9 rays, a 25 x 33 window about the image's centre (fewer rays than a block)
    few = Intrinsics(intr.fx, intr.fy, 16.0, 12.0, 33, 25)
    few_hit, (few_plain, _, _) = rb.march_skip(rows, dist, pose, few, eng), plain_skip(few)
    torch.cuda.synchronize()
    skip_eq = _lanes_equal("B5b", {"t_found": (hit.t_found, plain.t_found), "t_dead": (hit.t_dead, plain.t_dead)})
    few_eq = _lanes_equal("B5b (7x9 rays)", {"t_found": (few_hit.t_found, few_plain.t_found),
                                             "t_dead": (few_hit.t_dead, few_plain.t_dead)})
    check(tuple(few_hit.t_found.shape) == (7, 9), f"B5b's few rays: {tuple(few_hit.t_found.shape)}")
    ray_samples, ray_rounds = stats["ray_samples"], stats["ray_rounds"]
    found_equal_fixed = bool(torch.equal(hit.t_found, ff))
    accept_k = hit.t_found < torch.clamp(hit.t_dead, max=INF_T)
    accept_f = ff < torch.clamp(fd, max=INF_T)
    accept_equal_fixed = bool(torch.equal(accept_k, accept_f))
    found_equal_accepted = bool(torch.equal(hit.t_found[accept_k], ff[accept_f])) and accept_equal_fixed
    # where an event differs from the fixed march's: the skip march stopped at its crossing (no death kept), or
    # at its death (the fixed march's later crossing is not accepted), or found no surface and its death is an
    # exit past the volume's face, later than the fixed march's
    step = kernels.f32(eng.trunc_dist * 0.8)
    k_dead = torch.round((hit.t_dead - RAY_MIN_M) / step)
    at = ray_start.v[:, None, None] + dirs.v * (RAY_MIN_M + (k_dead + 1.0) * step)
    g = torch.floor(at / eng.voxel_size)
    lim = torch.tensor(res, dtype=torch.float32, device=dev)[:, None, None]
    exits = ((g < 0) | (g >= lim)).any(dim=0)
    differ = (hit.t_dead != fd) | (hit.t_found != ff)
    stopped_at_crossing = (hit.t_found < INF_T) & (hit.t_dead >= INF_T) & (hit.t_found == ff)
    stopped_at_death = (hit.t_dead < INF_T) & (hit.t_dead == fd) & (hit.t_found >= INF_T) & (ff > fd)
    late_exit = (hit.t_found >= INF_T) & (ff >= INF_T) & exits & (hit.t_dead > fd)
    differs_as_explained = bool((~differ | stopped_at_crossing | stopped_at_death | late_exit).all())
    Hq, Wq = hit.t_found.shape
    tf, td = torch.empty_like(hit.t_found), torch.empty_like(hit.t_dead)
    f32 = kernels.f32
    margs = (*nb, q, kernels.march_steps(eng.trunc_dist), f32(eng.voxel_size), kernels.reciprocal_f32(eng.voxel_size),
             step, f32(bricks.BRICK * eng.voxel_size / (eng.trunc_dist * 0.8)), *kernels.camera_args(intr),
             int(raycast.skip_ray_form(Hq, Wq)))

    def run_march():
        check(ext.march_skip(rows.value, dist, pose, tf, td, *margs, stream) == 0, "march_skip launch failed")

    m_ms = time_ms(run_march, 50)
    m_cold = time_cold_ms(run_march, 30)
    m_plain = time_ms(lambda: raycast.march_skip_plain(ray_start, dirs.v, eng, packed_read, res), 3)
    # two times out a ray, the pose; ~60 operations to make a ray, ~25 a sample (this run's samples)
    m_bound = bound_ms(Hq * Wq * 8 + 192, Hq * Wq * 60 + stats["samples"] * 25)
    emit("B5a skip_field", bricks=n, distance_equal_on_every_brick=dist_equal, distance_histogram=histogram,
         ms=f_ms, cold_ms=f_cold, plain_ms=f_plain, bound_ms=f_bound[0], bound_by=f_bound[1], library_ms=None,
         library_note="no single PyTorch call computes it")
    emit("B5b march_skip", shape=[Hq, Wq], **skip_eq, odd_shape=dict(shape=[7, 9], **few_eq), lanes=lanes,
         longest_ray_samples=int(ray_samples.max()), mean_ray_samples=float(ray_samples.double().mean()),
         longest_ray_rounds=int(ray_rounds.max()), mean_ray_rounds=float(ray_rounds.double().mean()),
         accepted_rays_equal_to_fixed_march=accept_equal_fixed,
         t_found_equal_to_fixed_march_on_accepted_rays=found_equal_accepted,
         t_found_equal_to_fixed_march_everywhere=found_equal_fixed,
         rays_with_an_event_differing_from_fixed_march=int(differ.sum()),
         of_which_stopped_at_crossing=int((differ & stopped_at_crossing).sum()),
         of_which_stopped_at_death=int((differ & stopped_at_death).sum()),
         of_which_exit_past_the_face=int((differ & late_exit).sum()), differences_explained=differs_as_explained,
         hit_fraction=float(accept_k.float().mean()), samples=stats["samples"],
         samples_fixed_march=Hq * Wq * (kernels.march_steps(eng.trunc_dist) + 1), ms=m_ms, cold_ms=m_cold,
         plain_ms=m_plain, bound_ms=m_bound[0], bound_by=m_bound[1], library_ms=None,
         library_note="no single PyTorch call computes it")
    check(dist_equal, "B5a's distances differ from brick_distance_rows")
    check(accept_equal_fixed and found_equal_accepted and differs_as_explained,
          f"B5b against the plain fixed march: accepted rays equal {accept_equal_fixed}, t_found equal on them "
          f"{found_equal_accepted}, other differences explained {differs_as_explained}")
    check(float(accept_k.float().mean()) > 0.5, "B5b: surfaces on fewer than half of the rays")
    return {
        "skip_field": dict(max_abs_err=0.0, ms=f_ms, cold_ms=f_cold, plain_ms=f_plain, bound_ms=f_bound[0],
                           bound_by=f_bound[1]),
        "march_skip": dict(max_abs_err=max(skip_eq["max_abs_err"], few_eq["max_abs_err"]), ms=m_ms, cold_ms=m_cold,
                           plain_ms=m_plain, bound_ms=m_bound[0], bound_by=m_bound[1],
                           longest_ray_rounds=int(ray_rounds.max())),
    }


def _compare(tag, pairs, **fields):
    """Emit and return (all NaN masks equal, worst equal fraction, worst ulp, max abs error)."""
    eq = min(frac_equal(a, b) for a, b in pairs)
    ulp = max(max_ulp(a, b) for a, b in pairs)
    nans = all(same_nans(a, b) for a, b in pairs)
    err = max(max_abs(a, b) for a, b in pairs)
    emit(tag, frac_equal=eq, max_ulp=ulp, nan_masks_equal=nans, max_abs_err=err, **fields)
    return nans, eq, ulp, err


def phase_maps(ctx):
    """K6, K7 and K8 against their plain versions at every level shape of
    both main-path configurations, each held level by level and bit-equal
    (each one launch for the whole pyramid; K6 and K7 also at two shapes
    whose halvings are odd, K6 with one coarser level only). The table rows
    carry the times at the largest shape, of the whole pyramid."""
    import torch.nn.functional as F

    from xslam_tpu_torch.csfd.single import CSFD
    from xslam_tpu_torch.models.kinfu import model_map_pyramid, resize_model_maps
    from xslam_tpu_torch.ops import kernels, preprocess

    cfg, dev = ctx["config"], ctx["device"]
    rows = {}

    # K7 on frame 4's bilateral output (and on two crops whose halvings are odd), both coarser levels in one
    # launch against the plain chain; then K8 on every level of the 480x640 pyramid in one launch
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    frame = kernels.bilateral_filter(torch.as_tensor(ctx["depths"][4], device=dev))
    levels = cfg.num_levels
    for H, W in ((480, 640), (478, 638), (477, 637)):
        src = frame[:H, :W].contiguous()
        pyramid = kernels.depth_pyramid(src, levels)
        plain = [src]
        for _ in range(1, levels):
            plain.append(preprocess.pyr_down(plain[-1]))
        torch.cuda.synchronize()
        equal = [bool(torch.equal(a, b)) for a, b in zip(pyramid[1:], plain[1:])]
        # the kernel timed from prepared arguments (the wrapper beside it)
        outs = [torch.empty((H >> level, W >> level), dtype=torch.float32, device=dev) for level in (1, 2)]

        def launch_k7(src=src, outs=outs):
            err_code = ext.depth_pyramid(src, outs[0], outs[1], levels, stream)
            check(err_code == 0, f"depth_pyramid launch failed: cudaError {err_code}")

        ms = time_ms(launch_k7, 100)
        wrapper_ms = time_ms(lambda src=src: kernels.depth_pyramid(src, levels), 100)
        plain_ms = time_ms(lambda src=src: preprocess.pyr_down(preprocess.pyr_down(src)), 5)
        out_px = sum(p.numel() for p in plain[1:])
        bms, by = bound_ms(H * W * 4 + out_px * 4, out_px * 25 * 5)
        _compare("K7 depth_pyramid, both coarser levels in one launch", list(zip(pyramid[1:], plain[1:])),
                 shape=[H, W], bit_equal=equal, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=bms,
                 bound_by=by, library_ms=None)
        check(all(equal), f"K7 is not bit-equal to its plain chain at {H}x{W}: levels 1, 2 {equal}")
        rows.setdefault("depth_pyramid", dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by))
        if (H, W) == (480, 640):
            depths = pyramid
    intrs = [cfg.intrinsics.level(level) for level in range(cfg.num_levels)]
    vmaps, nmaps = kernels.vertex_normal_pyramid(intrs, depths)
    plain_maps = [preprocess.create_vmap(intr, d) for intr, d in zip(intrs, depths)]
    plain_maps = [(v, preprocess.create_nmap(v)) for v in plain_maps]
    torch.cuda.synchronize()
    # the kernel timed from prepared arguments: on a slow host the wrapper's own work (six views, the checks)
    # outlasted the held stream and its calls were timed at the host's pace; the wrapper is timed beside it
    offsets, size = kernels.map_pyramid_layout([tuple(d.shape) for d in depths])
    prepared = (depths, torch.empty(size, dtype=torch.float32, device=dev), [o for pair in offsets for o in pair],
                [c for intr in intrs for c in kernels.camera_args(intr)])
    ms = time_ms(lambda: kernels.launch("vertex_normal_maps", dev, *prepared), 100)
    wrapper_ms = time_ms(lambda: kernels.vertex_normal_pyramid(intrs, depths), 100)
    plain = time_ms(lambda: [preprocess.create_nmap(preprocess.create_vmap(i, d)) for i, d in zip(intrs, depths)], 5)
    pixels = sum(d.numel() for d in depths)
    bms, by = bound_ms(pixels * (4 + 24), pixels * 60)  # a depth in, two (3,) float32 entries out; ~60 operations
    worst_err = 0.0
    for level, (vmap, nmap, (pv, pn)) in enumerate(zip(vmaps, nmaps, plain_maps)):
        nans, eq, ulp, err = _compare("K8 vertex_normal_maps", [(vmap, pv), (nmap, pn)], level=level,
                                      shape=list(depths[level].shape),
                                      normal_valid_fraction=float((~torch.isnan(nmap[0])).float().mean()))
        check(nans and ulp == 0 and eq == 1.0, f"K8 is not bit-equal to its plain versions at level {level}")
        worst_err = max(worst_err, err)
    emit("K8 vertex_normal_maps, all levels in one launch", levels=len(depths), pixels=pixels, ms=ms,
         wrapper_ms=wrapper_ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None)
    rows["vertex_normal_maps"] = dict(max_abs_err=worst_err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)

    # K6 on the model maps K5 rendered (both configurations), and on two crops of them whose halvings are odd
    # (478 x 638: the paired loads; 477 x 637: the single loads), every coarser level in one launch
    cases = [(f"model_map_level {L}", vmap, nmap) for L, (vmap, nmap) in ctx.pop("model_maps").items()]
    v0, n0 = cases[0][1], cases[0][2]
    for H, W in ((478, 638), (477, 637)):
        def crop(m, H=H, W=W):
            return CSFD(m.v[:, :H, :W].contiguous(), m.g[:, :H, :W].contiguous())
        cases.append((f"crop {H}x{W}", crop(v0), crop(n0)))
    levels = cfg.num_levels
    for name, vmap, nmap in cases:
        H, W = vmap.v.shape[-2:]
        vmaps, nmaps = model_map_pyramid(vmap, nmap, levels)
        plain_v, plain_n = [vmap], [nmap]
        for _ in range(1, levels):
            v, n = resize_model_maps(plain_v[-1], plain_n[-1])
            plain_v.append(v)
            plain_n.append(n)
        one_level = model_map_pyramid(vmap, nmap, 2) if name.startswith("model_map_level 0") else None
        torch.cuda.synchronize()
        # the kernel timed from prepared arguments (K8's lesson: a wrapper's host work can outlast the held
        # stream), the wrapper beside it
        shapes = [(H >> level, W >> level) for level in range(1, levels)]
        offsets, size = kernels.map_pyramid_layout(shapes, 4)
        prepared = (vmap.v, vmap.g, nmap.v, nmap.g, torch.empty(size, dtype=torch.float32, device=dev),
                    [o for level in offsets for o in level], levels, stream)

        def launch(prepared=prepared):
            err_code = ext.model_map_pyramid(*prepared)
            check(err_code == 0, f"model_map_pyramid launch failed: cudaError {err_code}")

        ms = time_ms(launch, 100)
        wrapper_ms = time_ms(lambda: model_map_pyramid(vmap, nmap, levels), 100)
        plain = time_ms(lambda: [resize_model_maps(*pair) for pair in zip(plain_v[:-1], plain_n[:-1])], 5)
        lib = time_ms(lambda: F.avg_pool2d(vmap.v, 2), 100)  # a yardstick: one of the twelve planes' means
        out_px = sum(h * w for h, w in shapes)
        bms, by = bound_ms(12 * H * W * 4 + 12 * out_px * 4, out_px * 120)
        worst = []
        for level in range(1, levels):
            pairs = [(vmaps[level].v, plain_v[level].v), (vmaps[level].g, plain_v[level].g),
                     (nmaps[level].v, plain_n[level].v), (nmaps[level].g, plain_n[level].g)]
            if one_level is not None and level == 1:
                pairs += [(one_level[0][1].v, plain_v[1].v), (one_level[0][1].g, plain_v[1].g),
                          (one_level[1][1].v, plain_n[1].v), (one_level[1][1].g, plain_n[1].g)]
            nans, eq, ulp, err = _compare("K6 resize_model_maps", pairs, case=name, level=level, shape=[H, W],
                                          out_shape=list(shapes[level - 1]))
            check(nans and ulp == 0 and eq == 1.0,
                  f"K6 is not bit-equal to its plain versions ({name}, level {level}): equal {eq}, ulp {ulp}")
            worst.append(err)
        emit("K6 resize_model_maps, all coarser levels in one launch", case=name, shape=[H, W], levels=levels,
             ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
             library_note="torch.nn.functional.avg_pool2d of the vertex map's value lane alone, level 1 only")
        rows.setdefault("resize_model_maps", dict(max_abs_err=max(worst), ms=ms, plain_ms=plain, bound_ms=bms,
                                                  bound_by=by, library_ms=lib))
    return rows


def _icp_inputs(ctx, L: int):
    """Inputs of K4 as the main path gives them at ``model_map_level=L``:
    model maps raycast from the fused volume at frame 3's pose (seeded
    derivative lane) with their pyramid, frame 4's current maps, and the
    ICP's starting pose (the previous frame's)."""
    from xslam_tpu_torch.csfd.single import lift
    from xslam_tpu_torch.geometry import se3
    from xslam_tpu_torch.models.kinfu import model_map_pyramid
    from xslam_tpu_torch.ops import kernels, raycast

    cfg, eng, dev = ctx["config"], ctx["engine_cfg"], ctx["device"]
    intr = cfg.intrinsics
    _, c2v = _v2c(ctx, np.linalg.inv(ctx["gt"][0]) @ ctx["gt"][3], np.random.default_rng(2))
    v2w = se3.inverse(lift(torch.as_tensor(np.asarray(cfg.world2volume, np.float32), device=dev)))
    c2w = se3.matmul(v2w, c2v)
    w2c = se3.inverse(c2w)
    vmap0, nmap0 = raycast.raycast(
        ctx["volume"], se3.rotation(c2v), se3.translation(c2v), se3.rotation(v2w), se3.translation(v2w),
        intr.level(L), eng, normals_mode=cfg.raycast_normals, march_mode=cfg.raycast_march,
        packed_taps=cfg.raycast_packed_taps,
    )
    vprev, nprev = model_map_pyramid(vmap0, nmap0, cfg.num_levels)
    depths = kernels.depth_pyramid(kernels.bilateral_filter(torch.as_tensor(ctx["depths"][4], device=dev)),
                                   cfg.num_levels)
    vcurr, ncurr = kernels.vertex_normal_pyramid([intr.level(i) for i in range(cfg.num_levels)], depths)
    pose = dict(r_curr=se3.rotation(c2w), t_curr=se3.translation(c2w), r_prev_inv=se3.rotation(w2c),
                t_prev=se3.translation(c2w))
    return vprev, nprev, vcurr, ncurr, pose


def _system_err(a, b) -> float:
    """Largest |kernel - plain| over A and b, both lanes, relative to the
    lane's largest entry."""
    worst = 0.0
    for name in ("A", "b"):
        for lane in ("v", "g"):
            x, y = getattr(getattr(a, name), lane), getattr(getattr(b, name), lane)
            worst = max(worst, float((x - y).abs().max() / y.abs().max()))
    return worst


class _K4Launch:
    """``icp_system`` launched from prepared arguments, as the engine's loop
    does it: no packing, no allocation. ``blocks`` overrides the grid."""

    def __init__(self, ctx, lintr, vcurr, ncurr, vprev, nprev, pose, assoc):
        from xslam_tpu_torch.ops import icp, kernels

        cfg, dev = ctx["config"], ctx["device"]
        self.ext = kernels.build_kernels()
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        self.maps = (vcurr, ncurr, icp.pack_model_rows(vprev, nprev), assoc)
        self.pose = icp.pack_pose(pose["r_curr"], pose["t_curr"], pose["r_prev_inv"], pose["t_prev"])
        self.partials = torch.empty((4 * icp.ICP_MAX_BLOCKS, icp.ICP_SUMS), dtype=torch.float64, device=dev)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        self.out = torch.empty(84, dtype=torch.float32, device=dev)
        self.count = torch.empty((), dtype=torch.int32, device=dev)
        self.tail = (torch.empty(icp.POSE_FLOATS, dtype=torch.float32, device=dev),
                     torch.empty(12, dtype=torch.float32, device=dev), torch.zeros(2, dtype=torch.int32, device=dev))
        self.blocks = icp.icp_blocks(vcurr[0].numel())
        self.consts = [int(n) for n in vprev.v.shape[-2:]] + [
            kernels.f32(x) for x in (lintr.fx, lintr.fy, lintr.cx, lintr.cy, cfg.dist_thres, cfg.angle_thres_sine)]

    def __call__(self, tail: bool = False, blocks=None, maps=None, assoc_out=None):
        err_code = self.ext.icp_system(
            *(maps or self.maps), assoc_out, self.pose, self.partials, self.ticket, blocks or self.blocks, self.out,
            self.count, *(self.tail if tail else (None, None, None)), 0.0, True, *self.consts, None, self.stream)
        check(err_code == 0, f"icp_system launch failed: cudaError {err_code}")


def _residual(A: torch.Tensor, x: torch.Tensor, b: torch.Tensor) -> float:
    """Relative residual of a solve, ``|A x - b| / (|A| |x| + |b|)``, in double."""
    A, x, b = A.double(), x.double(), b.double()
    return float(torch.linalg.norm(A @ x - b) / (torch.linalg.norm(A) * torch.linalg.norm(x) + torch.linalg.norm(b)))


def _check_tail(step, ref, tag: str) -> dict:
    """K4's tail against ``icp_step_plain`` fed the kernel's own ``A``, ``b``.

    Tolerances: the kernel's LU and the library's pivot alike but round in
    another order, and the ICP matrix is ill-conditioned (rotations against
    translations), so ``x`` is held within rtol 1e-3 (atol 1e-6; the
    derivative lane within 1e-3 of its largest entry), as the CPU tests hold
    the JAX solve against PyTorch's, and the kernel's relative residual
    within 4 times the plain one's (plus 1e-6). The pose follows ``x``
    (|x| ~ 1e-2): value lane within 2e-5, derivative lane within 1e-3 of its
    largest entry. The flags must be equal."""
    A, b = step.system.A, step.system.b
    res_k, res_p = _residual(A.v, step.x.v, b.v), _residual(A.v, ref.x.v, b.v)
    rhs = b.g - A.g @ ref.x.v
    res_kg, res_pg = _residual(A.v, step.x.g, b.g - A.g @ step.x.v), _residual(A.v, ref.x.g, rhs)
    x_err = float((step.x.v - ref.x.v).abs().max())
    g_scale = float(ref.x.g.abs().max())
    xg_err = float((step.x.g - ref.x.g).abs().max()) / max(g_scale, 1e-30)
    pose_err = max(max_abs(step.r_curr.v, ref.r_curr.v), max_abs(step.t_curr.v, ref.t_curr.v))
    pg_scale = max(1.0, float(ref.r_curr.g.abs().max()), float(ref.t_curr.g.abs().max()))
    pose_g_err = max(max_abs(step.r_curr.g, ref.r_curr.g), max_abs(step.t_curr.g, ref.t_curr.g)) / pg_scale
    check(bool(step.ok) == bool(ref.ok), f"K4's tail flag {bool(step.ok)} against plain {bool(ref.ok)} ({tag})")
    check(bool(torch.allclose(step.x.v, ref.x.v, rtol=1e-3, atol=1e-6)), f"K4's tail x.v off by {x_err} ({tag})")
    check(bool(torch.allclose(step.x.g, ref.x.g, rtol=1e-3, atol=1e-3 * g_scale)),
          f"K4's tail x.g off by {xg_err} of its largest entry ({tag})")
    check(res_k <= 4 * res_p + 1e-6 and res_kg <= 4 * res_pg + 1e-6,
          f"K4's tail residuals {res_k}, {res_kg} against plain {res_p}, {res_pg} ({tag})")
    check(pose_err <= 2e-5 and pose_g_err <= 1e-3, f"K4's tail pose off by {pose_err}, {pose_g_err} ({tag})")
    return dict(tail_ok=bool(step.ok), tail_x_abs_err=x_err, tail_xg_rel_err=xg_err, tail_pose_abs_err=pose_err,
                tail_pose_g_rel_err=pose_g_err, tail_residual=res_k, plain_residual=res_p,
                tail_residual_g=res_kg, plain_residual_g=res_pg)


def _same_step(a, b) -> bool:
    pairs = ((a.r_curr, b.r_curr), (a.t_curr, b.t_curr), (a.x, b.x), (a.system.A, b.system.A), (a.system.b, b.system.b))
    return all(bool(torch.equal(x.v, y.v)) and bool(torch.equal(x.g, y.g)) for x, y in pairs) \
        and bool(a.ok) == bool(b.ok)


def _check_fold(ctx, lintr, vcurr, ncurr, vprev, nprev, pose, index, where: str) -> dict:
    """The association folded into a level's first ``icp_system`` launch: the
    index map it writes equals ``icp_associate``'s ``index`` at every pixel
    with a current normal and is -1 elsewhere, and the launch's A, b, inlier
    count, pose, x and flags equal those of the launch that reads ``index``
    instead, bit for bit. Returns the three first-iteration times (with the
    tail): projecting, projecting and storing the index, reading it."""
    project = _K4Launch(ctx, lintr, vcurr, ncurr, vprev, nprev, pose, None)
    cached = _K4Launch(ctx, lintr, vcurr, ncurr, vprev, nprev, pose, index)
    folded = torch.full_like(index, -7)
    project(tail=True, assoc_out=folded)
    cached(tail=True)
    torch.cuda.synchronize()
    has_normal = ~torch.isnan(ncurr[0])
    index_equal = bool(torch.equal(folded[has_normal], index[has_normal]))
    elsewhere = bool((folded[~has_normal] == -1).all())
    outputs = [(project.out, cached.out), (project.count, cached.count)] + list(zip(project.tail, cached.tail))
    same = all(bool(torch.equal(a, b)) for a, b in outputs)
    check(index_equal and elsewhere, f"the folded association differs from icp_associate's ({where}): equal where "
                                     f"the normal is a number {index_equal}, -1 elsewhere {elsewhere}")
    check(same, f"the folded first launch's system, pose or flags differ from the cached-index launch's ({where})")
    return dict(folded_index_equal=index_equal, folded_minus_one_without_normal=elsewhere, folded_system_equal=same,
                first_iteration_ms=time_ms(lambda: project(tail=True), 200),
                first_iteration_folded_ms=time_ms(lambda: project(tail=True, assoc_out=folded), 200),
                cached_iteration_ms=time_ms(lambda: cached(tail=True), 200))


def phase_icp(ctx):
    """K4 against its plain versions at the three level shapes of both
    main-path configurations, with and without the cached association (made
    at the starting pose, used there and at a moved pose): without the tail
    against ``build_system_plain``, with it against ``icp_step_plain`` on the
    kernel's own system, each twice for equal bits; a damped step; a
    degenerate step (NaN model maps) that must freeze the pose. Times, a
    sweep of the grid and runs with parts of the work switched off by their
    inputs, at ``model_map_level=0``."""
    from xslam_tpu_torch.csfd.single import CSFD
    from xslam_tpu_torch.ops import icp, kernels

    cfg, dev = ctx["config"], ctx["device"]
    intr = cfg.intrinsics
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    worst_err, worst_inl, worst_idx, abs_err, fold_ms = 0.0, 0.0, 1.0, 0.0, 0.0
    table, assoc_row = [], None
    for L in (0, 1):
        vprev, nprev, vcurr, ncurr, pose = _icp_inputs(ctx, L)
        moved = dict(pose, t_curr=CSFD(pose["t_curr"].v + torch.tensor([2e-3, -1e-3, 1.5e-3], device=dev),
                                       pose["t_curr"].g))
        for level in reversed(range(cfg.num_levels)):
            lintr = intr.level(level + L)
            prev_shape = tuple(vprev[level].v.shape[-2:])

            def args(p, level=level, lintr=lintr):
                return (p["r_curr"], p["t_curr"], vcurr[level], ncurr[level], p["r_prev_inv"], p["t_prev"], lintr,
                        vprev[level], nprev[level], cfg.dist_thres, cfg.angle_thres_sine)

            index = icp.associate_index(pose["r_curr"], pose["t_curr"], vcurr[level], pose["r_prev_inv"],
                                        pose["t_prev"], lintr, prev_shape)
            index_plain = icp.associate_index_plain(pose["r_curr"], pose["t_curr"], vcurr[level],
                                                    pose["r_prev_inv"], pose["t_prev"], lintr, prev_shape)
            idx_eq = float((index == index_plain).float().mean())
            worst_idx = min(worst_idx, idx_eq)
            fold = _check_fold(ctx, lintr, vcurr[level], ncurr[level], vprev[level], nprev[level], pose, index,
                               f"L={L}, level {level}")
            emit("K4 icp_system, association folded into the first launch", model_map_level=L, level=level,
                 curr_shape=list(vcurr[level].shape[1:]), prev_shape=list(prev_shape), **fold,
                 index_store_ms=fold["first_iteration_folded_ms"] - fold["first_iteration_ms"])
            if L == 1:  # the fixed setting's levels: what the fold adds to a frame there
                fold_ms += fold["first_iteration_folded_ms"] - fold["first_iteration_ms"]
            cases = (("projected", pose, None, None), ("cached", pose, index, index_plain),
                     ("cached, moved pose", moved, index, index_plain))
            for tag, p, a_k, a_p in cases:
                where = f"L={L}, level {level}, {tag}"
                k = icp.build_system(*args(p), assoc=a_k)
                k2 = icp.build_system(*args(p), assoc=a_k)
                ref = icp.build_system_plain(*args(p), assoc=a_p)
                torch.cuda.synchronize()
                same_bits = all(bool(torch.equal(x, y)) for x, y in
                                ((k.A.v, k2.A.v), (k.A.g, k2.A.g), (k.b.v, k2.b.v), (k.b.g, k2.b.g)))
                check(same_bits, f"K4 gave other bits on a second run ({where})")
                for i in range(6):
                    check(bool(torch.equal(k.A.v[i], k.A.v[:, i])), "K4's A is not symmetric")
                err = _system_err(k, ref)
                n_k, n_p = int(k.inlier_count), int(ref.inlier_count)
                inl = abs(n_k - n_p) / max(1, n_p)
                worst_err, worst_inl = max(worst_err, err), max(worst_inl, inl)
                row = dict(model_map_level=L, level=level, case=tag, curr_shape=list(vcurr[level].shape[1:]),
                           prev_shape=list(prev_shape), inliers=n_k, inliers_plain=n_p, rel_err=err,
                           index_frac_equal=idx_eq)

                # the whole iteration: the same system, then the tail against the plain step on it
                step = icp.icp_step(*args(p), damping=cfg.icp_damping, assoc=a_k)
                step2 = icp.icp_step(*args(p), damping=cfg.icp_damping, assoc=a_k)
                torch.cuda.synchronize()
                check(_same_step(step, step2), f"K4 with its tail gave other bits on a second run ({where})")
                check(bool(torch.equal(step.system.A.v, k.A.v)) and bool(torch.equal(step.system.b.g, k.b.g))
                      and int(step.system.inlier_count) == n_k, f"K4's system differs with and without the tail ({where})")
                plain_step = icp.icp_step_plain(step.system, p["r_curr"], p["t_curr"], cfg.icp_damping)
                check(bool(step.ok), f"K4's tail rejected a good step ({where})")
                row.update(_check_tail(step, plain_step, where))

                if L == 0 and tag != "cached, moved pose":
                    # the kernel alone, from prepared arguments, without and with its tail; the
                    # wrapper, which also packs the pose and the model's rows and allocates
                    launch = _K4Launch(ctx, lintr, vcurr[level], ncurr[level], vprev[level], nprev[level], p, a_k)
                    ms = time_ms(launch, 200)
                    check(bool(torch.equal(launch.out[:36].view(6, 6), k.A.v)), "K4 timed launch differs from the wrapper's")
                    tail_ms = time_ms(lambda: launch(tail=True), 200)
                    wrapper_ms = time_ms(lambda: icp.build_system(*args(p), assoc=a_k), 50)
                    plain = time_ms(lambda: icp.build_system_plain(*args(p), assoc=a_p), 3)
                    plain_step_ms = time_ms(lambda: icp.icp_step_plain(step.system, p["r_curr"], p["t_curr"], 0.0), 3)
                    # What the kernel needs (csrc/icp.cu's header): 72 B per pixel, 4 B
                    # more where the index is cached, the pose in, 85 numbers out; 36
                    # operations per pixel with a normal to move the vertex and 31 to
                    # project it (not where cached), 10 for the distance gate of a pixel
                    # with a target, 270 for an inlier's angle gate, row and sums.
                    # Pixels that pass the distance gate and fail the angle gate are
                    # not counted, so this is a lower bound.
                    n = vcurr[level][0].numel()
                    has_normal = ~torch.isnan(ncurr[level][0])
                    n_normal = int(has_normal.sum())
                    target = index_plain.long().clamp(min=0)
                    n_target = int((has_normal & (index_plain >= 0)
                                    & ~torch.isnan(nprev[level].v[0].reshape(-1)[target])).sum())
                    n_bytes = n * (72 + (4 if a_k is not None else 0)) + 36 * 4 + 85 * 4
                    n_ops = n_normal * (36 + (31 if a_k is None else 0)) + n_target * 10 + n_k * 270
                    bms, by = bound_ms(n_bytes, n_ops)
                    row.update(ms=ms, tail_ms=tail_ms, wrapper_ms=wrapper_ms, plain_ms=plain,
                               plain_step_ms=plain_step_ms, bound_ms=bms, bound_by=by, blocks=launch.blocks)
                    if tag == "projected":
                        # where the time goes: other grids; no current normal (every pixel leaves at
                        # its first gate: the launch, the reductions and the tail are left); no model
                        # (every pixel moves, projects and fetches a row, none is added)
                        sweep = {}
                        for blocks in (16, 33, 66, 132, 198, 264, 396, 528, 1056):
                            if blocks * 32 < 2 * n:  # a grid with pixels for most of its blocks
                                sweep[blocks] = [time_ms(lambda: launch(blocks=blocks), 200),
                                                 time_ms(lambda: launch(tail=True, blocks=blocks), 200)]
                        no_normal = (launch.maps[0], torch.full_like(ncurr[level], torch.nan)) + launch.maps[2:]
                        no_model = launch.maps[:2] + (torch.full_like(launch.maps[2], torch.nan), launch.maps[3])
                        row.update(grid_sweep_ms_without_and_with_tail=sweep,
                                   no_normal_ms=[time_ms(lambda: launch(maps=no_normal), 200),
                                                 time_ms(lambda: launch(tail=True, maps=no_normal), 200)],
                                   no_model_ms=time_ms(lambda: launch(maps=no_model), 200))
                        launch()
                        check(bool(torch.equal(launch.out[:36].view(6, 6), k.A.v)), "K4's grid sweep left its scratch changed")
                    if level == 0 and tag == "projected":
                        abs_err = max(float((k.A.v - ref.A.v).abs().max()), float((k.b.v - ref.b.v).abs().max()))
                        table = dict(max_abs_err=abs_err, ms=ms, tail_ms=tail_ms, plain_ms=plain, bound_ms=bms,
                                     bound_by=by)
                emit("K4 icp_system", **row)
            if L == 0:
                args_a = (pose["r_curr"], pose["t_curr"], vcurr[level], pose["r_prev_inv"], pose["t_prev"], lintr,
                          prev_shape)
                packed = icp.pack_pose(pose["r_curr"], pose["t_curr"], pose["r_prev_inv"], pose["t_prev"])
                out_idx = torch.empty_like(index)
                consts = [kernels.f32(x) for x in (lintr.fx, lintr.fy, lintr.cx, lintr.cy)]

                def launch_a():
                    err_code = ext.icp_associate(vcurr[level], packed, out_idx, *prev_shape, *consts, stream)
                    check(err_code == 0, f"icp_associate launch failed: cudaError {err_code}")

                ms = time_ms(launch_a, 200)
                plain = time_ms(lambda: icp.associate_index_plain(*args_a), 3)
                n = index.numel()
                bms, by = bound_ms(n * (12 + 4) + 36 * 4, n * 67)
                emit("K4 icp_associate", level=level, shape=list(index.shape), index_frac_equal=idx_eq, ms=ms,
                     plain_ms=plain, bound_ms=bms, bound_by=by)
                if level == 0:
                    assoc_row = dict(max_abs_err=float((index - index_plain).abs().max()), ms=ms, plain_ms=plain,
                                     bound_ms=bms, bound_by=by)
        if L == 0:
            # a damped step, and a step with nothing to align to (frame 0 tracks against NaN maps)
            damped = icp.icp_step(*args(pose, 0, intr.level(0)), damping=1e-3)
            row = _check_tail(damped, icp.icp_step_plain(damped.system, pose["r_curr"], pose["t_curr"], 1e-3),
                              "damped")
            undamped = icp.icp_step(*args(pose, 0, intr.level(0)))
            check(not bool(torch.equal(damped.x.v, undamped.x.v)), "K4's tail ignored the damping")
            emit("K4 tail, damped", damping=1e-3, **row)
            nan_map = CSFD(torch.full_like(vprev[0].v, torch.nan), torch.zeros_like(vprev[0].g))
            frozen = icp.icp_step(pose["r_curr"], pose["t_curr"], vcurr[0], ncurr[0], pose["r_prev_inv"],
                                  pose["t_prev"], intr.level(0), nan_map, nan_map, cfg.dist_thres, cfg.angle_thres_sine)
            torch.cuda.synchronize()
            kept = all(bool(torch.equal(x, y)) for x, y in
                       ((frozen.r_curr.v, pose["r_curr"].v), (frozen.r_curr.g, pose["r_curr"].g),
                        (frozen.t_curr.v, pose["t_curr"].v), (frozen.t_curr.g, pose["t_curr"].g)))
            emit("K4 tail, degenerate", ok=bool(frozen.ok), pose_kept=kept, inliers=int(frozen.system.inlier_count),
                 x_abs_max=float(frozen.x.v.abs().max()))
            check(not bool(frozen.ok) and kept and int(frozen.system.inlier_count) == 0
                  and float(frozen.x.v.abs().max()) == 0.0 and float(frozen.x.g.abs().max()) == 0.0,
                  "K4's tail did not freeze the pose on a system without correspondences")
    emit("K4 summary", worst_rel_err=worst_err, worst_inlier_rel_diff=worst_inl, worst_index_frac_equal=worst_idx,
         library_ms=None, library_note="no single PyTorch call computes it")
    check(worst_err <= 1e-4, f"K4 disagrees with its plain version: A/b {worst_err} of a lane's largest entry")
    check(worst_inl <= 1e-3, f"K4's inlier count differs from the plain version's by {worst_inl}")
    check(worst_idx >= 0.9999, f"K4's association differs from the plain version's: equal on {worst_idx}")
    assoc_row.update(folded_into="icp_system", fold_ms_per_frame_fixed_setting=fold_ms)
    ctx["icp_associate"] = assoc_row
    return table


# ----------------------------------------------------------------------------
def _bits_on(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> bool:
    """``a`` and ``b`` hold the same float32 bits wherever ``mask`` is set."""
    return bool(torch.equal(a.contiguous().view(torch.int32)[mask], b.contiguous().view(torch.int32)[mask]))


def _loss_bytes_ops(band: int, depth_pixels: int, pairs: int, mode: str):
    """B12's least work over a band of ``band`` voxels: the band's indices
    and values (8 B a voxel), the depth, the poses and sums once; the
    operations of the function at each band voxel: the value lane, and in
    REDUCE the square roots' coefficients, one first-derivative lane a
    direction (``min(pairs, 6)``) and one second-derivative lane a pair."""
    ops = band * TSDF_LOSS_VALUE_OPS
    if mode == "reduce":
        ops += band * (TSDF_LOSS_SQRT_OPS + min(pairs, 6) * TSDF_LOSS_E1_OPS + pairs * TSDF_LOSS_E12_OPS)
    return band * 8 + depth_pixels * 4 + pairs * 48 * 4 + 29 * 4, ops


def _band_bytes_ops(n_voxels: int, band: int):
    """The band pass's least work: the value plane read once, the band's
    indices and its count written once; gt's test at every voxel."""
    return n_voxels * 4 + band * 4 + 4, n_voxels * TSDF_BAND_OPS


def _call_bound_ms(n_voxels: int, band: int, depth_pixels: int, iters: int):
    """The least device time of a ``relocalize`` call's B12 work, launch by
    launch: the band pass once, then ``iters`` REDUCE and ``iters + 2`` VALUE
    launches over the band."""
    return (bound_ms(*_band_bytes_ops(n_voxels, band))[0]
            + iters * bound_ms(*_loss_bytes_ops(band, depth_pixels, 21, "reduce"))[0]
            + (iters + 2) * bound_ms(*_loss_bytes_ops(band, depth_pixels, 1, "value"))[0])


def phase_tsdf_loss(ctx):
    """B12 and its band pass against their plain versions on the card, on the
    smoke's fused 256^3 volume and frame 3's depth, at ``log_real`` of frame
    3's true pose plus (0.02, -0.01, 0.015, 0.01, -0.01, 0.005), the 21 seed
    pairs of ``models/relocalize.py``, and on a 201x203x205 crop (a ragged
    last tile): the band equal to ``band_plain``; FIELD bit-equal to
    ``_field_plain`` on the mask for pairs 0, 5, 10 and 20, the masks equal;
    REDUCE over the band, its count equal and its 28 sums within a float32
    ulp of the plain version's float64 sums, a second launch and a launch
    that lists its own band bit-identical; VALUE's loss and count REDUCE's
    bits; one pose (a cross pair's, as ``tsdf_loss_hessian`` takes it)
    within an ulp of the plain version; poses whose lanes are not shared
    (an e1 entry of a cross pair moved by an ulp) give NaN sums and a count of
    -1, and in FIELD NaN lanes and a false mask. The band pass, REDUCE and VALUE timed warm and cold beside their
    bounds and the plain versions."""
    from xslam_tpu_torch.geometry import se3
    from xslam_tpu_torch.models.relocalize import seeded_poses
    from xslam_tpu_torch.ops import fusion
    from xslam_tpu_torch.ops import tsdf_loss as tl

    cfg, eng, dev = ctx["config"], ctx["engine_cfg"], ctx["device"]
    intr = cfg.intrinsics
    depth_m = fusion.scale_depth(torch.as_tensor(ctx["depths"][3], device=dev))
    c2v = np.asarray(cfg.world2volume, np.float32) @ (np.linalg.inv(ctx["gt"][0]) @ ctx["gt"][3])
    xi = se3.log_real(c2v) + np.array(TSDF_LOSS_OFFSET, np.float32)
    poses = seeded_poses(torch.as_tensor(xi, device=dev))
    unshared = poses.clone()
    unshared[10, 12] = torch.nextafter(unshared[10, 12], torch.tensor(float("inf"), device=dev))
    full = ctx["volume"].value
    table = None
    # (case, volume, the fewest masked voxels the case must give: 89,509 and 5,183 on an H100)
    for case, value, least in (("fused volume", full, 50_000),
                               ("crop 201x203x205", full[:201, :203, :205].contiguous(), 2_000)):
        band = tl.make_band(value)
        plain_band = tl.band_plain(value)
        torch.cuda.synchronize()
        n_band = int(plain_band.count)
        band_equal = int(band.count) == n_band and bool(torch.equal(band.index[:n_band], plain_band.index[:n_band]))
        field = {}
        for pair in TSDF_LOSS_FIELD_PAIRS:
            k_loss, k_mask = tl.tsdf_loss_field(value, depth_m, poses, intr, eng, pair=pair)
            p_loss, p_mask = tl._field_plain(value, depth_m, poses[pair], intr, eng)
            torch.cuda.synchronize()
            masks = bool(torch.equal(k_mask, p_mask))
            lanes = [_bits_on(a, b, p_mask) for a, b in zip(k_loss, p_loss)]
            field[pair] = dict(masks_equal=masks, lanes_bit_equal=lanes, masked=int(p_mask.sum()),
                               max_ulp=max(max_ulp(a[p_mask], b[p_mask]) for a, b in zip(k_loss, p_loss)))
            check(masks and all(lanes),
                  f"B12 FIELD ({case}, pair {pair}) differs from the plain version: {field[pair]}")
        sums, count = tl.tsdf_loss_pairs(value, depth_m, poses, intr, eng, band=band)
        again, count2 = tl.tsdf_loss_pairs(value, depth_m, poses, intr, eng, band=band)
        own, count3 = tl.tsdf_loss_pairs(value, depth_m, poses, intr, eng)  # lists its own band
        v_sums, v_count = tl.tsdf_loss_pairs(value, depth_m, poses, intr, eng, mode="value", band=band)
        p_sums, p_count = tl.tsdf_loss_hessian_plain(value, depth_m, poses, intr, eng)
        one, one_count = tl.tsdf_loss_pairs(value, depth_m, poses[12:13].contiguous(), intr, eng, band=band)
        p_one, p_one_count = tl.tsdf_loss_hessian_plain(value, depth_m, poses[12:13].contiguous(), intr, eng)
        bad, bad_count = tl.tsdf_loss_pairs(value, depth_m, unshared, intr, eng, band=band)
        bad_field, bad_mask = tl.tsdf_loss_field(value, depth_m, unshared, intr, eng, pair=10)
        torch.cuda.synchronize()
        ulp = max_ulp(sums, p_sums)
        one_ulp = max_ulp(one, p_one)
        repeat = bool(torch.equal(sums, again)) and bool(torch.equal(sums, own)) and \
            int(count) == int(count2) == int(count3)
        value_same = _bits_on(v_sums[:1], sums[:1], torch.ones(1, dtype=torch.bool, device=dev)) and \
            int(v_count) == int(count)
        refused = bool(torch.isnan(bad).all()) and int(bad_count) == -1
        field_refused = all(bool(torch.isnan(lane).all()) for lane in bad_field) and not bool(bad_mask.any())
        err = max_abs(sums, p_sums)
        emit("B12 tsdf_loss", case=case, shape=list(value.shape), band_voxels=n_band, band_equal=band_equal,
             count=int(count), plain_count=int(p_count), sums_max_ulp=ulp, sums_max_abs_err=err, loss=float(sums[0]),
             value_loss_count_equal=value_same, second_launch_bit_equal=repeat, one_pose_max_ulp=one_ulp,
             one_pose_count_equal=int(one_count) == int(p_one_count), unshared_lanes_refused=refused,
             unshared_field_refused=field_refused, field=field)
        check(band_equal, f"B12's band ({case}): {int(band.count)} voxels, plain {n_band}, or another order")
        check(int(count) == int(p_count) > least, f"B12 ({case}): count {int(count)}, plain {int(p_count)}")
        check(ulp <= 1 and one_ulp <= 1 and int(one_count) == int(p_one_count),
              f"B12 ({case}): sums {ulp} float32 steps from the plain version's, one pose's {one_ulp}")
        check(value_same and repeat, f"B12 ({case}): VALUE equal {value_same}, launches again equal {repeat}")
        check(refused, f"B12 ({case}): poses whose lanes are not shared gave {bad.tolist()}, {int(bad_count)}")
        check(field_refused, f"B12 FIELD ({case}): poses whose lanes are not shared gave lanes that are not all NaN "
                             f"or a mask that is not all false")
        if table is None:
            X, Y, Z = value.shape
            H, W = depth_m.shape
            reduce = lambda: tl.tsdf_loss_pairs(value, depth_m, poses, intr, eng, band=band)  # noqa: E731
            only_value = lambda: tl.tsdf_loss_pairs(value, depth_m, poses, intr, eng, mode="value",  # noqa: E731
                                                     band=band)
            listing = lambda: tl.make_band(value)  # noqa: E731
            flags = (value != 0) & (value.abs() <= 0.95)
            ms, cold = time_ms(reduce, 20), time_cold_ms(reduce, 10)
            v_ms, v_cold = time_ms(only_value, 50), time_cold_ms(only_value, 20)
            b_ms, b_cold = time_ms(listing, 50), time_cold_ms(listing, 20)
            b_library = time_ms(lambda: torch.nonzero(flags.reshape(-1)), 20)
            plain = time_ms(lambda: tl.tsdf_loss_hessian_plain(value, depth_m, poses, intr, eng), 1)
            v_plain = time_ms(lambda: tl.tsdf_loss_hessian_plain(value, depth_m, poses, intr, eng, mode="value"), 2)
            b_plain = time_ms(lambda: tl.band_plain(value), 5)
            bms, by = bound_ms(*_loss_bytes_ops(n_band, H * W, 21, "reduce"))
            v_bms, v_by = bound_ms(*_loss_bytes_ops(n_band, H * W, 1, "value"))
            b_bms, b_by = bound_ms(*_band_bytes_ops(X * Y * Z, n_band))
            call_bms = _call_bound_ms(X * Y * Z, n_band, H * W, RELOC_ITERS)
            emit("B12 tsdf_loss timing", shape=[X, Y, Z], band_voxels=n_band, pairs=21, ms=ms, cold_ms=cold,
                 plain_ms=plain, bound_ms=bms, bound_by=by, value_ms=v_ms, value_cold_ms=v_cold,
                 value_plain_ms=v_plain, value_bound_ms=v_bms, value_bound_by=v_by, band_ms=b_ms, band_cold_ms=b_cold,
                 band_plain_ms=b_plain, band_bound_ms=b_bms, band_bound_by=b_by, band_library_ms=b_library,
                 call_bound_ms=call_bms,
                 bound_counts=f"over the band: its indices and values (8 B a voxel), the depth, the poses once; at "
                 f"each band voxel {TSDF_LOSS_VALUE_OPS} operations for the value lane, {TSDF_LOSS_E1_OPS} a "
                 f"first-derivative lane (6), {TSDF_LOSS_E12_OPS} a second-derivative lane (21), "
                 f"{TSDF_LOSS_SQRT_OPS} for the square roots' coefficients; the band pass: the value plane once, "
                 f"the band written once, {TSDF_BAND_OPS} operations a voxel; a call: the band pass, "
                 f"{RELOC_ITERS} REDUCE and {RELOC_ITERS + 2} VALUE launches",
                 library_ms=None, library_note="no single PyTorch call computes the loss; the band's library_ms is "
                 "torch.nonzero of gt's test computed beforehand (a yardstick)")
            table = {"tsdf_loss": dict(max_abs_err=err, sums_max_ulp=ulp, ms=ms, cold_ms=cold, plain_ms=plain,
                                       bound_ms=bms, bound_by=by, value_ms=v_ms, value_cold_ms=v_cold,
                                       value_plain_ms=v_plain, value_bound_ms=v_bms, band_voxels=n_band,
                                       call_bound_ms=call_bms),
                     "tsdf_band": dict(max_abs_err=0.0 if band_equal else None, ms=b_ms, cold_ms=b_cold,
                                       plain_ms=b_plain, bound_ms=b_bms, bound_by=b_by, library_ms=b_library,
                                       library_note="torch.nonzero of gt's test computed beforehand (a yardstick)",
                                       band_voxels=n_band)}
    return table


def phase_relocalize_path(ctx):
    """``apps/relocalize_demo.main`` on the card with configs/synthetic.yaml at
    its defaults: 12 oracle-pose frames fused at 640x480 into the 256^3
    volume (K2), 3 held-out frames relocalized from perturbed poses, 12
    Newton iterations each. Each loss history must descend (JAX's own test
    condition), B12 must launch ``2 * iters + 2`` times a call and its band
    pass once. Then holdout 0 with 4 iterations through B12 and through its
    plain version (which lists its own voxels), both on the card from the same
    inputs: the same accept decisions and ``xi`` within 1e-5. The translation errors are printed, not held to a
    number: the basin at 3 cm voxels and 0.10 m of perturbation has no
    measured bound. Last, B12's band pass, REDUCE and VALUE timed on the
    path's own map and holdout 0's depth at its start, and one
    ``relocalize`` call of holdout 0 under the profiler: its wall time beside
    the device's busy time and B12's share of it, all 26 B12 launches and
    the band pass's two kernels seen."""
    import contextlib
    import io

    from xslam_tpu_torch.apps import relocalize_demo
    from xslam_tpu_torch.io.config import load_config
    from xslam_tpu_torch.io.dataset import make_dataset
    from xslam_tpu_torch.models.relocalize import newton, relocalize, seeded_poses
    from xslam_tpu_torch.ops import kernels
    from xslam_tpu_torch.ops.tsdf_loss import make_band, tsdf_loss_hessian_plain, tsdf_loss_pairs

    path = os.path.join(ROOT, "configs", "synthetic.yaml")
    stdout = io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        holdouts = relocalize_demo.main([path])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    lines = [line for line in stdout.getvalue().splitlines() if line.startswith("frame ")]
    for line in lines:
        print(f"relocalize path: {line}", flush=True)
    histories = [h.result.loss_history.cpu().numpy() for h in holdouts]
    want = len(holdouts) * (2 * RELOC_ITERS + 2)

    # holdout 0 with 4 iterations, through B12 and through the plain version, from the same inputs
    config = load_config(path)
    config.end_frame = RELOC_FRAMES + RELOC_HOLDOUTS
    ds = make_dataset(config)
    vol, vol_cfg = relocalize_demo.build_map(config, ds, RELOC_FRAMES, ctx["device"])
    dm = relocalize_demo.depth_metres(ds, RELOC_FRAMES, ctx["device"])
    _, xi0 = relocalize_demo.holdout_start(config, ds, RELOC_FRAMES, np.random.default_rng(0), 0.10)
    k_out, k_acc, _ = newton(vol.value, dm, xi0, config.intrinsics, vol_cfg, iters=RELOC_CHECK_ITERS)
    p_out, p_acc, _ = newton(vol.value, dm, xi0, config.intrinsics, vol_cfg, iters=RELOC_CHECK_ITERS,
                             pairs=tsdf_loss_hessian_plain)
    xi_gap = float((k_out.xi - p_out.xi).abs().max())
    same_accepts = bool(torch.equal(k_acc, p_acc))
    emit("relocalize path", frames=RELOC_FRAMES, holdouts=len(holdouts), iters=RELOC_ITERS, run_s=run_s,
         relocalize_s=[h.seconds for h in holdouts], init_err_m=[h.init_err for h in holdouts],
         err_m=[h.err for h in holdouts], loss_history=[hist.tolist() for hist in histories],
         inliers=[int(h.result.count) for h in holdouts], tsdf_loss_launches=counts["tsdf_loss"],
         tsdf_loss_launches_expected=want, tsdf_band_launches=counts["tsdf_band"],
         fuse_volume_launches=counts["fuse_volume"],
         b12_vs_plain=dict(iters=RELOC_CHECK_ITERS, xi_max_abs_diff=xi_gap, accepts_equal=same_accepts,
                           accepts=k_acc.tolist(), plain_accepts=p_acc.tolist(),
                           loss_history=k_out.loss_history.tolist(), plain_loss_history=p_out.loss_history.tolist()))
    check(len(lines) == len(holdouts) == RELOC_HOLDOUTS, f"the demo printed {lines}")
    check(all(np.all(np.diff(hist) < 1e-5) for hist in histories), f"a loss history rises: {histories}")
    check(counts["tsdf_loss"] == want and counts["tsdf_band"] == len(holdouts) and
          counts["fuse_volume"] == RELOC_FRAMES,
          f"the relocalize path launched B12 {counts['tsdf_loss']} times ({want}), its band pass "
          f"{counts['tsdf_band']} ({len(holdouts)}), K2 {counts['fuse_volume']}")
    check(same_accepts and xi_gap <= 1e-5, f"B12's and the plain version's relocalize differ: accepts "
                                           f"{k_acc.tolist()} / {p_acc.tolist()}, xi by {xi_gap}")

    # B12 on the path's own map and holdout 0's depth at its start, then one relocalize call under the profiler
    value, intr = vol.value, config.intrinsics
    xi_start = torch.as_tensor(xi0, device=ctx["device"])
    poses = seeded_poses(xi_start)
    band = make_band(value)
    n_band = int(band.count)
    reduce = lambda: tsdf_loss_pairs(value, dm, poses, intr, vol_cfg, band=band)  # noqa: E731
    only_value = lambda: tsdf_loss_pairs(value, dm, poses, intr, vol_cfg, mode="value", band=band)  # noqa: E731
    listing = lambda: make_band(value)  # noqa: E731
    ms, cold = time_ms(reduce, 20), time_cold_ms(reduce, 10)
    v_ms, v_cold = time_ms(only_value, 50), time_cold_ms(only_value, 20)
    b_ms, b_cold = time_ms(listing, 50), time_cold_ms(listing, 20)
    bms, by = bound_ms(*_loss_bytes_ops(n_band, dm.numel(), 21, "reduce"))
    call_bms = _call_bound_ms(value.numel(), n_band, dm.numel(), RELOC_ITERS)
    call = lambda: relocalize(value, dm, xi_start, intr, vol_cfg, iters=RELOC_ITERS)  # noqa: E731
    call()
    rec, takes = _profiled_call(call), 1
    # a trace that holds fewer device events than the host made launch calls lost some of them (the profiler's
    # buffer): it is taken again, at most twice, and the checks below read the last take
    while rec["device_events"] < rec["host_calls"] and takes < 3:
        rec, takes = _profiled_call(call), takes + 1
    want_b12 = 2 * RELOC_ITERS + 2
    ctx["tsdf_loss_path"] = dict(path_ms=ms, path_cold_ms=cold, path_value_ms=v_ms, path_value_cold_ms=v_cold,
                                 path_band_voxels=n_band, path_bound_ms=bms, path_bound_by=by,
                                 path_call_bound_ms=call_bms, relocalize_call_wall_ms=rec["wall_ms"],
                                 relocalize_call_device_busy_ms=rec["device_busy_ms"],
                                 relocalize_call_b12_device_ms=rec["kernel_ms"],
                                 relocalize_call_band_device_ms=rec["band_ms"])
    ctx["tsdf_band_path"] = dict(path_ms=b_ms, path_cold_ms=b_cold, path_band_voxels=n_band,
                                 relocalize_call_device_ms=rec["band_ms"])
    emit("relocalize path, B12 and one call", band_voxels=n_band, ms=ms, cold_ms=cold, value_ms=v_ms,
         value_cold_ms=v_cold, band_pass_ms=b_ms, band_pass_cold_ms=b_cold, bound_ms=bms, bound_by=by,
         call_bound_ms=call_bms,
         call_iters=RELOC_ITERS, b12_and_band_device_ms=rec["kernel_ms"] + rec["band_ms"], profile_takes=takes,
         **rec)
    check(rec["kernel_events"] == want_b12 and rec["band_events"] == len(DEVICE_KERNELS["tsdf_band"]),
          f"the profiled relocalize call shows {rec['kernel_events']} B12 launches ({want_b12}) and "
          f"{rec['band_events']} band pass kernels ({len(DEVICE_KERNELS['tsdf_band'])})")
    return counts


def _profiled_call(fn, kernel: str = "tsdf_loss_kernel") -> dict:
    """``fn()`` under :func:`_lead_profile`: the wall time, the device's busy
    time (its events' durations, the spins' left out) and idle share, its
    events, the host's launch, copy and fill calls, and the events and device
    time of ``kernel`` and of B12's band pass."""
    from torch.autograd import DeviceType

    from xslam_tpu_torch.profile_step import HOST_LAUNCH_CALLS

    _, prof, wall_ms = _lead_profile(fn)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA and LEAD_KERNEL not in e.name]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    mine = [e for e in device if kernel in e.name]
    band = [e for e in device if any(k in e.name for k in DEVICE_KERNELS["tsdf_band"])]
    host_calls = sum(1 for e in prof.events()
                     if e.device_type == DeviceType.CPU and e.name.startswith(HOST_LAUNCH_CALLS)) - PROFILE_LEAD
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / wall_ms,
                device_events=len(device), host_calls=host_calls, kernel_events=len(mine),
                kernel_ms=sum(e.time_range.elapsed_us() for e in mine) / 1e3, band_events=len(band),
                band_ms=sum(e.time_range.elapsed_us() for e in band) / 1e3)


def phase_odometry_path(ctx):
    """``OdometryEngine`` (frame-to-frame ICP: K1, K7, K8 and K4 a frame) over
    10 frames of the 640x480 orbit: every frame aligned, ATE < 0.1 m (JAX's
    test bound), each kernel's launches a frame."""
    import dataclasses

    from xslam_tpu_torch.models.odometry import OdometryEngine
    from xslam_tpu_torch.ops import kernels
    from xslam_tpu_torch.utils.evaluation import ate_rmse, normalize_to_first

    cfg = dataclasses.replace(ctx["config"], end_frame=N_FRAMES_ODOMETRY)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    engine = OdometryEngine(cfg, device=ctx["device"])
    state = engine.init_state()
    aligned, times = [], []
    for i in range(N_FRAMES_ODOMETRY):
        t0 = time.perf_counter()
        state, res = engine.process_frame(state, ctx["depths"][i])
        engine.log_pose(res)
        times.append((time.perf_counter() - t0) * 1e3)
        aligned.append(bool(res.align_ok))
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)
    ate = ate_rmse(normalize_to_first(engine.pose_log), normalize_to_first(ctx["gt"][:N_FRAMES_ODOMETRY]))
    iterations = sum(cfg.icp_iterations[: cfg.num_levels])
    per_frame = {k: v / N_FRAMES_ODOMETRY for k, v in counts.items() if v}
    emit("odometry path", frames=N_FRAMES_ODOMETRY, ate_m=ate, aligned=aligned, launches_per_frame=per_frame,
         mean_frame_ms=float(np.mean(times[1:])), frame_ms=times)
    check(all(aligned), f"odometry frames failed to align: {aligned}")
    check(ate < 0.1, f"odometry ATE {ate} m >= 0.1 m")
    want = {"bilateral_filter": 1, "depth_pyramid": 1, "vertex_normal_maps": 1, "icp_system": iterations}
    check(per_frame == want, f"odometry launches a frame {per_frame}, expected {want}")
    return counts


def phase_probes(ctx):
    """The five gather probes, bit-equal to their plain versions, and the
    probe path itself: the entry point's ``run`` on the card."""
    from xslam_tpu_torch.apps import probe_gather as pg
    from xslam_tpu_torch.ops import kernels

    dev = ctx["device"]
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ta, ia = pg.inputs_a(dev)
    tb, ib = pg.inputs_b(dev)
    (tc,), (td,) = pg.inputs_c(dev), pg.inputs_d(dev)
    te, ie = pg.inputs_e(dev)
    n_e = ie.numel()
    # name: (wrapper call, plain call, prepared launch, bytes needed, operations, library call)
    f32 = dict(dtype=torch.float32, device=dev)
    oa, ob, oc, od = (torch.empty(s, **f32) for s in ((8, 128), (8, 128), (1, 1), (8, 128)))
    oe = torch.empty_like(ie)
    ia64, ib64 = ia.long(), ib.long()
    probes = {
        "probe_a": (lambda: pg.probe_a(ta, ia), lambda: pg.probe_a_plain(ta, ia),
                    lambda: ext.probe_a(ta, ia, oa, stream), 1024 * 12, 1024 * 2,
                    lambda: torch.take_along_dim(ta, ia64, 0)),
        "probe_b": (lambda: pg.probe_b(tb, ib), lambda: pg.probe_b_plain(tb, ib),
                    lambda: ext.probe_b(tb, ib, ob, stream), 1024 * 12, 1024 * 2,
                    lambda: torch.take_along_dim(tb, ib64, 1)),
        "probe_c": (lambda: pg.probe_c(tc), lambda: pg.probe_c_plain(tc),
                    lambda: ext.probe_c(tc, oc, stream), 17 * 4, 16 * 3, None),
        "probe_d": (lambda: pg.probe_d(td), lambda: pg.probe_d_plain(td),
                    lambda: ext.probe_d(td, od, stream), 1024 * 4 * 9, 1024 * 8 * 3, None),
        # PROBE_E_STEPS steps: each ray reads one 4-byte element per step, then its start and result
        "probe_e": (lambda: pg.probe_e(te, ie, PROBE_E_STEPS), lambda: pg.probe_e_plain(te, ie, PROBE_E_STEPS),
                    lambda: ext.probe_e(te, ie, oe, PROBE_E_STEPS, stream), n_e * (PROBE_E_STEPS * 4 + 8),
                    n_e * PROBE_E_STEPS * 5, None),
    }
    rows = {}
    for name, (wrapper, plain_fn, prepared, n_bytes, n_ops, library) in probes.items():
        out, ref = wrapper(), plain_fn()
        torch.cuda.synchronize()
        equal = bool(torch.equal(out, ref))

        def launch(prepared=prepared, name=name):
            err_code = prepared()
            check(err_code == 0, f"{name} launch failed: cudaError {err_code}")

        ms = time_ms(launch, 200)
        plain = time_ms(plain_fn, 5)
        lib = time_ms(library, 50) if library is not None else None
        if library is not None:
            check(bool(torch.equal(library(), out)), f"{name} differs from torch.take_along_dim")
        bms, by = bound_ms(n_bytes, n_ops)
        err = float((out.double() - ref.double()).abs().max())
        emit(name, shape=list(out.shape), bit_equal=equal, max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
             bound_by=by, library_ms=lib,
             library_note="torch.take_along_dim" if library is not None else "no single PyTorch call computes it")
        check(equal, f"{name} is not bit-equal to its plain version")
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib)

    # the probe path, through its entry point
    kernels.reset_launch_counts()
    results = pg.run(dev)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)
    emit("probe path", kernels=counts, E=results["E_bench"], canary=results["canary"])
    check(results["canary"]["ok"] and "skipped" not in results["canary"], f"canary: {results['canary']}")
    check(results["E_bench"]["timed_on"] == "cuda" and results["E_bench"]["t64_ms"] > 0, f"E: {results['E_bench']}")
    for name in probes:
        check(counts[name] >= 1, f"the probe path never launched {name}: {counts}")
    check(counts["bilateral_filter"] >= 1, f"the canary never launched the bilateral kernel: {counts}")
    ctx["probe_counts"] = counts
    return rows


def _frame_record(prof, lead: int = PROFILE_LEAD) -> dict:
    """What a profiled frame ran: its device events in time order (the
    stages' own ranges and the window's ``lead`` spin kernels aside), the
    positions of the ICP launches among them, the host's launch, copy and
    fill calls less the spins' (each makes one device event, so the two
    counts agree unless the profiler lost events of the frame), and the
    launches of each stage."""
    from torch.autograd import DeviceType

    from xslam_tpu_torch.profile_step import HOST_LAUNCH_CALLS, STAGES, stage_launches

    device = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA and e.name not in STAGES
                     and LEAD_KERNEL not in e.name), key=lambda e: e.time_range.start)
    names = [e.name for e in device]
    host_calls = sum(1 for e in prof.events()
                     if e.device_type == DeviceType.CPU and e.name.startswith(HOST_LAUNCH_CALLS)) - lead
    return dict(names=names, icp_at=[j for j, name in enumerate(names) if "icp_system_kernel" in name],
                host_calls=host_calls, stages=stage_launches(prof.events(), 1))


def _lead_profile(fn):
    """``fn()`` under the profiler, after ``PROFILE_LEAD`` spin kernels at
    the start of the window: the profiler drops the first device events of a
    window, the more the longer the process has run (on an H100 the frame's
    first upload and K1 were lost on every retake once the run had gone on
    for a few minutes; not a pause, a CPU op or a synchronize at the window's
    start, only device launches took the loss). ``(fn's result, the
    profile, the wall ms from the spins' end to the end of fn's device
    work)``; the readers leave the spins out."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return out, prof, wall_ms


def _profiled(engine, state, depth):
    """One frame under :func:`_lead_profile`; :func:`_frame_record` reads it."""
    def frame():
        out = engine.process_frame(state, depth)
        engine.log_pose(out[1])  # as profile_step.py profiles a frame
        return out

    (state, res), prof, _ = _lead_profile(frame)
    return state, res, prof


def _engine_run(cfg, ctx, n_frames: int, device_depth_at=None):
    """A second run of ``n_frames``, unprofiled: its ATE and its poses. Frame
    ``device_depth_at``, where given, is fed as a uint16 tensor uploaded to
    the card before the frame, not as a host array."""
    from xslam_tpu_torch.models.kinfu import XSlamEngine
    from xslam_tpu_torch.utils.evaluation import ate_rmse, normalize_to_first

    engine = XSlamEngine(cfg, device=ctx["device"])
    state = engine.init_state()
    for i in range(n_frames):
        depth = ctx["depths"][i]
        if i == device_depth_at:
            depth = torch.as_tensor(np.asarray(depth, np.uint16)).to(ctx["device"])
            torch.cuda.synchronize()
        state, res = engine.process_frame(state, depth)
        engine.log_pose(res)
    return ate_rmse(normalize_to_first(engine.pose_log), normalize_to_first(ctx["gt"][:n_frames])), engine.pose_log


def phase_main_path(ctx, tag: str = "main path"):
    """Drive the engine over the synthetic orbit: as ``configs/synthetic.yaml``
    says (association every ICP iteration, full-resolution model maps, dense
    fusion), with ``icp_fixed_assoc=True, model_map_level=1`` on fewer
    frames, with bench.py's fusion (brick, cap 2816, dense on overflow), or
    in bench.py's whole configuration (the brick layout, the temporal march,
    the ``reuse`` refine, screen normals), also with every frame taking the
    ``hier2`` refresh.

    The last frame runs under the profiler and is held to the frame's
    launches. The profiler sometimes loses device events, so its record is
    trusted only where its device events are as many as the host's launch
    calls; where they differ, one more frame is profiled, at most
    ``PROFILE_RETAKES`` times, and the run fails if no profiled frame gives a
    consistent record. Every attempt's two counts are printed."""
    import dataclasses

    from xslam_tpu_torch.models.kinfu import XSlamEngine
    from xslam_tpu_torch.ops import kernels, raycast
    from xslam_tpu_torch.ops import raycast_bricks as rb
    from xslam_tpu_torch.utils.evaluation import ate_rmse, normalize_to_first

    cfg, n_frames = ctx["config"], N_FRAMES
    if tag == "main path, fixed association":
        cfg = dataclasses.replace(cfg, icp_fixed_assoc=True, model_map_level=1, end_frame=N_FRAMES_FIXED_ASSOC)
        n_frames = N_FRAMES_FIXED_ASSOC
    elif tag == "main path, brick fusion":
        cfg = dataclasses.replace(cfg, fusion_mode="brick", fusion_brick_cap=BRICK_CAP, fusion_overflow="dense",
                                  end_frame=N_FRAMES_BRICK)
        n_frames = N_FRAMES_BRICK
    elif tag == "main path, bench":
        n_frames = N_FRAMES_BENCH
        cfg = dataclasses.replace(cfg, **BENCH_OPTIONS, end_frame=n_frames)
    elif tag == "main path, bench refresh":
        n_frames = N_FRAMES_REFRESH
        cfg = dataclasses.replace(cfg, **BENCH_OPTIONS, raycast_temporal_min_coverage=REFRESH_COVERAGE,
                                  end_frame=n_frames)
    elif tag == "main path, hier2":
        cfg = dataclasses.replace(cfg, **HIER2_OPTIONS, end_frame=n_frames)
    elif tag in DENSE_MARCHES:
        n_frames = N_FRAMES_MARCH
        cfg = dataclasses.replace(cfg, raycast_march=DENSE_MARCHES[tag], end_frame=n_frames)
    elif tag == "main path, bench bilinear":
        n_frames = N_FRAMES_MARCH
        cfg = dataclasses.replace(cfg, **BENCH_OPTIONS, bi_interpolate_threshold=BILINEAR_THRESHOLD,
                                  end_frame=n_frames)
    elif tag in BRICK_RAYCASTS:
        n_frames = N_FRAMES_MARCH
        cfg = dataclasses.replace(cfg, **BRICK_RAYCASTS[tag], end_frame=n_frames)
    elif tag in B15_RUNS:
        n_frames = N_FRAMES_MARCH
        cfg = dataclasses.replace(cfg, **B15_RUNS[tag], end_frame=n_frames)
    brick = cfg.fusion_mode == "brick"
    bench = cfg.volume_layout == "brick"
    temporal = cfg.raycast_march == "temporal"
    refresh = temporal and cfg.raycast_temporal_min_coverage > 1.0
    bilinear = cfg.bi_interpolate_threshold > 0
    march = cfg.raycast_march
    L = cfg.model_map_level
    engine = XSlamEngine(cfg, device=ctx["device"])
    state = engine.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times, aligned, integrated, active, coverage = [], [], 0, [], []
    for i in range(n_frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == n_frames - 1:  # the last frame runs under the profiler and is left out of the times
            state, res, prof = _profiled(engine, state, ctx["depths"][i])
        else:
            state, res = engine.process_frame(state, ctx["depths"][i])
            engine.log_pose(res)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        ok = bool(res.align_ok)
        aligned.append(ok)
        integrated += ok
        active.append(None if res.fusion_active is None else int(res.fusion_active))
        coverage.append(None if res.anchor_coverage is None else float(res.anchor_coverage))
    times = times[:-1]
    counts = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    ate = ate_rmse(normalize_to_first(engine.pose_log), normalize_to_first(ctx["gt"][:n_frames]))
    vmap, nmap = state.vmaps_prev[0], state.nmaps_prev[0]
    valid = ~torch.isnan(vmap.v[0]) & ~torch.isnan(nmap.v[0])
    valid_frac = float(valid.float().mean())
    finite = all(bool(torch.isfinite(x[:, valid]).all()) for x in (vmap.v, vmap.g, nmap.v, nmap.g))

    # the profiled frame's record, retaken on the next frames where the profiler lost events
    retakes = iter(range(n_frames, n_frames + PROFILE_RETAKES))

    def retake():
        nonlocal state
        state, _, retaken = _profiled(engine, state, ctx["depths"][next(retakes)])
        return _frame_record(retaken)

    rec, attempts = consistent_record(_frame_record(prof), retake)
    names, icp_at, host_calls, stages = rec["names"], rec["icp_at"], rec["host_calls"], rec["stages"]
    between = icp_interlopers(names, icp_at)
    # the bench run's second run takes one frame's depth already on the card: the same pose, bit for bit
    depth_at = DEVICE_DEPTH_FRAME if tag == "main path, bench" else None
    twice = bench or tag in B15_RUNS
    second_ate, second_poses = _engine_run(cfg, ctx, n_frames, depth_at) if twice else (None, None)
    device_depth_same = None if depth_at is None else (
        second_poses[depth_at].tobytes() == np.asarray(engine.pose_log[depth_at]).tobytes())
    # B16 gives accepted rays B4's events and samples: whether the first-event march's poses are bench.py's
    # run's first frames bit for bit (printed, not held: a rejected ray's t_found, a later frame's fallback
    # anchor, may differ)
    ctx.setdefault("pose_logs", {})[tag] = [np.asarray(p) for p in engine.pose_log]
    bench_poses = ctx["pose_logs"].get("main path, bench")
    same_as_bench = None if tag != "main path, bench phase1" or bench_poses is None else all(
        a.tobytes() == b.tobytes() for a, b in zip(ctx["pose_logs"][tag], bench_poses[:n_frames]))
    # B15's settings: every volume is K2's bit for bit, so the poses are the reference run's first frames bit for
    # bit (bench.py's run on the brick layout, the first main path on the dense one), and the largest ACTIVE count
    # beside the reference run's over the same frames (None where it fuses densely)
    b15 = None
    if tag in B15_RUNS:
        ref = "main path, bench" if bench else "main path"
        ref_poses = ctx["pose_logs"].get(ref) or []
        b15 = dict(reference_run=ref, poses_equal_to_reference=len(ref_poses) >= n_frames and all(
            a.tobytes() == b.tobytes() for a, b in zip(ctx["pose_logs"][tag], ref_poses[:n_frames])),
            reference_max_active_bricks=max(ctx.get("active_bricks", {}).get(ref, [None])[:n_frames],
                                            key=lambda a: -1 if a is None else a))
    if brick:
        ctx.setdefault("active_bricks", {})[tag] = active

    steady = np.asarray(times[WARM_FRAMES:])
    emit(tag, config="configs/synthetic.yaml", icp_fixed_assoc=cfg.icp_fixed_assoc, model_map_level=L,
         raycast_march=march, raycast_normals=cfg.raycast_normals, raycast_hier_window=cfg.raycast_hier_window,
         bi_interpolate_threshold=cfg.bi_interpolate_threshold, frames=n_frames, depth=[cfg.depth_height, cfg.depth_width],
         volume=list(cfg.tsdf_size), mean_frame_ms=float(steady.mean()), p50_frame_ms=float(np.median(steady)),
         frame_ms=times, ate_m=ate, all_aligned=all(aligned), peak_mem_bytes=peak,
         model_map_valid_fraction=valid_frac, kernels=counts, device_launches_in_profiled_frame=len(names),
         host_launch_calls_in_profiled_frame=host_calls, profiled_frame_attempts=attempts,
         stage_launches_in_profiled_frame=stages,
         icp_launches_in_profiled_frame=len(icp_at), other_device_work_inside_icp_loop=between[:8],
         **(dict(fusion_mode="brick", cap=cfg.fusion_brick_cap, fusion_overflow=cfg.fusion_overflow,
                 active_bricks=active, max_active_bricks=max(active)) if brick else {}),
         **(dict(volume_layout="brick", raycast_refine=cfg.raycast_refine,
                 raycast_temporal_phase1=cfg.raycast_temporal_phase1, second_run_ate_m=second_ate) if bench else {}),
         **(dict(temporal_min_coverage=cfg.raycast_temporal_min_coverage, anchor_coverage=coverage,
                 refresh_frames=sum(c < cfg.raycast_temporal_min_coverage for c in coverage)) if temporal else {}),
         **(dict(device_depth_frame=depth_at, device_depth_pose_equal=device_depth_same) if depth_at is not None
            else {}),
         **(dict(poses_equal_to_bench_run=same_as_bench) if same_as_bench is not None else {}),
         **(dict(b15=b15, fusion_classify_split=cfg.fusion_classify_split,
                 fusion_classify_fine=cfg.fusion_classify_fine, fusion_subcell_cap=cfg.fusion_subcell_cap,
                 **({} if bench else dict(second_run_ate_m=second_ate))) if b15 is not None else {}))
    check(all(aligned), f"frames failed to align: {aligned}")
    check(ate < 0.02, f"ATE {ate} m >= 0.02 m")
    check(tuple(vmap.v.shape) == (3, cfg.depth_height >> L, cfg.depth_width >> L) and finite and valid_frac > 0.5,
          f"model maps: shape {tuple(vmap.v.shape)}, finite {finite}, valid fraction {valid_frac}")
    # every frame tracks, frame 0 too (its estimate is then set aside), so
    # K4 runs once per ICP iteration of every frame; the association is
    # written by each level's first K4 launch and never launched on its own;
    # K6 makes every coarser level of the model maps in one launch a frame;
    # fusion is K2 or B3a-c, in their bilinear branch (B11) with a threshold;
    # the dense layout raycasts with its march (K3; skip: B14a, B14b; hier:
    # K3 at stride 2, B14c; hier_skip: B14a, B14b at stride 2, B14c; hier2:
    # K3 at stride 4, B14c twice) and K5, the brick layout with B4 (B16 with
    # the first-event march; on a refresh frame B5a, B5b and B4 twice; skip
    # B5a, B5b; hier_skip B5a, B5b, B4; hier2_skip B5a, B5b, B4 twice) and,
    # with the secant2 refine, K5r; screen normals are B4n in K6's launch
    # (model_map_normals in place of resize_model_maps)
    iterations = sum(cfg.icp_iterations[: cfg.num_levels])
    dense_fused = 0 if brick else integrated
    brick_fused = integrated if brick else 0
    want = {k: n_frames for k in ("bilateral_filter", "depth_pyramid", "vertex_normal_maps")}
    want.update(icp_system=iterations * n_frames, icp_associate=0, fuse_volume=0 if bilinear else dense_fused,
                fuse_volume_bilinear=dense_fused if bilinear else 0)
    # B15: the classifier B3b, B15s (split) or B15f (fine, which wins), B15c with the subcell stage, and B3c's
    # variant: subcell, MIXED (split), or B3c itself (its bilinear branch with a threshold)
    fine = cfg.fusion_classify_fine
    split = cfg.fusion_classify_split and not fine
    subcell = cfg.fusion_subcell_cap > 0
    classifier = "classify_bricks_fine" if fine else ("classify_bricks_split" if split else "classify_bricks")
    fuse = ("fuse_bricks_subcell" if subcell else "fuse_bricks_mixed" if split
            else "fuse_bricks_bilinear" if bilinear else "fuse_bricks")
    want.update({k: brick_fused if k in (classifier, fuse) else 0
                 for k in ("classify_bricks", "classify_bricks_split", "classify_bricks_fine", "fuse_bricks",
                           "fuse_bricks_bilinear", "fuse_bricks_mixed", "fuse_bricks_subcell")})
    want.update(depth_mips=brick_fused, classify_subcells=brick_fused if subcell else 0)
    dense = 0 if bench else n_frames
    want.update(march_fixed=dense if march == "fixed" else 0, raycast_refine=dense,
                march_fixed_strided=dense if march in ("hier", "hier2") else 0,
                window_march_dense=dense * {"hier": 1, "hier_skip": 1, "hier2": 2}.get(march, 0))
    want.update({k: dense if march in ("skip", "hier_skip") else 0 for k in ("skip_field_dense", "march_skip_dense")})
    screen = cfg.raycast_normals == "screen"
    brick_march = {"fixed": "skip", "hier": "hier_skip", "hier2": "hier2_skip"}.get(march, march) if bench else None
    first_event = temporal and cfg.raycast_temporal_phase1 > 0 and not refresh
    windows = {"hier_skip": 1, "hier2_skip": 2, "temporal": 0 if first_event else 1}.get(brick_march, 0)
    windows = 2 if refresh else windows
    skips = refresh or brick_march in ("skip", "hier_skip", "hier2_skip")
    want.update(window_march=windows * n_frames, window_march_first_event=n_frames if first_event else 0,
                raycast_refine_bricks=n_frames if bench and cfg.raycast_refine == "secant2" else 0,
                model_map_normals=n_frames if screen else 0, resize_model_maps=0 if screen else n_frames)
    # B5b in its ray form where the skip march has many rays (the brick skip march's 240x320), else a warp a ray
    map_intr = cfg.intrinsics.level(L)
    skip_stride = rb.SKIP_STRIDE if refresh else {"skip": 1, "hier_skip": 2}.get(brick_march, rb.SKIP_STRIDE)
    ray_form = skips and raycast.skip_ray_form(kernels.strided(map_intr.height, skip_stride),
                                               kernels.strided(map_intr.width, skip_stride))
    want.update(skip_field=n_frames if skips else 0, march_skip=n_frames if skips and not ray_form else 0,
                march_skip_rays=n_frames if ray_form else 0)
    check(all(counts[k] == n for k, n in want.items()), f"launch counts {counts}, expected {want}")
    if brick:
        # the ACTIVE list never overflowed; with the dense layout the volume is dense fusion's bit for bit, so
        # the run is the first main path's to every digit
        check(all(a is not None and a <= cfg.fusion_brick_cap for a in active),
              f"brick fusion overflowed its cap {cfg.fusion_brick_cap}: ACTIVE bricks {active}")
    if b15 is not None:
        check(second_ate == ate and b15["poses_equal_to_reference"],
              f"{tag}: ATEs {ate!r} and {second_ate!r} m in two runs; poses equal to {b15['reference_run']}'s "
              f"{b15['poses_equal_to_reference']}")
    if bench:
        check(second_ate == ate, f"two runs of {tag} gave the ATEs {ate!r} and {second_ate!r} m")
        check(depth_at is None or device_depth_same,
              f"{tag}: frame {depth_at}'s pose from a depth on the card differs from the host depth's")
        check(not temporal or all(c >= cfg.raycast_temporal_min_coverage for c in coverage) != refresh,
              f"{tag}: anchor coverage {coverage} against {cfg.raycast_temporal_min_coverage}")
    elif brick and b15 is None:
        check(ate == ctx["ate"], f"brick fusion's ATE {ate!r} m differs from dense fusion's {ctx['ate']!r} m")
    elif tag == "main path":
        ctx["ate"] = ate
    check_frame_record(rec, attempts, iterations, FRAME_LAUNCHES[tag])
    if tag == "main path, bench":
        ctx["bench_run"] = (engine, state)  # the A12 phase's state, dropped there
    return counts


def consistent_record(record: dict, retake, retakes: int = PROFILE_RETAKES):
    """The first of ``record`` and up to ``retakes`` more (``retake()``
    profiles the next frame) whose device events are as many as the host's
    launch calls, else the last; and each attempt's two counts."""
    records = [record]
    while len(records[-1]["names"]) != records[-1]["host_calls"] and len(records) <= retakes:
        records.append(retake())
    attempts = [dict(device_launches=len(r["names"]), host_launch_calls=r["host_calls"]) for r in records]
    return records[-1], attempts


def icp_interlopers(names, icp_at) -> list:
    """The device work between a frame's first and last ICP launch."""
    loop = names[icp_at[0]: icp_at[-1] + 1] if icp_at else []
    return [name for name in loop if "icp_system_kernel" not in name]


def check_frame_record(rec: dict, attempts, iterations: int, want: int) -> None:
    """The profiled frame's checks: a consistent record (the profiler's
    device events trusted only where they are as many as the host's launch
    calls), one ICP launch an iteration with nothing else on the device
    between them, ``want`` launches in the frame, 3 in ``preprocess``."""
    names, icp_at, host_calls, stages = rec["names"], rec["icp_at"], rec["host_calls"], rec["stages"]
    check(len(names) == host_calls,
          f"no profiled frame gave a consistent record (device events, host launch calls): {attempts}")
    check(len(icp_at) > 0, f"the profiled frame shows no icp_system launch among {len(names)} device events")
    between = icp_interlopers(names, icp_at)
    # the loop on the card: one launch per iteration and nothing else on the device between them
    check(len(icp_at) == iterations and not between,
          f"the profiled frame ran {len(icp_at)} icp_system launches for {iterations} iterations, with other "
          f"device work between them: {between[:8]}")
    check(host_calls == want and stages.get("preprocess") == PREPROCESS_LAUNCHES,
          f"the profiled frame made {host_calls} launches ({want} expected; attempts {attempts}), "
          f"preprocess {stages.get('preprocess')} ({PREPROCESS_LAUNCHES} expected)")


def phase_main_path_fixed_assoc(ctx):
    return phase_main_path(ctx, "main path, fixed association")


def phase_main_path_brick(ctx):
    return phase_main_path(ctx, "main path, brick fusion")


def phase_main_path_bench(ctx):
    return phase_main_path(ctx, "main path, bench")


def _maps_equal(a, b) -> bool:
    return bool(torch.equal(torch.nan_to_num(a, nan=7.0), torch.nan_to_num(b, nan=7.0))) and same_nans(a, b)


def phase_a12(ctx):
    """The port's last modules on the bench run's final state and frames, on
    the card: ``export_model_maps_ply`` writes a point for each pixel whose
    level-0 maps are both numbers; ``export_current_maps_ply`` (K1, K7, K8)
    at levels 0 and 1, from a host depth and from a uint16 tensor on the
    card, gives the maps of the plain functions' composition on the card
    (``preprocess.bilateral_filter``, ``pyr_down``, ``create_vmap``,
    ``create_nmap``) bit for bit and the same file; ``Timer.lap_ms(sync=t)``
    after a device sleep of at least 20 ms reads at least the sleep, and
    without ``sync`` far less; ``assert_state_sane`` passes, and
    ``state_health`` on the card gives the names and numbers it gives on a
    CPU copy of the state."""
    import tempfile

    from xslam_tpu_torch.io.ply import export_ply, read_ply
    from xslam_tpu_torch.ops import kernels, preprocess
    from xslam_tpu_torch.utils import Timer
    from xslam_tpu_torch.utils.debug import assert_state_sane, state_health

    engine, state = ctx.pop("bench_run")
    dev = ctx["device"]
    depth_host = ctx["depths"][DEVICE_DEPTH_FRAME]
    depth_card = torch.as_tensor(np.asarray(depth_host, np.uint16)).to(dev)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.ply")
        engine.export_model_maps_ply(state, path, 0)
        points, _ = read_ply(path)
        valid = int((~torch.isnan(state.vmaps_prev[0].v[0]) & ~torch.isnan(state.nmaps_prev[0].v[0])).sum())
        out["model_maps_points"] = len(points)
        out["model_maps_valid_pixels"] = valid
        check(len(points) == valid > 1_000, f"the model maps' PLY holds {len(points)} points for {valid} valid pixels")

        for level, depth in ((0, depth_host), (1, depth_card)):
            kernels.reset_launch_counts()
            path = os.path.join(tmp, f"current{level}.ply")
            engine.export_current_maps_ply(depth, path, level)
            torch.cuda.synchronize()
            launched = {k: n for k, n in kernels.launch_counts.items() if n}
            # the same composition: the kernels' maps, then the plain functions' on the card
            d = kernels.depth_pyramid(kernels.bilateral_filter(depth_card), level + 1)[level]
            vk, nk = (m[0] for m in kernels.vertex_normal_pyramid([engine.intr.level(level)], [d]))
            p = preprocess.bilateral_filter(depth_card)
            for _ in range(level):
                p = preprocess.pyr_down(p)
            vp = preprocess.create_vmap(engine.intr.level(level), p)
            np_ = preprocess.create_nmap(vp)
            equal = _maps_equal(vk, vp) and _maps_equal(nk, np_)
            ok = ~torch.isnan(vp[0]) & ~torch.isnan(np_[0])
            ref = os.path.join(tmp, f"plain{level}.ply")
            export_ply(ref, vp[:, ok].T.cpu().numpy(), np_[:, ok].T.cpu().numpy())
            with open(path) as f, open(ref) as g:
                same_file = f.read() == g.read()
            out[f"current_maps_level{level}"] = dict(points=int(ok.sum()), maps_bit_equal=equal,
                                                     same_file=same_file, launches=launched,
                                                     depth="uint16 tensor on the card" if level else "host array")
            check(equal and same_file and int(ok.sum()) > 1_000,
                  f"export_current_maps_ply at level {level}: maps equal {equal}, file equal {same_file}")
            want = {"bilateral_filter": 1, "vertex_normal_maps": 1, **({"depth_pyramid": 1} if level else {})}
            check(launched == want, f"export_current_maps_ply at level {level} launched {launched}, not {want}")

    # Timer: a device sleep of 2 * HOLD_CYCLES, timed by CUDA events, against the host lap with and without sync
    timer = Timer()
    t = torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    timer.reset()
    start.record()
    torch.cuda._sleep(2 * HOLD_CYCLES)
    end.record()
    t.add_(1.0)
    synced = timer.lap_ms(sync=(t, {"state": [t]}))
    sleep_ms = start.elapsed_time(end)
    torch.cuda.synchronize()
    timer.reset()
    torch.cuda._sleep(2 * HOLD_CYCLES)
    unsynced = timer.lap_ms()
    torch.cuda.synchronize()
    out["timer"] = dict(sleep_ms=sleep_ms, lap_ms_sync=synced, lap_ms_no_sync=unsynced)
    check(sleep_ms >= 20.0 and synced >= sleep_ms and unsynced < sleep_ms / 2,
          f"Timer: a {sleep_ms} ms device sleep read {synced} ms with sync and {unsynced} ms without")

    # state_health on the card against a CPU copy of the state
    t0 = time.perf_counter()
    health = state_health(state)
    health_s = time.perf_counter() - t0
    cpu = state_health(_to_cpu(state))
    assert_state_sane(state)
    out["state_health"] = dict(leaves=len(health), seconds=health_s, names=sorted(health),
                               volume_value=health.get(".volume.value"))
    check(health == cpu and ".volume.value" in health and ".vmaps_prev[0].v" in health,
          f"state_health on the card {health} differs from the CPU copy's {cpu}")
    emit("A12", **out)
    return out


def _to_cpu(tree):
    """A nest of NamedTuples, tuples, lists and dicts with its tensors copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_cpu(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def phase_main_path_bench_refresh(ctx):
    return phase_main_path(ctx, "main path, bench refresh")


def phase_main_path_hier2(ctx):
    return phase_main_path(ctx, "main path, hier2")


def phase_main_path_skip(ctx):
    return phase_main_path(ctx, "main path, skip")


def phase_main_path_hier(ctx):
    return phase_main_path(ctx, "main path, hier")


def phase_main_path_hier_skip(ctx):
    return phase_main_path(ctx, "main path, hier_skip")


def phase_main_path_bench_bilinear(ctx):
    return phase_main_path(ctx, "main path, bench bilinear")


def phase_process_frames(ctx):
    """``process_frames`` and ``run_slam --scan`` on the card, in the path's
    own setting (hier2, screen normals, bilinear fusion): ``N_FRAMES_SCAN``
    frames in chunks of ``SCAN_CHUNK`` give the single calls' poses, flags,
    volume and model maps bit for bit, with the same launches; then
    ``run_slam.main`` over the same frames (rendered by the synthetic
    dataset) with ``--scan`` writes the per-frame loop's pose files byte for
    byte."""
    import dataclasses
    import tempfile

    import yaml

    from xslam_tpu_torch.io.options import HIER2_ARGS
    from xslam_tpu_torch.models.kinfu import XSlamEngine
    from xslam_tpu_torch.ops import kernels
    from xslam_tpu_torch.run_slam import main as run_slam_main
    from xslam_tpu_torch.utils.convert import frame_result_to_numpy

    cfg = dataclasses.replace(ctx["config"], **HIER2_OPTIONS, end_frame=N_FRAMES_SCAN)
    depths = ctx["depths"][:N_FRAMES_SCAN]
    kernels.reset_launch_counts()
    single = XSlamEngine(cfg, device=ctx["device"])
    state, results = single.init_state(), []
    for d in depths:
        state, res = single.process_frame(state, d)
        results.append(frame_result_to_numpy(res))
    torch.cuda.synchronize()
    loop_counts = dict(kernels.launch_counts)
    kernels.reset_launch_counts()
    chunked = XSlamEngine(cfg, device=ctx["device"])
    cstate, stacked = chunked.init_state(), []
    for at in range(0, N_FRAMES_SCAN, SCAN_CHUNK):
        cstate, res = chunked.process_frames(cstate, np.stack(depths[at:at + SCAN_CHUNK]))
        stacked.append(frame_result_to_numpy(res))
    torch.cuda.synchronize()
    chunk_counts = dict(kernels.launch_counts)
    results_equal = all(np.array_equal(np.concatenate([c[k] for c in stacked]), np.stack([r[k] for r in results]))
                        for k in results[0])
    state_equal = all(_bits(a, b) for a, b in zip(cstate.volume, state.volume)) and all(
        _bits(a.v, b.v) and _bits(a.g, b.g)
        for a, b in zip(cstate.vmaps_prev + cstate.nmaps_prev, state.vmaps_prev + state.nmaps_prev))

    with tempfile.TemporaryDirectory() as tmp:
        base = yaml.safe_load(open(os.path.join(ROOT, "configs", "synthetic.yaml")))
        files = {}
        for name, extra in (("loop", []), ("scan", ["--scan", str(SCAN_CHUNK)])):
            path = os.path.join(tmp, f"{name}.yaml")
            with open(path, "w") as f:
                yaml.safe_dump(dict(base, output_dir=os.path.join(tmp, name) + "/", draw_pcd=False), f)
            run_slam_main([path, "--frames", str(N_FRAMES_SCAN), *HIER2_ARGS, *extra])
            slam = os.path.join(tmp, name, "slam")
            files[name] = {fn: open(os.path.join(slam, fn), "rb").read() for fn in sorted(os.listdir(slam))}
    scan_equal = files["loop"] == files["scan"] and len(files["loop"]) == N_FRAMES_SCAN
    emit("process_frames", config="configs/synthetic.yaml", options=HIER2_OPTIONS, frames=N_FRAMES_SCAN,
         chunk=SCAN_CHUNK, results_bit_equal=results_equal, state_bit_equal=state_equal,
         launches_equal=loop_counts == chunk_counts, kernels=chunk_counts, run_slam_scan_pose_files_equal=scan_equal)
    check(results_equal and state_equal and loop_counts == chunk_counts,
          f"process_frames against the frame loop: results {results_equal}, state {state_equal}, launches "
          f"{loop_counts} / {chunk_counts}")
    check(scan_equal, f"run_slam --scan {SCAN_CHUNK} wrote other pose files than the per-frame loop")
    return chunk_counts


# ----------------------------------------------------------------------------
def _extract_bytes_ops(n_voxels: int, capacity: int, count: int):
    """B13's least work: both planes read once (8 B a voxel), the two buffers
    written once (24 B a row) and the count; ~10 operations an edge test
    (three a voxel) and ~300 a point's normal (six trilinears)."""
    return n_voxels * 8 + capacity * 24 + 4, n_voxels * 3 * 10 + count * 300


def _same_cloud(a, b) -> bool:
    return (int(a.count) == int(b.count) and bool(torch.equal(a.points, b.points))
            and bool(torch.equal(a.normals, b.normals)))


def phase_extract(ctx):
    """B13 against its plain version, bit for bit (count, points, normals,
    the zero rows past the count): on the smoke's fused 256^3 volume and on
    the dense twin of its brick rows (the layout's ``to_dense``, as
    ``engine.dense_volume`` makes it) and on a 201x203x205 crop of it (a
    ragged last tile; rows shorter than a round of B13's threads), at
    run_slam's capacity and at half the count (the overflow rows). Timed from
    prepared arguments, warm and cold."""
    from xslam_tpu_torch.ops import bricks, kernels
    from xslam_tpu_torch.ops.extract import extract_points, extract_points_plain, extract_scratch_ints
    from xslam_tpu_torch.ops.fusion import VolumeState

    eng, dev = ctx["engine_cfg"], ctx["device"]
    vol = ctx["volume"]
    twin = bricks.to_dense(bricks.from_dense(*vol), eng.resolution)
    crop = VolumeState(*(x[:201, :203, :205].contiguous() for x in vol))
    worst = 0.0
    for case, v in (("fused volume", vol), ("brick rows' dense twin", twin), ("crop 201x203x205", crop)):
        full = extract_points(v, eng, POINT_CAPACITY)
        n = int(full.count)
        for capacity in (POINT_CAPACITY, n // 2):
            k = full if capacity == POINT_CAPACITY else extract_points(v, eng, capacity)
            p = extract_points_plain(v, eng, capacity)
            torch.cuda.synchronize()
            equal = _same_cloud(k, p)
            err = max(max_abs(k.points, p.points), max_abs(k.normals, p.normals))
            worst = max(worst, err)
            zero_tail = not bool(k.points[int(k.count):].any()) and not bool(k.normals[int(k.count):].any())
            unit = float((torch.linalg.norm(k.normals[:int(k.count)], dim=1) - 1).abs().lt(1e-3).float().mean())
            emit("B13 extract_points", case=case, capacity=capacity, count=int(k.count), bit_equal=equal,
                 max_abs_err=err, zero_rows_past_count=zero_tail, unit_normal_fraction=unit)
            check(equal and zero_tail, f"B13 is not bit-equal to its plain version ({case}, capacity {capacity})")
            check(int(k.count) == min(n, capacity) and n > 1_000, f"B13 ({case}): count {int(k.count)} of {n}")
        check(_same_cloud(extract_points(v, eng, POINT_CAPACITY), full), f"B13 ({case}): a second launch differs")
    # the launch from prepared arguments, warm and cold, on the fused volume at run_slam's capacity
    X, Y, Z = vol.value.shape
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    points = torch.empty((POINT_CAPACITY, 3), dtype=torch.float32, device=dev)
    normals, count = torch.empty_like(points), torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(extract_scratch_ints(X * Y * Z), dtype=torch.int32, device=dev)
    args = (vol.value, vol.weight, scratch, points, normals, count, kernels.f32(eng.voxel_size),
            kernels.reciprocal_f32(eng.voxel_size), kernels.f32(0.5 * eng.voxel_size), stream)

    def launch():
        check(ext.extract_points(*args) == 0, "extract_points launch failed")

    ms, cold = time_ms(launch, 50), time_cold_ms(launch, 20)
    plain = time_ms(lambda: extract_points_plain(VolumeState(*vol), eng, POINT_CAPACITY), 3)
    n = int(count)
    bms, by = bound_ms(*_extract_bytes_ops(X * Y * Z, POINT_CAPACITY, n))
    # each of the launch's three kernels, by the profiler's device record over 20 launches
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            launch()
        torch.cuda.synchronize()
    split = {name: sum(e.device_time_total for e in prof.key_averages() if name in e.key) / 20 / 1e3
             for name in DEVICE_KERNELS["extract_points"]}
    emit("B13 extract_points timing", shape=[X, Y, Z], capacity=POINT_CAPACITY, count=n, ms=ms, cold_ms=cold,
         plain_ms=plain, bound_ms=bms, bound_by=by, bound_counts="planes once, buffers once, the edge tests and "
         "the normals' trilinears", kernel_ms=split, library_ms=None,
         library_note="no single PyTorch call computes it")
    return {"extract_points": dict(max_abs_err=worst, ms=ms, cold_ms=cold, plain_ms=plain, bound_ms=bms,
                                   bound_by=by, kernel_ms=split, count=n, capacity=POINT_CAPACITY)}


def _mesh_bytes_ops(kernel: str, shape, capacity: int, count: int):
    """B17's least work: both planes read once (8 B a voxel), the buffer
    written once (36 B a row) and the count; each cell's observed test and
    inside-codes, each triangle's vertices (``MESH_*_OPS``)."""
    X, Y, Z = shape
    cells = (X - 1) * (Y - 1) * (Z - 1)
    return X * Y * Z * 8 + capacity * 36 + 4, cells * (MESH_CELL_OPS + MESH_CODE_OPS[kernel]) + count * MESH_TRIANGLE_OPS


def _same_mesh(a, b) -> bool:
    return int(a.count) == int(b.count) and bool(torch.equal(a.vertices, b.vertices))


def phase_meshers(ctx):
    """B17t and B17m against their plain versions, bit for bit (count, every
    vertex, the zero rows past the count): on the fused 256^3 volume, the
    dense twin of its brick rows and the 201x203x205 crop (B13's three), at
    run_slam's capacity and at half the count, a second launch equal to the
    first. Timed from prepared arguments, warm and cold, on the fused volume
    at run_slam's capacity, beside the plain version and the bound."""
    from torch.profiler import ProfilerActivity, profile

    from xslam_tpu_torch.ops import bricks, extract, kernels
    from xslam_tpu_torch.ops.fusion import VolumeState

    eng, dev = ctx["engine_cfg"], ctx["device"]
    vol = ctx["volume"]
    twin = bricks.to_dense(bricks.from_dense(*vol), eng.resolution)
    crop = VolumeState(*(x[:201, :203, :205].contiguous() for x in vol))
    meshers = {"mesh_tetra": (extract.extract_mesh, extract.extract_mesh_plain),
               "mesh_mc": (extract.extract_mesh_mc, extract.extract_mesh_mc_plain)}
    out = {}
    for name, (kernel, plain) in meshers.items():
        worst = 0.0
        for case, v in (("fused volume", vol), ("brick rows' dense twin", twin), ("crop 201x203x205", crop)):
            full = kernel(v, eng, MESH_CAPACITY)
            n = int(full.count)
            for capacity in (MESH_CAPACITY, n // 2):
                k = full if capacity == MESH_CAPACITY else kernel(v, eng, capacity)
                p = plain(v, eng, capacity)
                torch.cuda.synchronize()
                equal = _same_mesh(k, p)
                err = max_abs(k.vertices, p.vertices)
                worst = max(worst, err)
                zero_tail = not bool(k.vertices[int(k.count):].any())
                emit(f"B17 {name}", case=case, capacity=capacity, count=int(k.count), plain_count=int(p.count),
                     bit_equal=equal, max_abs_err=err, zero_rows_past_count=zero_tail)
                check(equal and zero_tail, f"B17 {name} is not bit-equal to its plain version ({case}, capacity "
                                           f"{capacity})")
                check(int(k.count) == min(n, capacity) and n > 1_000, f"B17 {name} ({case}): count {int(k.count)} "
                                                                       f"of {n}")
                del k, p
            check(_same_mesh(kernel(v, eng, MESH_CAPACITY), full), f"B17 {name} ({case}): a second launch differs")
            del full

        # the launch from prepared arguments, warm and cold, on the fused volume at run_slam's capacity
        X, Y, Z = vol.value.shape
        mc = name == "mesh_mc"
        slots = extract._MC_TABLE.shape[1] if mc else 2 * len(extract._TETS)
        slab = MESH_SLAB if mc else X - 1
        ext = kernels.build_kernels()
        stream = torch.cuda.current_stream(dev).cuda_stream
        vertices = torch.empty((MESH_CAPACITY, 3, 3), dtype=torch.float32, device=dev)
        count = torch.empty((), dtype=torch.int32, device=dev)
        scratch = torch.empty(extract.mesh_scratch_ints((X, Y, Z), slots, slab), dtype=torch.int32, device=dev)
        table = torch.as_tensor(extract.mesh_table(mc)).to(dev)
        args = ((vol.value, vol.weight, table, scratch, vertices, count) + ((slab,) if mc else ())
                + (kernels.f32(eng.voxel_size), stream))
        fn = getattr(ext, name)

        def launch():
            check(fn(*args) == 0, f"{name} launch failed")

        ms, cold = time_ms(launch, 50), time_cold_ms(launch, 20)
        n = int(count)
        plain_ms = time_ms(lambda: plain(VolumeState(*vol), eng, MESH_CAPACITY), 2)
        bms, by = bound_ms(*_mesh_bytes_ops(name, (X, Y, Z), MESH_CAPACITY, n))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                launch()
            torch.cuda.synchronize()
        split = {k: sum(e.device_time_total for e in prof.key_averages() if k in e.key) / 20 / 1e3
                 for k in DEVICE_KERNELS[name]}
        emit(f"B17 {name} timing", shape=[X, Y, Z], capacity=MESH_CAPACITY, count=n, ms=ms, cold_ms=cold,
             plain_ms=plain_ms, bound_ms=bms, bound_by=by, bound_counts="planes once, the buffer once, the cells' "
             "observed tests and codes, the triangles' vertices", kernel_ms=split, library_ms=None,
             library_note="no single PyTorch call computes it")
        out[name] = dict(max_abs_err=worst, ms=ms, cold_ms=cold, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         kernel_ms=split, count=n, capacity=MESH_CAPACITY)
        del vertices, scratch
    return out


def _realistic_run(tmp: str, config: str, fmt: str, n_frames: int, extra=()):
    """Render ``n_frames`` of the realistic dataset with the port's generator,
    then run ``run_slam.main`` on a copy of ``config`` that reads it, with the
    launch counts set to 0 just before: the run, its stdout, its counts."""
    import contextlib
    import io

    import yaml

    from xslam_tpu_torch import run_slam
    from xslam_tpu_torch.apps import make_realistic_dataset
    from xslam_tpu_torch.ops import kernels

    data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        make_realistic_dataset.main([data, str(n_frames), "--format", fmt])
    render_s = time.perf_counter() - t0
    with open(os.path.join(ROOT, config)) as f:
        cfg = yaml.safe_load(f)
    cfg.update(dataset_dir=data, output_dir=out + "/", end_frame=n_frames)
    path = os.path.join(tmp, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    stdout = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        run = run_slam.main([path, *extra])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = dict(kernels.launch_counts)
    text = stdout.getvalue()
    slam = sorted(os.listdir(os.path.join(out, "slam")))
    gt = sorted(os.listdir(os.path.join(out, "gt")))
    info = dict(config=config, frames=n_frames, render_s=render_s, run_s=run_s, ate_m=run.ate,
                mean_frame_ms=float(text.split("mean frame time = ")[1].split(" ms")[0]),
                align_failed=text.count("align failed"), peak_mem_bytes=torch.cuda.max_memory_allocated(),
                pose_files=[len(slam), len(gt)], kernels=counts)
    check(slam == gt == [f"frame-{i:06d}.pose.txt" for i in range(n_frames)],
          f"{config}: pose files {len(slam)} / {len(gt)} for {n_frames} frames")
    check(run.ate < 0.02, f"{config}: ATE {run.ate} m >= 0.02 m")
    return run, text, counts, out, info


def phase_main_path_icl(ctx):
    """``run_slam.main`` on configs/ICL_realistic.yaml's configuration over 30
    frames the port's generator renders (PNGs through the port's own codec
    and ``ICLDataset``), with ``--mesh tetra``: every pose file, ATE < 0.02 m,
    B13 launched exactly once for ``draw_pcd``, ``pcd.ply`` read back with
    B13's count, the plain extraction of the final volume equal to B13's,
    B17t launched exactly once for ``--mesh tetra`` (timed in the run) and
    ``mesh.ply`` with its triangles; on the final volume B17t, the plain
    tetrahedra, B17m (one ``--mesh mc`` call) and the plain marching cubes,
    each timed with its peak memory, the kernels' meshes the plain ones bit
    for bit; and a checkpoint after 15 frames, loaded and run to the end,
    giving the run's poses bit for bit."""
    import tempfile

    from xslam_tpu_torch.io.dataset import ICLDataset
    from xslam_tpu_torch.io.ply import read_ply
    from xslam_tpu_torch.models.kinfu import XSlamEngine
    from xslam_tpu_torch.ops.extract import (extract_mesh, extract_mesh_mc, extract_mesh_mc_plain, extract_mesh_plain,
                                             extract_points, extract_points_plain)
    from xslam_tpu_torch.utils import checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        run, text, counts, out, info = _realistic_run(tmp, "configs/ICL_realistic.yaml", "icl", N_FRAMES_ICL,
                                                      ("--mesh", "tetra"))
        engine, state = run.engine, run.state
        n = int(text.split("exported ")[1].split(" points")[0])
        k = int(text.split(" tetra triangles")[0].split("exported ")[-1])
        mesh_s = float(text.split(" tetra triangles (")[1].split(" s)")[0])
        points, normals = read_ply(os.path.join(out, "pcd.ply"))
        with open(os.path.join(out, "mesh.ply")) as f:
            mesh_head = f.read(400)
        check(counts["extract_points"] == 1, f"the ICL run launched B13 {counts['extract_points']} times")
        check(counts["mesh_tetra"] == 1 and counts["mesh_mc"] == 0,
              f"the ICL run (--mesh tetra) launched B17t {counts['mesh_tetra']} and B17m {counts['mesh_mc']} times")
        check(len(points) == n > 5_000 and f"element face {k}\n" in mesh_head and k > 0,
              f"pcd.ply holds {len(points)} points for B13's {n}; mesh.ply's head {mesh_head[:200]!r} for {k}")
        iterations = sum(engine.config.icp_iterations[: engine.config.num_levels])
        for name, want in (("bilateral_filter", N_FRAMES_ICL), ("icp_system", iterations * N_FRAMES_ICL),
                           ("model_map_normals", N_FRAMES_ICL), ("window_march", N_FRAMES_ICL),
                           ("fuse_bricks", 1)):
            check(counts[name] >= want, f"the ICL run launched {name} {counts[name]} times ({want} at least)")

        # the final volume: B13 (a comparison launch, not counted) against the plain extraction
        dense = engine.dense_volume(state)
        kernel, plain = extract_points(dense, engine.vol_cfg, POINT_CAPACITY), extract_points_plain(
            dense, engine.vol_cfg, POINT_CAPACITY)
        same = _same_cloud(kernel, plain) and int(kernel.count) == n
        check(same, f"B13 on the run's final volume differs from the plain extraction (count {int(kernel.count)})")
        del kernel, plain
        # the meshers on the final volume, each timed once on the host's clock with its peak memory: B17t (a
        # comparison launch, not counted) against run_slam's count and the plain version, then one --mesh mc
        # call, B17m, against the plain marching cubes
        meshes = {}
        for tag, mesher in (("tetra", extract_mesh), ("tetra plain", extract_mesh_plain), ("mc", extract_mesh_mc),
                            ("mc plain", extract_mesh_mc_plain)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            mesh = mesher(dense, engine.vol_cfg, capacity=MESH_CAPACITY)
            got = int(mesh.count)
            meshes[tag] = dict(triangles=got, s=time.perf_counter() - t0,
                               peak_mem_bytes=torch.cuda.max_memory_allocated() - base, mesh=mesh)
        same_tetra = _same_mesh(meshes["tetra"].pop("mesh"), meshes["tetra plain"].pop("mesh"))
        same_mc = _same_mesh(meshes["mc"].pop("mesh"), meshes["mc plain"].pop("mesh"))
        check(meshes["tetra"]["triangles"] == k and same_tetra,
              f"B17t on the final volume gives {meshes['tetra']['triangles']} triangles (run_slam wrote {k}; bits "
              f"equal to the plain version: {same_tetra})")
        check(meshes["mc"]["triangles"] == meshes["mc plain"]["triangles"] > 0 and same_mc,
              f"B17m on the final volume gives {meshes['mc']['triangles']} triangles, the plain marching cubes "
              f"{meshes['mc plain']['triangles']} (bits equal: {same_mc})")

        # a checkpoint after CHECKPOINT_AT frames, loaded into a new engine and run to the end
        ds = ICLDataset(os.path.join(tmp, "data"), 0, N_FRAMES_ICL)
        first = XSlamEngine(engine.config, device=ctx["device"])
        s = first.init_state()
        for i in range(CHECKPOINT_AT):
            s, r = first.process_frame(s, ds.get_depth(i))
            first.log_pose(r)
        path = os.path.join(tmp, "checkpoint.npz")
        checkpoint.save_state(path, s, first.pose_log)
        resumed = XSlamEngine(engine.config, device=ctx["device"])
        s, resumed.pose_log = checkpoint.load_state(path, device=ctx["device"])
        for i in range(CHECKPOINT_AT, N_FRAMES_ICL):
            s, r = resumed.process_frame(s, ds.get_depth(i))
            resumed.log_pose(r)
        resume_same = len(resumed.pose_log) == N_FRAMES_ICL and all(
            a.tobytes() == b.tobytes() for a, b in zip(resumed.pose_log, engine.pose_log))
    emit("main path, ICL realistic", **info, points=n, unit_normal_fraction=float(
        (np.abs(np.linalg.norm(normals, axis=1) - 1) < 1e-3).mean()), b13_equals_plain_on_final_volume=same,
         mesh_triangles=k, mesh_s_in_run=mesh_s, meshers_on_final_volume=meshes,
         checkpoint_after_frames=CHECKPOINT_AT, resumed_poses_bit_equal=resume_same)
    check(resume_same, f"the run resumed from a checkpoint after {CHECKPOINT_AT} frames differs from the "
                       "uninterrupted run's poses")
    return counts


def phase_main_path_7scenes(ctx):
    """``run_slam.main`` on configs/7scenes_realistic.yaml's configuration over
    10 frames the port's generator renders (``SevenScenesDataset`` through
    its info file), with ``--mesh mc``: every pose file and ATE < 0.02 m,
    B17m launched exactly once (timed in the run), ``mesh.ply`` with as many
    triangles as the plain marching cubes of the final volume."""
    import tempfile

    from xslam_tpu_torch.ops.extract import extract_mesh_mc_plain

    with tempfile.TemporaryDirectory() as tmp:
        run, text, counts, out, info = _realistic_run(tmp, "configs/7scenes_realistic.yaml", "7scenes",
                                                      N_FRAMES_7SCENES, ("--mesh", "mc"))
        k = int(text.split(" mc triangles")[0].split("exported ")[-1])
        mesh_s = float(text.split(" mc triangles (")[1].split(" s)")[0])
        with open(os.path.join(out, "mesh.ply")) as f:
            mesh_head = f.read(400)
        plain = int(extract_mesh_mc_plain(run.engine.dense_volume(run.state), run.engine.vol_cfg, MESH_CAPACITY).count)
    emit("main path, 7-Scenes realistic", **info, mesh_triangles=k, mesh_s_in_run=mesh_s, plain_mc_triangles=plain)
    check(counts["bilateral_filter"] == N_FRAMES_7SCENES and counts["extract_points"] == 0
          and counts["mesh_mc"] == 1 and counts["mesh_tetra"] == 0, f"the 7-Scenes run's launches: {counts}")
    check(k == plain > 0 and f"element face {k}\n" in mesh_head,
          f"the 7-Scenes run wrote {k} mc triangles, the plain marching cubes of its volume has {plain}")
    return counts


# ---------------------------------------------------------------- the backend configs
class BackendProbe:
    """Times and counts the backend's calls during a run: the names that
    ``models/recovery.py`` calls (``relocalize``, ``_depth_icp``,
    ``pose_graph_cg``, ``build_ba_problem``, ``schur_ba_cg``) and
    ``RecoveringEngine._recover`` and ``refine_trajectory`` are wrapped on
    entry and restored on exit. Device work is synchronized at each end, so
    each time is the call's own. The wrappers change no result."""

    NAMES = ("relocalize", "_depth_icp", "pose_graph_cg", "build_ba_problem", "schur_ba_cg")

    def __enter__(self):
        from xslam_tpu_torch.models import recovery
        from xslam_tpu_torch.ops import kernels

        self.module, self.counts = recovery, kernels.launch_counts
        self.calls = {name: [] for name in self.NAMES}  # (seconds, what the call tells)
        self.recovers, self.refined, self.last = [], [], {}
        self.saved = {name: getattr(recovery, name) for name in self.NAMES}
        self.saved_methods = {name: getattr(recovery.RecoveringEngine, name)
                              for name in ("_recover", "refine_trajectory")}
        for name in self.NAMES:
            setattr(recovery, name, self._timed(name, self.saved[name]))
        recovery.RecoveringEngine._recover = lambda engine, *args: self._recover(engine, *args)
        recovery.RecoveringEngine.refine_trajectory = lambda engine, *args, **kw: self._refine(engine, *args, **kw)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)
        for name, fn in self.saved_methods.items():
            setattr(self.module.RecoveringEngine, name, fn)
        return False

    def _timed(self, name, fn):
        def call(*args, **kwargs):
            b12, band = self.counts["tsdf_loss"], self.counts["tsdf_band"]
            b18 = self.counts["schur_cg_anchors"], self.counts["schur_cg_keyframes"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            info = {}
            if name == "relocalize":
                info = dict(b12=self.counts["tsdf_loss"] - b12, band=self.counts["tsdf_band"] - band,
                            iters=kwargs["iters"])
            elif name == "build_ba_problem":
                info = dict(stride=kwargs.get("stride"), N=0 if out[0] is None else int(out[0].frame_idx.shape[0]),
                            L=0 if out[1] is None else int(out[1].shape[0]))
            elif name == "schur_ba_cg":
                info = dict(N=int(args[2].frame_idx.shape[0]), L=int(args[1].shape[0]),
                            b18=[self.counts["schur_cg_anchors"] - b18[0],
                                 self.counts["schur_cg_keyframes"] - b18[1]],
                            cg_steps=kwargs["iters"] * kwargs["cg_iters"])
            self.calls[name].append((seconds, info))
            self.last[name] = (fn, args, kwargs, out)
            return out

        return call

    def _recover(self, engine, state, depth, failed):
        before = {k: self.counts[k] for k in ("skip_field", "march_skip")}
        out = self.saved_methods["_recover"](engine, state, depth, failed)
        event, result = engine.recovery_events[-1], out[1]
        self.recovers.append(dict(
            frame=event.frame_index, accepted=event.accepted, reentered=result is not failed,
            skip_field=self.counts["skip_field"] - before["skip_field"],
            march_skip=self.counts["march_skip"] - before["march_skip"],
            anchor_coverage=None if result.anchor_coverage is None or result is failed
            else float(result.anchor_coverage)))
        return out

    def _refine(self, engine, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.saved_methods["refine_trajectory"](engine, *args, **kwargs)
        self.refined.append((time.perf_counter() - t0, out))
        return out

    def seconds(self, name) -> float:
        return float(sum(s for s, _ in self.calls[name]))


def parse_backend_stdout(text: str) -> dict:
    """What ``run_slam.main`` printed on a backend config: the frames that
    failed to align, the mean frame ms, the ATE and the refined ATE with
    its keyframes and loop closures (None where a line is missing), and
    whether the refinement failed."""
    def number(after, upto=" "):
        return float(text.split(after)[1].split(upto)[0]) if after in text else None

    refined = re.search(r"refined ATE RMSE = (\S+) m \((\d+) keyframes, (\d+) loop closures\)", text)
    return dict(align_failed=[int(m) for m in re.findall(r"^frame (\d+): align failed!", text, re.M)],
                mean_frame_ms=number("mean frame time = "), ate_m=number("ATE RMSE = "),
                refined_ate_m=float(refined.group(1)) if refined else None,
                keyframes=int(refined.group(2)) if refined else None,
                loops=int(refined.group(3)) if refined else None,
                refinement_failed="backend refinement FAILED" in text)


def _backend_data(ctx) -> str:
    """The three backend phases' datasets, rendered once by the port's
    generator in three processes side by side (the phases wait for all
    three, so no render runs beside a timed run): the directory that holds
    them. Every process is waited for, or killed."""
    if "backend_data" not in ctx:
        import tempfile

        tmp = tempfile.mkdtemp(prefix="chip_smoke_backend_")
        t0 = time.perf_counter()
        procs = {tag: subprocess.Popen([sys.executable, "-m", "xslam_tpu_torch.apps.make_realistic_dataset",
                                        os.path.join(tmp, tag), str(n), *args], cwd=ROOT,
                                       stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
                 for tag, (_, n, args) in BACKEND_RUNS.items()}
        try:
            for tag, proc in procs.items():
                _, err = proc.communicate(timeout=RENDER_TIMEOUT_S)
                check(proc.returncode == 0, f"rendering the {tag} data failed: {err[-2000:]}")
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        ctx["backend_data"] = tmp
        emit("backend data", render_s=time.perf_counter() - t0,
             frames={tag: n for tag, (_, n, _) in BACKEND_RUNS.items()})
    return ctx["backend_data"]


def backend_run(tag: str, data_root: str, n_frames: int, device_card: str, extra=(), out_tag=None):
    """``run_slam.main`` on a copy of ``BACKEND_RUNS[tag]``'s config that
    reads ``<data_root>/<tag>`` and writes ``<data_root>/<out_tag>_out``
    (``out_tag`` defaults to ``tag``), with ``--frames n_frames`` and the
    ``extra`` arguments, under a :class:`BackendProbe`, the launch counts
    set to 0 just before: ``(run, the parsed stdout, the probe, info)``,
    info holding what the phase prints."""
    import contextlib
    import io

    import yaml

    from xslam_tpu_torch import run_slam
    from xslam_tpu_torch.ops import kernels

    config = BACKEND_RUNS[tag][0]
    with open(os.path.join(ROOT, config)) as f:
        cfg = yaml.safe_load(f)
    out_tag = out_tag or tag
    out = os.path.join(data_root, f"{out_tag}_out")
    cfg.update(dataset_dir=os.path.join(data_root, tag), output_dir=out + "/")
    path = os.path.join(data_root, f"{out_tag}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    stdout = io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with BackendProbe() as probe, contextlib.redirect_stdout(stdout):
        run = run_slam.main([path, "--frames", str(n_frames), *extra])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    parsed = parse_backend_stdout(stdout.getvalue())
    refine_s = probe.refined[0][0] if probe.refined else None
    reloc = probe.calls["relocalize"]
    info = dict(config=config, frames=n_frames, options=list(extra), card=device_card, run_s=run_s, **parsed,
                relocalize_calls=len(reloc), relocalize_s=probe.seconds("relocalize"),
                relocalize_b12_launches=[c["b12"] for _, c in reloc],
                relocalize_band_launches=[c["band"] for _, c in reloc],
                depth_icp_calls=len(probe.calls["_depth_icp"]), depth_icp_s=probe.seconds("_depth_icp"),
                recoveries=probe.recovers, recovery_events=[e._asdict() for e in run.engine.recovery_events],
                refine_trajectory_s=refine_s, pose_graph_cg_s=probe.seconds("pose_graph_cg"),
                build_ba_problem_s=probe.seconds("build_ba_problem"), schur_ba_cg_s=probe.seconds("schur_ba_cg"),
                schur_ba_cg_share_of_run=probe.seconds("schur_ba_cg") / run_s,
                build_ba_problem_calls=[c for _, c in probe.calls["build_ba_problem"]],
                schur_ba_cg_rounds=[dict(seconds=s, **c) for s, c in probe.calls["schur_ba_cg"]],
                kernels={k: v for k, v in kernels.launch_counts.items() if v})
    if "schur_ba_cg" in probe.last:
        fn, args, kwargs, _ = probe.last["schur_ba_cg"]
        fn(*args, **kwargs)
        rec = _profiled_call(lambda: fn(*args, **kwargs))
        info["schur_ba_cg_profiled"] = {k: rec[k] for k in ("wall_ms", "device_busy_ms", "device_events",
                                                           "host_calls")}
    return run, parsed, probe, info


def _check_backend_common(tag: str, run, parsed: dict, probe, n_frames: int, data_root: str, out_tag=None):
    """What every backend phase holds: the ATE and the refined line printed,
    no refinement failure, a refined pose file a frame, each relocalize call
    ``2 * reloc_iters + 2`` B12 launches and one of its band pass, and the
    refinement's ``schur_ba_cg`` calls (at least one) each B18 pass once a CG
    step (``iters * cg_iters`` launches a pass)."""
    check(parsed["ate_m"] is not None and parsed["refined_ate_m"] is not None and not parsed["refinement_failed"],
          f"{tag}: ATE {parsed['ate_m']}, refined ATE {parsed['refined_ate_m']}, failed "
          f"{parsed['refinement_failed']}")
    refined_dir = os.path.join(data_root, f"{out_tag or tag}_out", "slam_refined")
    files = sorted(os.listdir(refined_dir)) if os.path.isdir(refined_dir) else []
    check(files == [f"frame-{i:06d}.pose.txt" for i in range(n_frames)],
          f"{tag}: {len(files)} refined pose files for {n_frames} frames")
    want = 2 * run.engine.config.reloc_iters + 2
    bad = [(c["b12"], c["band"]) for _, c in probe.calls["relocalize"] if (c["b12"], c["band"]) != (want, 1)]
    check(not bad, f"{tag}: relocalize calls launched B12 and its band pass {bad} times ({want} and 1 a call)")
    cg = [c for _, c in probe.calls["schur_ba_cg"]]
    check(cg and all(c["b18"] == [c["cg_steps"]] * 2 for c in cg),
          f"{tag}: schur_ba_cg calls launched B18's passes {[(c['b18'], c['cg_steps']) for c in cg]} times "
          f"(once a CG step each)")


def phase_backend_blackout(ctx):
    """configs/ICL_blackout.yaml over 60 frames rendered with ``--blackout
    30 40``: the 10 blank frames fail to align; after them a relocalization
    passes its gate and its frame re-enters the tracked step at the
    relocalized pose, and every later frame aligns; B12 launches ``2 *
    reloc_iters + 2`` times a relocalize call; the ATE and the refined ATE
    below 0.05 m; a refined pose file a frame. Whether the re-entered frame
    aligned (its event's ``accepted``) and whether it launched B5a and B5b
    (the ``hier2`` refresh) is recorded, not checked."""
    t0 = time.perf_counter()
    root = _backend_data(ctx)
    n = BACKEND_RUNS["blackout"][1]
    run, parsed, probe, info = backend_run("blackout", root, n, ctx["card"])
    ctx["backend_blackout_run"] = (run.ate, run.refined_ate, list(run.engine.recovery_events),
                                   [k.frame_index for k in run.engine.keyframes], info)
    events = run.engine.recovery_events
    # the relocalizations after the blackout whose candidate passed the gate, so that their frame re-entered the
    # tracked step at the relocalized pose; `accepted` is whether that re-entry aligned (against the model maps
    # rendered at the frozen pose: the JAX package's frame 160 fails it too, BASELINE.md:665-672)
    reentered = [r for r in probe.recovers if r["reentered"]]
    after = [r["frame"] for r in reentered if r["frame"] >= BLACKOUT[1]]
    tracked_after = after and all(f not in parsed["align_failed"] for f in range(after[0] + 1, n))
    info.update(reentered_after_blackout=after, accepted_after_blackout=[
        e.frame_index for e in events if e.accepted and e.frame_index >= BLACKOUT[1]],
                tracked_after_reentry=bool(tracked_after), reentered_frames=reentered,
                reentry_launched_b5=any(r["skip_field"] and r["march_skip"] for r in reentered),
                tsdf_loss_launches=info["kernels"].get("tsdf_loss", 0),
                tsdf_band_launches=info["kernels"].get("tsdf_band", 0), phase_s=time.perf_counter() - t0)
    emit("backend, blackout", **info)
    ctx["backend_b12"] = dict(backend_blackout_relocalize_calls=info["relocalize_calls"],
                              backend_blackout_launches=info["tsdf_loss_launches"])
    ctx["backend_band"] = dict(backend_blackout_relocalize_calls=info["relocalize_calls"],
                               backend_blackout_launches=info["tsdf_band_launches"])
    _check_backend_common("blackout", run, parsed, probe, n, root)
    check(set(range(*BLACKOUT)) <= set(parsed["align_failed"]),
          f"blackout: frames {list(range(*BLACKOUT))} should fail to align, failed {parsed['align_failed']}")
    check(tracked_after, f"blackout: no relocalization after frame {BLACKOUT[1]} re-entered its frame with every "
                         f"later frame aligned: events {events}, failed frames {parsed['align_failed']}")
    check(info["tsdf_loss_launches"] == sum(info["relocalize_b12_launches"]) and
          info["tsdf_band_launches"] == info["relocalize_calls"],
          f"blackout: B12 launched {info['tsdf_loss_launches']} times, its relocalize calls "
          f"{info['relocalize_b12_launches']}; its band pass {info['tsdf_band_launches']} times")
    check(parsed["ate_m"] < 0.05 and parsed["refined_ate_m"] < 0.05,
          f"blackout: ATE {parsed['ate_m']} m, refined {parsed['refined_ate_m']} m (0.05 m)")
    return info


def phase_backend_loop(ctx):
    """configs/ICL_loop_backend.yaml on a ``--revisit`` cut (noise 0.004):
    at least one verified loop edge, the refined line, finite BA residuals;
    ``refine_trajectory()`` again on the run's engine gives the CLI's
    refined poses bit for bit; ``pose_graph_cg`` and ``schur_ba_cg`` again
    on their last inputs under ``torch.cuda.set_sync_debug_mode("error")``
    (no host read) give their first results bit for bit."""
    t0 = time.perf_counter()
    root = _backend_data(ctx)
    n = BACKEND_RUNS["loop"][1]
    run, parsed, probe, info = backend_run("loop", root, n, ctx["card"])
    engine = run.engine
    residuals = getattr(engine, "last_ba_residuals", None)
    first = probe.refined[0][1] if probe.refined else None
    again = engine.refine_trajectory()
    same = first is not None and again.tobytes() == first.tobytes()
    quiet, equal = None, {}
    if "pose_graph_cg" in probe.last and "schur_ba_cg" in probe.last:
        torch.cuda.synchronize()
        outs = {}
        torch.cuda.set_sync_debug_mode("error")
        try:
            for name in ("pose_graph_cg", "schur_ba_cg"):
                fn, args, kwargs, _ = probe.last[name]
                outs[name] = fn(*args, **kwargs)
            quiet = True
        except RuntimeError as e:
            quiet = f"{type(e).__name__}: {e}"
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        equal = {name: all(torch.equal(a, b) for a, b in zip(out, probe.last[name][3])) for name, out in outs.items()}
    info.update(loop_edges=[(i, j) for i, j, _ in engine.loop_edges],
                ba_residuals=None if residuals is None else residuals.tolist(),
                refine_again_bit_equal=same, no_sync_under_debug_mode=quiet, rerun_bit_equal=equal,
                phase_s=time.perf_counter() - t0)
    emit("backend, loop", **info)
    _check_backend_common("loop", run, parsed, probe, n, root)
    check(engine.loop_edges, f"loop: no loop edge over the {n}-frame revisit cut")
    check(residuals is not None and np.isfinite(residuals).all(), f"loop: BA residuals {residuals}")
    check(same, "loop: a second refine_trajectory() differs from the CLI's refined poses")
    check(quiet is True, f"loop: pose_graph_cg / schur_ba_cg read the host under sync debug mode: {quiet}")
    check(equal and all(equal.values()), f"loop: the backend's solvers gave other bits on their inputs: {equal}")
    return info


def phase_backend_realistic(ctx):
    """configs/ICL_realistic_backend.yaml over 30 frames: no align failure, at
    least 2 keyframes, the refined line."""
    t0 = time.perf_counter()
    root = _backend_data(ctx)
    n = BACKEND_RUNS["realistic"][1]
    run, parsed, probe, info = backend_run("realistic", root, n, ctx["card"])
    info.update(phase_s=time.perf_counter() - t0)
    emit("backend, realistic", **info)
    _check_backend_common("realistic", run, parsed, probe, n, root)
    check(not parsed["align_failed"], f"realistic: frames failed to align: {parsed['align_failed']}")
    check(len(run.engine.keyframes) >= 2, f"realistic: {len(run.engine.keyframes)} keyframes")
    return info


# ------------------------------------------------------------------------- B19 and the sharded engine
SLAB_RANKS = 2  # the B19 phase's split of the volume's X into slabs, as two ranks hold it


def _slab_rows(plane: torch.Tensor, k: int, h: int = 0, ranks: int = SLAB_RANKS) -> torch.Tensor:
    """Rows [k * local - h, (k + 1) * local + h) of an (X, Y, Z) plane for
    slab k of ``ranks``, wrapping at the volume's ends as the ranks' ring
    does: a slab with its halo."""
    X = plane.shape[0]
    local = X // ranks
    rows = torch.arange(k * local - h, (k + 1) * local + h, device=plane.device) % X
    return plane.index_select(0, rows).contiguous()


def _bits_all(a, b) -> bool:
    return all(bool(torch.equal(x.view(torch.int32), y.view(torch.int32))) for x, y in zip(a, b))


def _b19b_designs(ctx, rpose, ray_start, ray_dir) -> dict:
    """B19b, K3 over a slab marching only the steps the slab can own,
    against its earlier design (the full loop, ``ext.march_fixed_shard_full``)
    bit for bit on each slab of a 2- and a 4-rank split (with the halo) and
    at one rank (the whole volume, no halo, as ``sharded_raycast`` places
    it); each timed warm in turns (full loop, slab steps, slab steps, full
    loop) and cold."""
    from xslam_tpu_torch.ops import kernels, raycast
    from xslam_tpu_torch.parallel.sharded import halo_width

    eng, intr, dev = ctx["engine_cfg"], ctx["config"].intrinsics, ctx["device"]
    value = ctx["volume"].value
    X = value.shape[0]
    ext = kernels.build_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    f32 = kernels.f32
    full_args = (kernels.march_steps(eng.trunc_dist), f32(eng.voxel_size), f32(eng.trunc_dist * 0.8),
                 *kernels.camera_args(intr))
    rows, equal = [], True
    for ranks in (1, 2, 4):
        local = X // ranks
        h = halo_width(eng, local) if ranks > 1 else 0
        for k in range(ranks):
            spec = raycast.ShardSpec(x_base=k * local - h, x_total=X, core_start=k * local, core_end=(k + 1) * local)
            plane = _slab_rows(value, k, h, ranks) if ranks > 1 else value
            slab = list(kernels.resolve_spec(spec, plane.shape[0]))
            of = torch.empty((intr.height, intr.width), dtype=torch.float32, device=dev)
            od = torch.empty_like(of)

            def run_new(plane=plane, spec=spec):
                return kernels.march_fixed(plane, rpose, intr, eng.voxel_size, eng.trunc_dist, spec=spec)

            def run_full(plane=plane, slab=slab, of=of, od=od):
                check(ext.march_fixed_shard_full(plane, rpose, of, od, *full_args, slab, stream) == 0,
                      "march_fixed_shard_full failed")

            nf, nd = run_new()
            run_full()
            torch.cuda.synchronize()
            bits = _bits(nf, of) and _bits(nd, od)
            equal = equal and bits
            turns = [time_ms(fn, 50) for fn in (run_full, run_new, run_new, run_full)]
            cold = [time_cold_ms(fn, 30) for fn in (run_full, run_new)]
            n_bytes, n_ops, samples = _march_bytes_ops(value, ray_start.v, ray_dir.v, nf, nd, eng,
                                                       rows=(spec.x_base, spec.x_base + plane.shape[0]),
                                                       core=(spec.core_start, spec.core_end))
            bound = bound_ms(n_bytes, n_ops)
            row = dict(ranks=ranks, slab=k, halo=h, rows=plane.shape[0], bit_equal_to_full_loop=bits,
                       full_loop_ms=[turns[0], turns[3]], slab_steps_ms=[turns[1], turns[2]],
                       full_loop_cold_ms=cold[0], slab_steps_cold_ms=cold[1], owned_samples=samples,
                       bound_ms=bound[0], bound_by=bound[1],
                       owned_crossings=int((nf < kernels.INF_T).sum()))
            emit("B19b designs", **row)
            rows.append(row)
    check(equal, "B19b: the slab-step march is not the full loop's bits on every slab")
    return dict(designs=rows)


def phase_b19(ctx):
    """B19, the sharded engine's slab hooks, each against its plain version
    on the card at the main path's shapes (the fused 256^3 volume, the
    orbit's frame 3, 480x640 rays): at its defaults (the whole volume: the
    same bits as without the hook), then on both slabs of a 2-rank split
    (128 rows; for the raycast a halo of ``halo_width`` rows, wrapping as
    the ring does). B19a: K2 with the slab's ``x_offset``, B3b and B3c (and
    the split, fine and subcell variants) bit for bit, B3c's slab volume
    K2's whole-volume rows bit for bit. B19b, B19c: K3 with the slab's
    ``ShardSpec`` on >= 99.9% of the rays (phase_march's criterion: the
    plain floor divides by a multiply) and K5's shard mode bit for bit; the
    two slabs' K3 minima
    and K5 planes, summed and finalized (K5's finalize against
    ``finalize_maps``) in one process, against the whole volume's K3 and K5:
    the differing pixels are counted, the maps must be equal (value and NaN
    masks; the bits of a -0 that the sum makes +0 are counted). B19d: K4's
    tail launched over the totals that the whole image's system launch
    writes, against the fused launch bit for bit, and over two column
    blocks' summed totals against ``icp_step_plain`` on its own system
    (``_check_tail``'s tolerances). Each hook timed beside its plain
    version, with its bound."""
    import dataclasses

    from xslam_tpu_torch.csfd.single import CSFD
    from xslam_tpu_torch.geometry import se3
    from xslam_tpu_torch.ops import fusion, icp, kernels, raycast
    from xslam_tpu_torch.ops import fusion_brick as fb
    from xslam_tpu_torch.ops.kernels import INF_T
    from xslam_tpu_torch.parallel.sharded import halo_width

    cfg, eng, dev = ctx["config"], ctx["engine_cfg"], ctx["device"]
    vol, intr = ctx["volume"], cfg.intrinsics
    X, Y, Z = eng.resolution
    local = X // SLAB_RANKS
    lcfg = dataclasses.replace(eng, resolution=(local, Y, Z))
    out = {}

    # ---- B19a: fusion at the orbit's frame 3
    _, v2c, depth_u16 = ctx["fusion_cases"][0]
    r, t = se3.rotation(v2c), se3.translation(v2c)
    depth_m = fusion.scale_depth(torch.as_tensor(depth_u16, device=dev))
    fargs = (depth_m, r, t, intr, eng.voxel_size, eng.trunc_dist, eng.max_weight)
    whole = [x.clone() for x in vol]
    at_zero = [x.clone() for x in vol]
    kernels.fuse_volume(*whole, *fargs)
    kernels.fuse_volume(*at_zero, *fargs, 0.0, 0)
    defaults = dict(k2_x_offset_0=_bits_all(whole, at_zero))
    del at_zero
    table, pose = fb.depth_mips(depth_m), kernels.fusion_pose(r, t)
    n_slab = local * Y * Z // fb.BRICK ** 3
    k2_rows, brick_rows, slab_rows = [], [], []
    for k in range(SLAB_RANKS):
        off = k * local
        slab = [_slab_rows(x, k) for x in vol]
        ks, ps = [x.clone() for x in slab], [x.clone() for x in slab]
        kernels.fuse_volume(*ks, *fargs, 0.0, off)
        kernels.fuse_volume_plain(*ps, *fargs, 0.0, off)
        k2_rows.append(dict(slab=k, bit_equal_to_plain=_bits_all(ks, ps), updated=int((ps[2] != slab[2]).sum()),
                            bits_apart_from_whole_k2=sum(int((a.view(torch.int32) != w[off:off + local].view(
                                torch.int32)).sum()) for a, w in zip(ks, whole))))
        variants = {}
        for variant in ("coarse", "split", "fine", "subcell"):
            split, fine = variant == "split", variant == "fine"
            classes = fb.classify_bricks(table, pose, intr, lcfg, n_slab, split=split, fine=fine, x_offset=off)
            if fine:
                plain = fb.rank_bricks_plain(fb.classify_bricks_fine_plain(table, pose, intr, lcfg, off), n_slab)
            else:
                full = fb.classify_bricks_full_plain(table, pose, intr, lcfg, split=split, x_offset=off)
                plain = fb.rank_bricks_plain(full.cls, n_slab)._replace(
                    aux=fb.pack_aux(full).reshape(-1, fb.AUX_INTS) if split else None)
            subs = psubs = None
            sub_equal = True
            if variant == "subcell":
                subs = fb.classify_subcells(table, pose, intr, lcfg, classes, n_slab, n_slab, off)
                psubs = fb.classify_subcells_plain(table, pose, intr, lcfg, plain, n_slab, n_slab, off)
                sub_equal = all(bool(torch.equal(a, b)) for a, b in zip(subs, psubs))
            kb, pb = [x.clone() for x in slab], [x.clone() for x in slab]
            extra = (0.0, subs, n_slab if subs is not None else 0)
            fb.fuse_bricks(*kb, depth_m, pose, intr, lcfg, classes, n_slab, False, *extra, x_offset=off)
            fb.fuse_bricks_plain(*pb, depth_m, pose, intr, lcfg, plain, n_slab, False, 0.0, psubs,
                                 n_slab if psubs is not None else 0, off)
            torch.cuda.synchronize()
            variants[variant] = dict(classes_equal=_bricks_equal(classes, plain), subcells_equal=sub_equal,
                                     volume_equal_to_plain=_bits_all(kb, pb),
                                     volume_equal_to_whole_k2=_bits_all(kb, [w[off:off + local] for w in whole]),
                                     n_active=int(classes.totals[0]))
            if variant == "coarse":
                n_active, n_work = (int(x) for x in classes.totals)
                updated = int((pb[2] != slab[2]).sum())
                brick_rows.append(dict(slab=k, classes=classes, n_active=n_active, n_work=n_work, updated=updated))
        slab_rows.append(variants)
        emit("B19a slab fusion", slab=k, x_offset=off, k2=k2_rows[-1], bricks=variants)
        check(k2_rows[-1]["bit_equal_to_plain"], f"B19a: K2 on slab {k} differs from its plain version")
        check(all(all(v.values()) for v in variants.values()),
              f"B19a: the brick kernels on slab {k} differ from their plain versions or from K2's rows: {variants}")
    # times on slab 1 (an offset that moves every voxel)
    off = local
    slab = [_slab_rows(x, 1) for x in vol]
    ks = [x.clone() for x in slab]
    k2_ms = time_ms(lambda: kernels.fuse_volume(*ks, *fargs, 0.0, off), 20)
    k2_plain = time_ms(lambda: kernels.fuse_volume_plain(*ks, *fargs, 0.0, off), 2)
    upd = k2_rows[1]["updated"]
    k2_bound = bound_ms(depth_m.numel() * 4 + 24 * 4 + upd * 24, ks[0].numel() * 69 + upd * 60)
    out["fuse_volume_slab"] = dict(max_abs_err=0.0, ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bound[0],
                                   bound_by=k2_bound[1], x_offset=off)
    b = brick_rows[1]
    cls_ms = time_ms(lambda: fb.classify_bricks(table, pose, intr, lcfg, n_slab, x_offset=off), 50)
    cls_plain = time_ms(lambda: fb.rank_bricks_plain(fb.classify_bricks_plain(table, pose, intr, lcfg, off),
                                                     n_slab), 3)
    cls_bound = bound_ms(table.numel() * 4 + pose.numel() * 4 + n_slab * 8 + (b["n_active"] + b["n_work"]) * 4 + 9,
                         n_slab * 600)
    out["classify_bricks_slab"] = dict(max_abs_err=0.0, ms=cls_ms, plain_ms=cls_plain, bound_ms=cls_bound[0],
                                       bound_by=cls_bound[1], x_offset=off)
    fb_ms = time_ms(lambda: fb.fuse_bricks(*ks, depth_m, pose, intr, lcfg, b["classes"], n_slab, False, x_offset=off),
                    20)
    fb_plain = time_ms(lambda: fb.fuse_bricks_plain(*ks, depth_m, pose, intr, lcfg, b["classes"], n_slab, False,
                                                    0.0, None, 0, off), 2)
    fb_bound = bound_ms(depth_m.numel() * 4 + b["updated"] * 24, b["n_work"] * 512 * 69 + b["n_active"] * 512 * 60)
    out["fuse_bricks_slab"] = dict(max_abs_err=0.0, ms=fb_ms, plain_ms=fb_plain, bound_ms=fb_bound[0],
                                   bound_by=fb_bound[1], x_offset=off)
    del whole, ks, slab

    # ---- B19b, B19c: the raycast over the slabs at the orbit's frame 3 (480x640)
    rpose, parts = _ray_pose(ctx, 3)
    ray_dir, ray_start = kernels.camera_rays(parts[0], parts[1], intr)
    w_found, w_dead = kernels.march_fixed(vol.value, rpose, intr, eng.voxel_size, eng.trunc_dist)
    w_maps = raycast.raycast_refine(vol, rpose, w_found, w_dead, intr, eng)
    d_found, d_dead = kernels.march_fixed(vol.value, rpose, intr, eng.voxel_size, eng.trunc_dist,
                                          spec=raycast.ShardSpec())
    defaults.update(k3_default_spec=bool(torch.equal(d_found, w_found)) and bool(torch.equal(d_dead, w_dead)))
    h = halo_width(eng, local)
    slabs = []
    for k in range(SLAB_RANKS):
        spec = raycast.ShardSpec(x_base=k * local - h, x_total=X, core_start=k * local, core_end=(k + 1) * local)
        ext = fusion.VolumeState(_slab_rows(vol.value, k, h), _slab_rows(vol.grad, k, h), None)
        tf, td = kernels.march_fixed(ext.value, rpose, intr, eng.voxel_size, eng.trunc_dist, spec=spec)
        pf, pd = kernels.march_fixed_plain(ext.value, ray_start, ray_dir, eng.voxel_size, eng.trunc_dist, spec)
        # K3 against plain as phase_march holds it: the plain version's floor(p / voxel) is PyTorch's multiply by
        # the reciprocal, K3's the true division's, so a sample on a floor boundary may pick the neighbour
        slabs.append(dict(spec=spec, ext=ext, tf=tf, td=td, k3_frac_equal=min(frac_equal(tf, pf), frac_equal(td, pd))))
    found_min = torch.minimum(slabs[0]["tf"], slabs[1]["tf"])
    dead_min = torch.minimum(slabs[0]["td"], slabs[1]["td"])
    accept = w_found < torch.clamp(w_dead, max=INF_T)
    summed = None
    for k, s in enumerate(slabs):
        s["maps"] = raycast.raycast_refine_shard(s["ext"], rpose, s["tf"], found_min, dead_min, intr, eng, s["spec"])
        plain = raycast.raycast_refine_shard_plain(s["ext"], rpose, s["tf"], found_min, dead_min, intr, eng,
                                                   s["spec"])
        s["k5_equal"] = _bits_all((s["maps"],), (plain,))
        summed = s["maps"].clone() if summed is None else summed + s["maps"]
    fin_plain = raycast.finalize_maps(CSFD(summed[0:3], summed[3:6]), CSFD(summed[6:9], summed[9:12]),
                                      summed[12] > 0, summed[13] > 0)
    fin_in = summed.clone()
    vmap, nmap = raycast.raycast_finalize(fin_in)
    torch.cuda.synchronize()
    fin_equal = _bits_all((vmap.v, vmap.g, nmap.v, nmap.g), (fin_plain[0].v, fin_plain[0].g, fin_plain[1].v,
                                                              fin_plain[1].g))
    lanes = ((vmap.v, w_maps[0].v), (vmap.g, w_maps[0].g), (nmap.v, w_maps[1].v), (nmap.g, w_maps[1].g))
    maps_equal = all(bool(torch.equal(torch.nan_to_num(a, nan=7.0), torch.nan_to_num(b, nan=7.0))) and same_nans(a, b)
                     for a, b in lanes)
    maps_bits_apart = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum()) for a, b in lanes)
    combined = dict(t_found_pixels_apart=int((found_min != w_found).sum()),
                    t_dead_pixels_apart=int((dead_min != w_dead).sum()),
                    t_found_apart_where_accepted=int((found_min != w_found)[accept].sum()),
                    accept_apart=int(((found_min < torch.clamp(dead_min, max=INF_T)) != accept).sum()),
                    maps_equal_to_whole=maps_equal, map_entries_bits_apart=maps_bits_apart,
                    finalize_bit_equal_to_plain=fin_equal)
    emit("B19bc slab raycast", halo=h, defaults=defaults,
         slabs=[dict(slab=k, k3_frac_equal_to_plain=s["k3_frac_equal"], k5_bit_equal_to_plain=s["k5_equal"],
                     owned_pixels=int((s["maps"][12] > 0).sum())) for k, s in enumerate(slabs)], combined=combined)
    check(all(defaults.values()), f"B19: a hook at its defaults changed the bits: {defaults}")
    check(all(s["k3_frac_equal"] >= 0.999 and s["k5_equal"] for s in slabs),
          "B19b/c: K3 or K5 on a slab differs from its plain version")
    check(fin_equal and maps_equal and combined["t_found_apart_where_accepted"] == 0 and combined["accept_apart"] == 0,
          f"B19b/c: the slabs' combined raycast is not the whole volume's: {combined}")
    s = slabs[1]
    spec, ext = s["spec"], s["ext"]
    ms3 = time_ms(lambda: kernels.march_fixed(ext.value, rpose, intr, eng.voxel_size, eng.trunc_dist, spec=spec), 50)
    plain3 = time_ms(lambda: kernels.march_fixed_plain(ext.value, ray_start, ray_dir, eng.voxel_size, eng.trunc_dist,
                                                       spec), 3)
    n_bytes, n_ops, _ = _march_bytes_ops(vol.value, ray_start.v, ray_dir.v, s["tf"], s["td"], eng,
                                         rows=(spec.x_base, spec.x_base + ext.value.shape[0]),
                                         core=(spec.core_start, spec.core_end))
    b3 = bound_ms(n_bytes, n_ops)
    out["march_fixed_shard"] = dict(max_abs_err=0.0, ms=ms3, plain_ms=plain3, bound_ms=b3[0], bound_by=b3[1],
                                    slab=1, halo=h, **_b19b_designs(ctx, rpose, ray_start, ray_dir))
    ms5 = time_ms(lambda: raycast.raycast_refine_shard(ext, rpose, s["tf"], found_min, dead_min, intr, eng, spec), 50)
    plain5 = time_ms(lambda: raycast.raycast_refine_shard_plain(ext, rpose, s["tf"], found_min, dead_min, intr, eng,
                                                                spec), 3)
    owner = s["maps"][12] > 0
    n_bytes, n_ops, _ = _refine_bytes_ops(vol, ray_start, ray_dir, found_min, owner, eng)
    n_pix = owner.numel()
    b5 = bound_ms(n_bytes + n_pix * (4 + 56 - 48), n_ops)  # a third time in, 14 planes out a pixel
    out["raycast_refine_shard"] = dict(max_abs_err=0.0, ms=ms5, plain_ms=plain5, bound_ms=b5[0], bound_by=b5[1],
                                       slab=1)
    msf = time_ms(lambda: raycast.raycast_finalize(fin_in), 100)
    # what it touches fits the 50 MB L2, so a warm launch reads it from L2: below the bound by device memory
    coldf = time_cold_ms(lambda: raycast.raycast_finalize(fin_in), 50)
    plainf = time_ms(lambda: raycast.finalize_maps(CSFD(summed[0:3], summed[3:6]),
                                                   CSFD(summed[6:9], summed[9:12]), summed[12] > 0,
                                                   summed[13] > 0), 20)
    # the two masks read a pixel, the 6 floats of each map whose mask sums to 0 written; two tests a pixel
    masked_out = int((summed[12] <= 0).sum()) + int((summed[13] <= 0).sum())
    bf = bound_ms(n_pix * 2 * 4 + masked_out * 6 * 4, n_pix * 2)
    out["raycast_finalize"] = dict(max_abs_err=0.0, ms=msf, cold_ms=coldf, plain_ms=plainf, bound_ms=bf[0],
                                   bound_by=bf[1], masked_out_maps=masked_out)

    # ---- B19d: K4's tail alone, at the main path's level 0 (480x640)
    vprev, nprev, vcurr, ncurr, ipose = _icp_inputs(ctx, 0)
    lintr = intr.level(0)
    rows = icp.pack_model_rows(vprev[0], nprev[0])
    packed = icp.pack_pose(ipose["r_curr"], ipose["t_curr"], ipose["r_prev_inv"], ipose["t_prev"])
    args = (rows, vprev[0].v.shape[-2:], lintr, cfg.dist_thres, cfg.angle_thres_sine, cfg.icp_damping)
    fused = icp.IcpLoop(packed)
    fused.iterate(vcurr[0], ncurr[0], *args)
    fused = fused.result()
    split = icp.IcpLoop(packed, reduce=lambda totals: None)  # one rank: the totals are the sum
    split.iterate(vcurr[0], ncurr[0], *args)
    split = split.result()
    tail_equal = _same_step(fused, split) and bool(torch.equal(fused.system.inlier_count, split.system.inlier_count))
    # two column blocks' totals summed, then the tail, against icp_step_plain on the tail's own system
    sc = icp._icp_scratch(dev)
    W = vcurr[0].shape[-1]
    block_totals = []
    for k in range(SLAB_RANKS):
        cols = slice(k * W // SLAB_RANKS, (k + 1) * W // SLAB_RANKS)
        vb, nb = vcurr[0][:, :, cols].contiguous(), ncurr[0][:, :, cols].contiguous()
        tot = torch.empty(icp.ICP_SUMS, dtype=torch.float64, device=dev)
        icp._launch_system(sc, vb, nb, rows, vprev[0].v.shape[-2:], None, packed, sc.out, sc.inliers, lintr,
                           cfg.dist_thres, cfg.angle_thres_sine, totals_out=tot)
        block_totals.append(tot)
    total = block_totals[0] + block_totals[1]
    tail_out = [torch.empty(84, dtype=torch.float32, device=dev), torch.empty((), dtype=torch.int32, device=dev),
                torch.empty(icp.POSE_FLOATS, dtype=torch.float32, device=dev),
                torch.empty(12, dtype=torch.float32, device=dev), torch.zeros(2, dtype=torch.int32, device=dev)]
    icp.icp_tail(total, packed, *tail_out, cfg.icp_damping, True)
    torch.cuda.synchronize()
    system = icp._system_of(tail_out[0], tail_out[1])
    r_new, t_new = icp.unpack_pose(tail_out[2])
    step = icp.IcpStep(system=system, r_curr=r_new, t_curr=t_new, x=CSFD(tail_out[3][:6], tail_out[3][6:]),
                       ok=tail_out[4][0] != 0)
    ref = icp.icp_step_plain(system, ipose["r_curr"], ipose["t_curr"], cfg.icp_damping)
    tail_row = _check_tail(step, ref, "B19d, two column blocks")
    inliers_equal = int(system.inlier_count) == int(fused.system.inlier_count)
    msd = time_ms(lambda: icp.icp_tail(total, packed, *tail_out, cfg.icp_damping, True), 200)
    plaind = time_ms(lambda: icp.icp_step_plain(system, ipose["r_curr"], ipose["t_curr"], cfg.icp_damping), 5)
    # the totals in (55 doubles), the system (84 floats and the count), the pose, x and flags out; some 1,500
    # operations (the damping, the 6x6 LU, four triangular solves, the Euler increment and two 3x3 products)
    bd = bound_ms(icp.ICP_SUMS * 8 + icp.POSE_FLOATS * 4 + (84 + 1 + icp.POSE_FLOATS + 12 + 2) * 4, 1500)
    out["icp_tail"] = dict(max_abs_err=tail_row["tail_pose_abs_err"], ms=msd, plain_ms=plaind, bound_ms=bd[0],
                           bound_by=bd[1])
    emit("B19d icp tail", shape=list(vcurr[0].shape[1:]), bit_equal_to_fused_tail=tail_equal,
         two_blocks=dict(inliers_equal_to_whole=inliers_equal, **tail_row))
    check(tail_equal, "B19d: K4's tail launch over the totals is not the fused launch's bit for bit")
    check(inliers_equal, "B19d: two column blocks' inliers do not add up to the whole image's")
    for key, row in out.items():
        emit(f"B19 {key}", library_ms=None, library_note="no single PyTorch call computes it", **row)
    return out


# the column blocks of the brick raycast (B19f) and the slab masks (B19e): the rank counts of the split, B5b's
# strides, and the launches timed a block against the whole image's
COLUMN_RANKS = (2, 4)
COLUMN_STRIDES = (1, 2, 4)


def _differing(a: torch.Tensor, b: torch.Tensor, col0: int = 0) -> dict:
    """Pixels where two maps differ (NaN equal to NaN), and their columns
    (offset by ``col0``, at most 24 listed)."""
    d = (a != b) & ~(torch.isnan(a) & torch.isnan(b))
    while d.dim() > 2:
        d = d.any(dim=0)
    cols = (torch.nonzero(d.any(dim=0)).flatten() + col0).tolist()
    return dict(pixels=int(d.sum()), columns=cols[:24], n_columns=len(cols))


def phase_b19_columns(ctx):
    """B19e and B19f, the sharded engine's brick raycast over column blocks,
    at the bench path's shapes: the orbit's frame-3 brick rows (256^3), the
    240x320 model maps' rays at the packed pose, frame 3's depth anchors.

    B19e: for 2 and 4 slabs of rows, each slab's event mask (B5a's mask
    kernel alone) equal to ``event_brick_mask`` of its rows, the masks
    concatenated equal to the whole rows' mask, and ``skip_distance`` of them
    equal to ``skip_field``'s and ``brick_distance_rows``' distance, bit for
    bit; each timed warm and cold beside ``skip_field``.

    B19f: for n = 2 and 4 blocks of ``320 / n`` columns (intrinsics from
    ``column_intrinsics``), every block's launches against their plain
    versions on the block's rays (``camera_rays`` at the block's
    intrinsics), bit for bit: B5b at strides 1, 2 and 4 (``march_skip_plain``
    over ``pack_rows``), B4 with the block of the anchors without and with
    the ``reuse`` refine (``march_temporal``, ``_reuse_maps``), B4's repairs
    from coarse hits at strides 2 and 1 (the refresh's chain from B5b's
    quarter-level hits, ``_window_repair``), B16 (``march_temporal_compact``)
    and K5r from the block's B5b hits (``_secant_maps``). B5b at every stride
    that divides the block's first column, and K5r on the whole image's hits,
    also equal the whole image's launch at the block's columns bit for bit
    (the block's rays are the image's); the anchored marches and the repairs
    differ at block edges (their coarse neighbourhood is clipped), and the
    pixels and columns where they differ are printed. Each kernel is timed a
    block against the whole image, warm and cold."""
    from xslam_tpu_torch.csfd.single import CSFD
    from xslam_tpu_torch.ops import bricks, kernels, raycast
    from xslam_tpu_torch.ops import raycast_bricks as rb

    eng, dev = ctx["engine_cfg"], ctx["device"]
    res = eng.resolution
    rows, pose, parts, intr, t_anchor = _bench_inputs(ctx)
    nbx, nby, nbz = bricks.brick_grid(res)
    n_bricks = nbx * nby * nbz
    read = rb._value_reader(rows.value, res)
    dist = bricks.skip_field(rows, res)
    dist_plain = bricks.brick_distance_rows(rows, res)
    mask_plain = bricks.event_brick_mask(rows).to(torch.uint8)
    packed_read = rb._value_reader(bricks.pack_rows(rows.value, dist_plain), res)
    out = {}

    # B19e: the slabs' masks and the distance over their concatenation
    b19e = {}
    for n in COLUMN_RANKS:
        nb = n_bricks // n
        local = (res[0] // n, res[1], res[2])
        slabs = [bricks.BrickVolume(*(p[k * nb:(k + 1) * nb] for p in rows)) for k in range(n)]
        masks = [bricks.event_mask(slab, local) for slab in slabs]
        mask = torch.cat(masks)
        d = bricks.skip_distance(mask, res)
        torch.cuda.synchronize()
        each = all(bool(torch.equal(m, bricks.event_brick_mask(slab).to(torch.uint8))) for m, slab in zip(masks, slabs))
        b19e[n] = dict(slab_masks_equal_to_plain=each, mask_equal_to_whole=bool(torch.equal(mask, mask_plain)),
                       distance_equal_to_skip_field=bool(torch.equal(d, dist)),
                       distance_equal_to_plain=bool(torch.equal(d, dist_plain)), event_bricks=int(mask.sum()))
        check(all(b19e[n].values()), f"B19e over {n} slabs: {b19e[n]}")
    slab = bricks.BrickVolume(*(p[: n_bricks // 2] for p in rows))
    local = (res[0] // 2, res[1], res[2])
    run_mask = lambda: bricks.event_mask(slab, local)  # noqa: E731
    run_dist = lambda: bricks.skip_distance(mask_plain, res)  # noqa: E731
    run_field = lambda: bricks.skip_field(rows, res)  # noqa: E731
    t = {name: (time_ms(fn, 50), time_cold_ms(fn, 30)) for name, fn in
         (("event_mask", run_mask), ("skip_distance", run_dist), ("skip_field", run_field))}
    mask_plain_ms = time_ms(lambda: bricks.event_brick_mask(slab).to(torch.uint8), 3)
    dist_plain_ms = time_ms(lambda: bricks.distance_from_event_mask(mask_plain.bool(), res), 3)
    # the slab's value and weight rows once, a byte out a brick, ~3 operations a voxel; the mask in, a distance
    # out a brick, and the capped L-inf distance as three separable 1-D min passes of 2 * DIST_CAP + 1 taps a brick
    mask_bound = bound_ms(2 * slab.value.numel() * 4 + n_bricks // 2, slab.value.numel() * 3)
    dist_bound = bound_ms(n_bricks * 5, n_bricks * 3 * (2 * bricks.DIST_CAP + 1))
    emit("B19e slab masks", slabs=b19e, slab_bricks=n_bricks // 2,
         event_mask=dict(ms=t["event_mask"][0], cold_ms=t["event_mask"][1], plain_ms=mask_plain_ms,
                         bound_ms=mask_bound[0], bound_by=mask_bound[1]),
         skip_distance=dict(ms=t["skip_distance"][0], cold_ms=t["skip_distance"][1], plain_ms=dist_plain_ms,
                            bound_ms=dist_bound[0], bound_by=dist_bound[1]),
         skip_field_whole=dict(ms=t["skip_field"][0], cold_ms=t["skip_field"][1]), library_ms=None,
         library_note="no single PyTorch call computes it")
    out["event_mask"] = dict(max_abs_err=0.0, ms=t["event_mask"][0], cold_ms=t["event_mask"][1],
                             plain_ms=mask_plain_ms, bound_ms=mask_bound[0], bound_by=mask_bound[1])
    out["skip_distance"] = dict(max_abs_err=0.0, ms=t["skip_distance"][0], cold_ms=t["skip_distance"][1],
                                plain_ms=dist_plain_ms, bound_ms=dist_bound[0], bound_by=dist_bound[1])

    # B19f: the whole image's launches, then every block's
    H, W = intr.height, intr.width
    whole_skip = {s: rb.march_skip(rows, dist, pose, intr, eng, stride=s) for s in COLUMN_STRIDES}
    whole_hits = rb.window_march(rows, pose, intr, eng, t_anchor, WINDOW)
    whole_vmap, whole_tf = rb.window_march(rows, pose, intr, eng, t_anchor, WINDOW, refine=True)
    whole_mid = rb.window_march(rows, pose, intr, eng, whole_skip[4].t_found, raycast.HIER2_MID_WINDOW,
                                anchor_dead=whole_skip[4].t_dead, stride=2)
    whole_fine = rb.window_march(rows, pose, intr, eng, whole_mid.t_found, WINDOW, anchor_dead=whole_mid.t_dead)
    whole_b16 = rb.window_march(rows, pose, intr, eng, t_anchor, WINDOW, first_event=True)
    whole_k5r = rb.raycast_refine_bricks(rows, pose, whole_skip[1].t_found, whole_skip[1].t_dead, intr, eng)
    blocks, edges = {}, {}
    for n in COLUMN_RANKS:
        w = W // n
        for k in range(n):
            col0 = k * w
            cols = slice(col0, col0 + w)
            bi = rb.column_intrinsics(intr, col0, w)
            ray_dir, ray_start = kernels.camera_rays(parts[0], parts[1], bi)
            anchor = t_anchor[:, cols].contiguous()
            lanes, whole_eq, differ = {}, {}, {}
            for s in COLUMN_STRIDES:
                hit = rb.march_skip(rows, dist, pose, bi, eng, stride=s)
                plain = raycast.march_skip_plain(ray_start, ray_dir.v[:, ::s, ::s], eng, packed_read, res)
                lanes[f"B5b/{s} t_found"] = (hit.t_found, plain.t_found)
                lanes[f"B5b/{s} t_dead"] = (hit.t_dead, plain.t_dead)
                if col0 % s == 0:
                    c = slice(col0 // s, col0 // s + kernels.strided(w, s))
                    whole_eq[f"B5b/{s}"] = _bits_all((hit.t_found, hit.t_dead),
                                                     (whole_skip[s].t_found[:, c].contiguous(),
                                                      whole_skip[s].t_dead[:, c].contiguous()))
                if s == 1:
                    hit1 = hit
                if s == 4:
                    coarse = hit
            hits = rb.window_march(rows, pose, bi, eng, anchor, WINDOW)
            plain = raycast.march_temporal(anchor, ray_start, ray_dir, eng, WINDOW, read, res)
            lanes.update({"B4 t_found": (hits.t_found, plain.t_found), "B4 t_dead": (hits.t_dead, plain.t_dead)})
            vmap, tf = rb.window_march(rows, pose, bi, eng, anchor, WINDOW, refine=True)
            samples = raycast.march_temporal(anchor, ray_start, ray_dir, eng, WINDOW, read, res, True)
            vp, hp = rb._reuse_maps(rows, ray_start, ray_dir, samples, parts[2], parts[3], eng)
            lanes.update({"B4+reuse vmap.v": (vmap.v, vp.v), "B4+reuse vmap.g": (vmap.g, vp.g),
                          "B4+reuse t_found": (tf, hp.t_found)})
            mid = rb.window_march(rows, pose, bi, eng, coarse.t_found, raycast.HIER2_MID_WINDOW,
                                  anchor_dead=coarse.t_dead, stride=2)
            mid_p = raycast._window_repair(ray_start, ray_dir.v[:, ::2, ::2], coarse, raycast.HIER2_MID_WINDOW, eng,
                                           read, res)
            fine = rb.window_march(rows, pose, bi, eng, mid.t_found, WINDOW, anchor_dead=mid.t_dead)
            fine_p = raycast._window_repair(ray_start, ray_dir.v, mid, WINDOW, eng, read, res)
            lanes.update({"B4 repair/2 t_found": (mid.t_found, mid_p.t_found),
                          "B4 repair/2 t_dead": (mid.t_dead, mid_p.t_dead),
                          "B4 repair/1 t_found": (fine.t_found, fine_p.t_found),
                          "B4 repair/1 t_dead": (fine.t_dead, fine_p.t_dead)})
            b16 = rb.window_march(rows, pose, bi, eng, anchor, WINDOW, first_event=True)
            b16_p = raycast.march_temporal_compact(anchor, ray_start, ray_dir, eng, WINDOW, read_fn=read, shape=res)
            lanes.update({"B16 t_found": (b16.t_found, b16_p.t_found), "B16 t_dead": (b16.t_dead, b16_p.t_dead)})
            k5r = rb.raycast_refine_bricks(rows, pose, hit1.t_found, hit1.t_dead, bi, eng)
            k5r_p = rb._secant_maps(rows, ray_start, ray_dir, hit1, parts[2], parts[3], eng)
            for m, (a, b) in enumerate(zip(k5r, k5r_p)):
                name = ("vmap", "nmap")[m]
                lanes.update({f"K5r {name}.v": (a.v, b.v), f"K5r {name}.g": (a.g, b.g)})
            k5r_whole_hits = rb.raycast_refine_bricks(rows, pose, whole_skip[1].t_found[:, cols].contiguous(),
                                                      whole_skip[1].t_dead[:, cols].contiguous(), bi, eng)
            whole_eq["K5r"] = _bits_all([x for m in k5r_whole_hits for x in (m.v, m.g)],
                                        [x[..., cols] for m in whole_k5r for x in (m.v, m.g)])
            differ["B4"] = _differing(torch.stack([hits.t_found, hits.t_dead]),
                                      torch.stack([whole_hits.t_found[:, cols], whole_hits.t_dead[:, cols]]), col0)
            differ["B4+reuse"] = _differing(vmap.v, whole_vmap.v[..., cols], col0)
            differ["B4 repair/2"] = _differing(torch.stack([mid.t_found, mid.t_dead]),
                                               torch.stack([whole_mid.t_found[:, col0 // 2:(col0 + w) // 2],
                                                            whole_mid.t_dead[:, col0 // 2:(col0 + w) // 2]]), col0 // 2)
            differ["B4 repair/1"] = _differing(torch.stack([fine.t_found, fine.t_dead]),
                                               torch.stack([whole_fine.t_found[:, cols], whole_fine.t_dead[:, cols]]),
                                               col0)
            differ["B16"] = _differing(torch.stack([b16.t_found, b16.t_dead]),
                                       torch.stack([whole_b16.t_found[:, cols], whole_b16.t_dead[:, cols]]), col0)
            torch.cuda.synchronize()
            eq = _lanes_equal(f"B19f block {k} of {n}", lanes)
            check(all(whole_eq.values()), f"B19f block {k} of {n}: not the whole image's at its columns: {whole_eq}")
            blocks[f"{k}/{n}"] = dict(col0=col0, width=w, cx=bi.cx, max_abs_err=eq["max_abs_err"],
                                      bit_equal_to_plain=True, bit_equal_to_whole_image=whole_eq)
            edges[f"{k}/{n}"] = differ

    # timings: a block's launch (the first block of each split) against the whole image's, warm and cold
    def launches(bi, anchor, coarse, mid, hit1):
        return {
            "march_skip/1": lambda: rb.march_skip(rows, dist, pose, bi, eng, stride=1),
            "march_skip/4": lambda: rb.march_skip(rows, dist, pose, bi, eng, stride=4),
            "window_march+reuse": lambda: rb.window_march(rows, pose, bi, eng, anchor, WINDOW, refine=True),
            "window_march repair/2": lambda: rb.window_march(rows, pose, bi, eng, coarse.t_found,
                                                             raycast.HIER2_MID_WINDOW, anchor_dead=coarse.t_dead,
                                                             stride=2),
            "window_march repair/1": lambda: rb.window_march(rows, pose, bi, eng, mid.t_found, WINDOW,
                                                             anchor_dead=mid.t_dead),
            "window_march_first_event": lambda: rb.window_march(rows, pose, bi, eng, anchor, WINDOW,
                                                                first_event=True),
            "raycast_refine_bricks": lambda: rb.raycast_refine_bricks(rows, pose, hit1.t_found, hit1.t_dead, bi,
                                                                      eng),
        }

    def sliced(hit, c):
        return raycast.RaycastHit(hit.t_found[:, c].contiguous(), hit.t_dead[:, c].contiguous())

    timing = {"whole": {name: (time_ms(fn, 50), time_cold_ms(fn, 30)) for name, fn in
                        launches(intr, t_anchor, whole_skip[4], whole_mid, whole_skip[1]).items()}}
    for n in COLUMN_RANKS:
        w = W // n
        bi = rb.column_intrinsics(intr, 0, w)
        args = (bi, t_anchor[:, :w].contiguous(), sliced(whole_skip[4], slice(0, w // 4)),
                sliced(whole_mid, slice(0, w // 2)), sliced(whole_skip[1], slice(0, w)))
        timing[f"block 0 of {n}"] = {name: (time_ms(fn, 50), time_cold_ms(fn, 30))
                                     for name, fn in launches(*args).items()}
    # the plain composition of a block (B4 with the reuse refine, the bench frame's raycast) against the whole's
    plain_ms = {}
    for n in (1,) + COLUMN_RANKS:
        w = W // n
        bi = rb.column_intrinsics(intr, 0, w)
        ray_dir, ray_start = kernels.camera_rays(parts[0], parts[1], bi)
        anchor = t_anchor[:, :w].contiguous()
        plain_ms[f"block 0 of {n}"] = time_ms(lambda: rb._reuse_maps(
            rows, ray_start, ray_dir, raycast.march_temporal(anchor, ray_start, ray_dir, eng, WINDOW, read, res, True),
            parts[2], parts[3], eng), 3)
    emit("B19f column blocks", shape=[H, W], splits=list(COLUMN_RANKS), strides=list(COLUMN_STRIDES), blocks=blocks,
         differing_from_whole_image=edges,
         timing={where: {k: dict(ms=v[0], cold_ms=v[1]) for k, v in rows_.items()} for where, rows_ in timing.items()},
         plain_b4_reuse_ms=plain_ms, library_ms=None, library_note="no single PyTorch call computes it")
    ctx["b19f"] = dict(timing=timing, plain_ms=plain_ms)
    return out


def _sharded_run(ctx, cfg, n_frames: int, group):
    """The sharded engine at world size 1 over ``n_frames`` of the orbit, the
    launch counts set to 0 just before and read just after; the last frame
    runs under the profiler. Returns (engine, state, results, frame ms,
    counts, profile)."""
    from xslam_tpu_torch.ops import kernels
    from xslam_tpu_torch.parallel.engine import ShardedXSlamEngine

    engine = ShardedXSlamEngine(cfg, group=group)
    state = engine.init_state()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    results, times, prof = [], [], None
    for i in range(n_frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == n_frames - 1:
            (state, res), prof, _ = _lead_profile(lambda: engine.process_frame(state, ctx["depths"][i]))
        else:
            state, res = engine.process_frame(state, ctx["depths"][i])
        engine.log_pose(res)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        results.append(res)
    return engine, state, results, times[:-1], dict(kernels.launch_counts), prof


def _host_ms(prof) -> dict:
    """The host ms of a profiled frame's stage ranges and of its
    collectives (the profiler's ``nccl:`` and ``c10d::`` ranges, each name
    apart: they nest), with the collectives' counts."""
    from torch.autograd import DeviceType

    from xslam_tpu_torch.profile_step import STAGES

    stages, comms = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if e.name in STAGES:
            stages[e.name] = stages.get(e.name, 0.0) + e.cpu_time_total / 1e3
        elif e.name.startswith(("nccl:", "c10d::")):
            n, ms = comms.get(e.name, (0, 0.0))
            comms[e.name] = (n + 1, ms + e.cpu_time_total / 1e3)
    return dict(stages=stages, collectives={k: dict(calls=n, ms=ms) for k, (n, ms) in comms.items()})


# the sharded engine's runs at world size 1 over NCCL, each beside XSlamEngine on the same frames: its own options
# (the dense layout), the JAX package's fast ones, bench.py:78-95's configuration (the brick layout) and its forced
# refresh; (options, frames)
SHARDED_RUNS = {
    "main path, sharded": ({}, N_FRAMES),
    "main path, sharded fast": (dict(fusion_mode="brick", fusion_brick_cap=BRICK_CAP, raycast_normals="screen",
                                     icp_fixed_assoc=True), N_FRAMES),
    "main path, sharded bench": (BENCH_OPTIONS, N_FRAMES_BENCH),
    "main path, sharded bench refresh": (dict(BENCH_OPTIONS, raycast_temporal_min_coverage=REFRESH_COVERAGE),
                                         N_FRAMES_REFRESH),
}


def phase_main_path_sharded(ctx, tag: str = "main path, sharded"):
    """The sharded engine (``ShardedXSlamEngine``) at world size 1 over NCCL,
    configs/synthetic.yaml (640x480, 256^3) with a setting of
    :data:`SHARDED_RUNS`: the poses (both lanes), the volume (on the brick
    layout its rows), the model maps and ``t_prev`` equal ``XSlamEngine``'s
    run of the same configuration bit for bit, and so do the ATE digits;
    every kernel of the path launched as often as its frames and ICP
    iterations say (K4 and its tail once an iteration; on the dense layout K3
    and K5 in their slab modes and K5's finalize once a frame, K2 or B3b and
    B3c with the slab's offset; on the brick layout B3a, B3b and B3c with the
    slab's offset, B4 once a frame, or on a refresh frame B5a, B5b and B4
    twice, and B4n in K6's launch: at one rank no gather and no column
    block, so no B19e launch); the mean and median frame ms of both engines
    on the same frames and their launches a frame, the profiled frame's
    launches, the device time of its NCCL kernels, and both engines' host ms
    in their stages and the sharded one's in its collectives are printed."""
    import dataclasses

    from torch.autograd import DeviceType

    from xslam_tpu_torch.models.kinfu import XSlamEngine
    from xslam_tpu_torch.ops import kernels
    from xslam_tpu_torch.parallel.mesh import init_space_group
    from xslam_tpu_torch.utils.evaluation import ate_rmse, normalize_to_first

    options, n_frames = SHARDED_RUNS[tag]
    cfg = dataclasses.replace(ctx["config"], **options)
    if "space_group" not in ctx:
        ctx["space_group"] = init_space_group()  # NCCL on this card, a group of one
    group = ctx["space_group"]
    # the single engine on the same frames, timed as _sharded_run times the sharded one (its last frame left out
    # as the sharded run's profiled one is)
    single = XSlamEngine(cfg, device=ctx["device"])
    sstate, sres, stimes = single.init_state(), [], []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for i in range(n_frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == n_frames - 1:
            (sstate, res), sprof, _ = _lead_profile(lambda: single.process_frame(sstate, ctx["depths"][i]))
        else:
            sstate, res = single.process_frame(sstate, ctx["depths"][i])
        single.log_pose(res)
        torch.cuda.synchronize()
        stimes.append((time.perf_counter() - t0) * 1e3)
        sres.append(res)
    single_counts = dict(kernels.launch_counts)
    engine, state, results, times, counts, prof = _sharded_run(ctx, cfg, n_frames, group)
    poses_equal = all(_bits_all((a.camera2world.v, a.camera2world.g), (b.camera2world.v, b.camera2world.g))
                      for a, b in zip(sres, results))
    brick_layout = cfg.volume_layout == "brick"
    volume_equal = _bits_all(sstate.volume, state.volume if brick_layout else engine.dense_volume(state))
    maps_equal = all(_bits_all((a.v, a.g), (b.v, b.g)) for a, b in zip(sstate.vmaps_prev + sstate.nmaps_prev,
                                                                       state.vmaps_prev + state.nmaps_prev))
    t_prev_equal = _bits_all((sstate.t_prev,), (state.t_prev,))
    coverage_equal = all((a.anchor_coverage is None and b.anchor_coverage is None)
                         or _bits_all((a.anchor_coverage,), (b.anchor_coverage,)) for a, b in zip(sres, results))
    gt = normalize_to_first(ctx["gt"][:n_frames])
    ate = ate_rmse(normalize_to_first(engine.pose_log), gt)
    single_ate = ate_rmse(normalize_to_first(single.pose_log), gt)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA and LEAD_KERNEL not in e.name]
    nccl = [e for e in device if "nccl" in e.name.lower()]
    rec = _frame_record(prof)
    steady = np.asarray(times[WARM_FRAMES:])
    single_steady = np.asarray(stimes[:-1][WARM_FRAMES:])
    iterations = sum(cfg.icp_iterations[: cfg.num_levels])
    brick = cfg.fusion_mode == "brick"
    screen = cfg.raycast_normals == "screen"
    refresh = cfg.raycast_temporal_min_coverage > 1.0
    want = {k: n_frames for k in ("bilateral_filter", "depth_pyramid", "vertex_normal_maps")}
    want.update(icp_system=iterations * n_frames, icp_tail=iterations * n_frames, icp_associate=0,
                fuse_volume=0, fuse_volume_slab=0 if brick else n_frames, march_fixed=0, raycast_refine=0,
                depth_mips=n_frames if brick else 0, classify_bricks_slab=n_frames if brick else 0,
                fuse_bricks_slab=n_frames if brick else 0, classify_bricks=0, fuse_bricks=0,
                model_map_normals=n_frames if screen else 0, resize_model_maps=0 if screen else n_frames,
                march_fixed_shard=0 if brick_layout else n_frames, raycast_refine_shard=0 if brick_layout else n_frames,
                raycast_finalize=0 if brick_layout else n_frames, event_mask=0, skip_distance=0,
                window_march=(2 if refresh else 1) * n_frames if brick_layout else 0,
                skip_field=n_frames if refresh else 0, march_skip=n_frames if refresh else 0)
    emit(tag, config="configs/synthetic.yaml", options=options, world_size=group.world_size, backend=group.backend,
         frames=n_frames, depth=[cfg.depth_height, cfg.depth_width], volume=list(cfg.tsdf_size),
         volume_layout=cfg.volume_layout, fusion_mode=cfg.fusion_mode, raycast_march=cfg.raycast_march,
         raycast_normals=cfg.raycast_normals, icp_fixed_assoc=cfg.icp_fixed_assoc, ate_m=ate, ate_mm=ate * 1e3,
         single_engine_ate_m=single_ate, ate_digits_equal=ate == single_ate,
         anchor_coverage=[None if r.anchor_coverage is None else float(r.anchor_coverage) for r in results],
         mean_frame_ms=float(steady.mean()), p50_frame_ms=float(np.median(steady)), frame_ms=times,
         single_engine_mean_frame_ms=float(single_steady.mean()),
         single_engine_p50_frame_ms=float(np.median(single_steady)), single_engine_frame_ms=stimes[:-1],
         poses_bit_equal=poses_equal, volume_bit_equal=volume_equal, model_maps_bit_equal=maps_equal,
         t_prev_bit_equal=t_prev_equal, anchor_coverage_bit_equal=coverage_equal,
         all_aligned=all(bool(r.align_ok) for r in results), kernels=counts,
         hand_kernel_launches_per_frame=sum(counts.values()) / n_frames,
         single_engine_hand_kernel_launches_per_frame=sum(single_counts.values()) / n_frames,
         host_ms_in_profiled_frame=_host_ms(prof), single_engine_host_ms_in_profiled_frame=_host_ms(sprof),
         device_events_in_profiled_frame=len(rec["names"]), host_launch_calls_in_profiled_frame=rec["host_calls"],
         stage_launches_in_profiled_frame=rec["stages"], nccl_kernels_in_profiled_frame=len(nccl),
         nccl_device_ms_in_profiled_frame=sum(e.time_range.elapsed_us() for e in nccl) / 1e3,
         nccl_kernel_names=sorted({e.name for e in nccl})[:6])
    check(poses_equal and volume_equal and maps_equal and t_prev_equal and coverage_equal,
          f"{tag}: not XSlamEngine's bits: poses {poses_equal}, volume {volume_equal}, maps {maps_equal}, t_prev "
          f"{t_prev_equal}, anchor coverage {coverage_equal}")
    check(ate == single_ate, f"{tag}: ATE {ate!r} m, the single engine's {single_ate!r} m")
    check(all(bool(r.align_ok) for r in results) and ate < 0.02, f"{tag}: alignment or ATE {ate} m")
    check(all(counts[k] == n for k, n in want.items()), f"{tag}: launch counts {counts}, expected {want}")
    if tag == "main path, sharded bench refresh":
        ctx["sharded_refresh_poses"] = [r.camera2world.v.cpu().numpy() for r in sres]
    if tag == "main path, sharded bench":
        ctx["sharded_bench_poses"] = [r.camera2world.v.cpu().numpy() for r in sres]
    return counts


# the brick layout over two ranks on this one card: two processes of tests/sharded_rank.py over gloo's CUDA
# collectives (NCCL refuses two ranks a card), bench.py's configuration over N_FRAMES_BENCH frames, its forced
# refresh over N_FRAMES_REFRESH, then the per-rank refresh at the stage
TWO_RANKS = 2
RANK_TIMEOUT_S = 300


def phase_main_path_sharded_two_ranks(ctx):
    """``ShardedXSlamEngine`` over two ranks on the brick layout, each rank a
    process (``tests/sharded_rank.py --backend gloo``) on this one card: the
    slabs' rows, the gathered rows and masks (B19e), each rank's block of
    160 of the 240x320 model maps' columns (B19f) and the blocks assembled,
    in bench.py's configuration over 10 frames of the orbit and its forced
    refresh over 4, then the stage with anchors finite only in rank 1's
    block. Every frame aligns with no overflow on both ranks, both ranks
    hold the same poses, maps and anchors, and the poses are the single
    engine's (the "main path, sharded bench" runs) within
    ``tests/test_sharded.py``'s bounds for the column-blocked marches (1e-3
    on frames 0-1, 2e-2 after) with an ATE under 0.02 m; each rank launches
    the path's kernels as its frames say (B19e's mask every frame, its
    distance on each refresh frame, B5b once and B4 twice a refresh frame);
    at the stage rank 0 refreshes and rank 1 takes the anchored march. The
    ranks' frame ms are printed: gloo carries the gathers through the host,
    so they say nothing of NVLink."""
    import dataclasses
    import pickle
    import tempfile

    from xslam_tpu_torch.utils.evaluation import ate_rmse, normalize_to_first

    jobs = [("bench", BENCH_OPTIONS, N_FRAMES_BENCH, "sharded_bench_poses"),
            ("refresh", dict(BENCH_OPTIONS, raycast_temporal_min_coverage=REFRESH_COVERAGE), N_FRAMES_REFRESH,
             "sharded_refresh_poses")]
    with tempfile.TemporaryDirectory() as tmp:
        spec = [{"name": name, "config": dataclasses.replace(ctx["config"], **opts), "frames": n}
                for name, opts, n, _ in jobs] + [{"name": "stage", "stage": "refresh"}]
        with open(os.path.join(tmp, "jobs.pkl"), "wb") as f:
            pickle.dump(spec, f)
        np.save(os.path.join(tmp, "depths.npy"), np.stack(ctx["depths"][:N_FRAMES_BENCH]))
        env = dict(os.environ, PYTHONPATH=ROOT)
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "sharded_rank.py"),
                                   os.path.join(tmp, "jobs.pkl"), os.path.join(tmp, "depths.npy"),
                                   os.path.join(tmp, "out"), "--rank", str(r), "--world-size", str(TWO_RANKS),
                                   "--init-method", "file://" + os.path.join(tmp, "rendezvous"), "--backend", "gloo"],
                                  cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(TWO_RANKS)]
        try:
            logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        seconds = time.perf_counter() - t0
        check(all(p.returncode == 0 for p in procs), f"two ranks: exit codes {[p.returncode for p in procs]}, "
                                                     f"rank 0's output's end: {logs[0][-2000:]}")
        ranks = [dict(np.load(os.path.join(tmp, f"out.{r}.npz"))) for r in range(TWO_RANKS)]
    result, counts = {}, {}
    for name, opts, n, single_key in jobs:
        r0, r1 = ({k.split(".", 1)[1]: v for k, v in r.items() if k.startswith(name + ".")} for r in ranks)
        same = all(np.array_equal(r0[k], r1[k], equal_nan=True) for k in ("pose_v", "pose_g", "align_ok", "overflow",
                                                                          "active", "vmap", "nmap", "t_prev"))
        single = ctx[single_key]
        err = [float(np.abs(a - b).max()) for a, b in zip(r0["pose_v"], single)]
        within = all(e <= (1e-3 if i <= 1 else 2e-2) for i, e in enumerate(err))
        ate = ate_rmse(normalize_to_first(list(r0["pose_v"])), normalize_to_first(ctx["gt"][:n]))
        launches = [{k.split(".", 1)[1]: int(v) for k, v in r.items() if k.startswith("launches.")} for r in (r0, r1)]
        refresh = n if opts.get("raycast_temporal_min_coverage", 0.5) > 1.0 else 0
        want = dict(event_mask=n, skip_distance=refresh, march_skip=refresh, skip_field=0,
                    window_march=n + refresh, model_map_normals=n, classify_bricks_slab=n, fuse_bricks_slab=n)
        finite = float(np.isfinite(r0["t_prev"]).mean())
        result[name] = dict(frames=n, ranks_equal=same, pose_err_to_single_engine=err, ate_m=ate,
                            all_aligned=bool(r0["align_ok"].all()), overflow=bool(r0["overflow"].any()),
                            local_active=[r0["local_active"].tolist(), r1["local_active"].tolist()],
                            t_prev_finite=finite, frame_ms=[r0["frame_ms"].tolist(), r1["frame_ms"].tolist()],
                            kernels=[{k: v for k, v in c.items() if v} for c in launches])
        check(same and within and ate < 0.02 and r0["align_ok"].all() and not r0["overflow"].any() and finite > 0.5,
              f"two ranks, {name}: {result[name]}")
        check(all(c[k] == v for c in launches for k, v in want.items()),
              f"two ranks, {name}: launches {launches}, expected {want}")
        counts[name] = launches[0]
    refresh = [ranks[r]["stage.refresh"].tolist() for r in range(TWO_RANKS)]
    emit("main path, sharded bench, 2 ranks", config="configs/synthetic.yaml", backend="gloo on one card",
         world_size=TWO_RANKS, block_columns=320 // TWO_RANKS, runs=result, stage_refresh_per_rank=refresh,
         seconds=seconds)
    check(refresh == [[True], [False]], f"two ranks: the stage's refresh per rank {refresh}, expected rank 0 only")
    return counts["refresh"]


def phase_levels(ctx):
    """C3, four pyramid levels on the card: K7, K8 and K6 (and K6 with the
    screen normals, B4n) at 4 levels give the 3-level launches' first three
    levels bit for bit and their plain versions' fourth (``pyr_down``,
    ``create_vmap`` + ``create_nmap``, ``resize_model_maps``); then
    ``XSlamEngine`` at ``num_levels=4`` (icp_iterations 5, 4, 3, 2) over 4
    frames, each launch made twice a frame."""
    import dataclasses

    from xslam_tpu_torch.models.kinfu import XSlamEngine, model_map_pyramid, resize_model_maps
    from xslam_tpu_torch.ops import kernels, preprocess
    from xslam_tpu_torch.utils.evaluation import ate_rmse, normalize_to_first

    cfg, dev = ctx["config"], ctx["device"]
    intr = cfg.intrinsics
    from xslam_tpu_torch.ops import raycast

    depth = kernels.bilateral_filter(torch.as_tensor(np.asarray(ctx["depths"][4], np.uint16), device=dev))
    d3, d4 = kernels.depth_pyramid(depth, 3), kernels.depth_pyramid(depth, 4)
    v3, n3 = kernels.vertex_normal_pyramid([intr.level(i) for i in range(3)], d3)
    v4, n4 = kernels.vertex_normal_pyramid([intr.level(i) for i in range(4)], d4)
    _, parts = _ray_pose(ctx, 3)
    vmap0, nmap0 = raycast.raycast(ctx["volume"], *parts, intr, ctx["engine_cfg"])
    m3, m4 = model_map_pyramid(vmap0, nmap0, 3), model_map_pyramid(vmap0, nmap0, 4)
    s3, s4 = model_map_pyramid(vmap0, None, 3), model_map_pyramid(vmap0, None, 4)
    plain_d = preprocess.pyr_down(d4[2])
    plain_v = preprocess.create_vmap(intr.level(3), d4[3])
    plain_m = resize_model_maps(m4[0][2], m4[1][2])
    torch.cuda.synchronize()
    first3 = dict(depth=_bits_all(d3, d4[:3]), vertex=_bits_all(v3, v4[:3]), normal=_bits_all(n3, n4[:3]),
                  model_maps=all(_bits_all((a.v, a.g), (b.v, b.g)) for a, b in zip(m3[0] + m3[1], m4[0][:3] + m4[1][:3])),
                  screen_model_maps=all(_bits_all((a.v, a.g), (b.v, b.g))
                                        for a, b in zip(s3[0] + s3[1], s4[0][:3] + s4[1][:3])))
    fourth = dict(depth=_bits_all((d4[3],), (plain_d,)), vertex=_bits_all((v4[3],), (plain_v,)),
                  normal=_bits_all((n4[3],), (preprocess.create_nmap(plain_v),)),
                  model_maps=_bits_all((m4[0][3].v, m4[0][3].g, m4[1][3].v, m4[1][3].g),
                                       (plain_m[0].v, plain_m[0].g, plain_m[1].v, plain_m[1].g)))
    n_frames = 4
    cfg4 = dataclasses.replace(cfg, num_levels=4, icp_iterations=(5, 4, 3, 2), end_frame=n_frames)
    engine = XSlamEngine(cfg4, device=dev)
    state = engine.init_state()
    kernels.reset_launch_counts()
    aligned = []
    for i in range(n_frames):
        state, res = engine.process_frame(state, ctx["depths"][i])
        engine.log_pose(res)
        aligned.append(bool(res.align_ok))
    counts = dict(kernels.launch_counts)
    ate = ate_rmse(normalize_to_first(engine.pose_log), normalize_to_first(ctx["gt"][:n_frames]))
    finite = all(bool(torch.isfinite(m.v[:, ~torch.isnan(m.v[0])]).all()) for m in state.vmaps_prev)
    emit("C3 four levels", first_three_levels_bit_equal=first3, fourth_level_bit_equal_to_plain=fourth,
         engine=dict(frames=n_frames, num_levels=4, icp_iterations=list(cfg4.icp_iterations), aligned=aligned,
                     ate_m=ate, model_maps_finite=finite, kernels={k: v for k, v in counts.items() if v}))
    check(all(first3.values()) and all(fourth.values()), f"C3: first three levels {first3}, fourth {fourth}")
    check(finite and all(counts[k] == 2 * n_frames for k in ("depth_pyramid", "vertex_normal_maps",
                                                            "resize_model_maps")),
          f"C3: the 4-level engine's maps finite {finite}, launches {counts}")
    return counts


# ------------------------------------------------------------------------- B18 and the sharded backend
# B18 at the loop backend's shapes (ROADMAP §B, PR 16's 300-frame ICL_loop_backend run on the H100): the
# observations bucketed to a multiple of 4096, 41 keyframes, 12,253 anchors, R = 4 residual rows (normals)
SCHUR_N, SCHUR_K, SCHUR_L, SCHUR_R = 45 * 4096, 41, 12_253, 4
SCHUR_SEED = 23
SCHUR_MAX_ULP = 1  # B18 against its plain passes: both sum in float64 and round once, in different orders
SCHUR_DAMPING = 1e-4  # schur_ba_cg's default
# the sharded BA phase's problem: tests/test_torch_ba.py::test_schur_ba_cg_large_scale's 60 keyframes x 6,000
# anchors, each seen by 4 keyframes (24,000 observations)
BA_SCALE = dict(K=60, L=6000, seed=7)
BA_ITERS = 4
BA_SHARDED_TOL = 1e-4  # tests/test_ba.py:165-167, :306-310: the sums' order changes over two ranks
B18_SOLVER_TOL = 1e-5  # schur_ba_cg with B18 against the plain passes on the card, poses
# B18's S x against the matvec before it (PR 16 to PR 22, the products summed by torch.sum in an order of its own):
# within this share of the outputs' largest magnitude (tests/test_torch_sharded_backend.py's PLAIN_PASS_TOL)
B18_BEFORE_TOL = 2e-6


def _schur_ops(R: int) -> dict:
    """float32 operations an observation of each pass (a product and a sum a
    term, the float64 adds of the outputs' lanes): pass L ``u = Jc x``
    (11 R), ``Jl^T u`` (3 (2R - 1)), 3 adds; pass K ``u`` (11 R), ``w =
    Hll_inv v`` (15), ``z = Jl w`` (5 R), ``Jc^T u`` and ``Jc^T z`` (12 (2R -
    1)), 12 adds."""
    return {"schur_cg_anchors": 11 * R + 3 * (2 * R - 1) + 3,
            "schur_cg_keyframes": 11 * R + 15 + 5 * R + 12 * (2 * R - 1) + 12}


def _schur_bytes(name: str, N: int, R: int, K: int, L: int) -> int:
    """Bytes a pass's function must move: Jc and Jl once, each observation's
    keyframe and anchor index (4 B each), x, and its sums written once; pass
    K also reads ``Hll_inv`` and ``v``. The kernel's sorted order and
    segment tables are its own design's, not counted."""
    keys, width = (L, 3) if name == "schur_cg_anchors" else (K, 12)
    extra = 0 if name == "schur_cg_anchors" else L * (36 + 12)
    return N * R * 9 * 4 + N * 8 + K * 24 + keys * width * 4 + extra


def _ulp_hist(a: torch.Tensor, b: torch.Tensor) -> dict:
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    d = (ordered(a) - ordered(b)).abs().reshape(-1)
    return {"0": int((d == 0).sum()), "1": int((d == 1).sum()), "2+": int((d >= 2).sum())}


def _ba_scale_problem(dev):
    """The sharded BA phase's seeded problem on ``dev``: (BAProblem, start
    poses, start anchors, numpy spec for ``tests/sharded_rank.py``'s "ba"
    job)."""
    from xslam_tpu_torch.geometry import se3
    from xslam_tpu_torch.models import ba

    rng = np.random.default_rng(BA_SCALE["seed"])
    K, L = BA_SCALE["K"], BA_SCALE["L"]
    gt = np.stack([np.array([2.0 * np.cos(0.05 * k), 0.02 * k, 2.0 * np.sin(0.05 * k), 0.0, 0.05 * k, 0.0],
                            np.float32) for k in range(K)])
    gt_T = np.stack([se3.exp_real(torch.as_tensor(x)).numpy() for x in gt])
    anchors = rng.uniform(-1.5, 1.5, size=(L, 3)).astype(np.float32)
    anchors[:, 2] += 4.0
    fi = rng.integers(0, K, size=(L, 4)).reshape(-1)
    ai = np.repeat(np.arange(L), 4)
    w2c = np.linalg.inv(gt_T)
    meas = np.einsum("nij,nj->ni", w2c[fi, :3, :3], anchors[ai]) + w2c[fi, :3, 3]
    poses = gt + np.concatenate([0.03 * rng.normal(size=(K, 3)), 0.01 * rng.normal(size=(K, 3))],
                                axis=1).astype(np.float32)
    poses[0] = gt[0]
    start = anchors + 0.03 * rng.normal(size=(L, 3)).astype(np.float32)
    spec = dict(frame_idx=fi.astype(np.int32), anchor_idx=ai.astype(np.int32), meas_cam=meas.astype(np.float32),
                poses=poses.astype(np.float32), anchors=start.astype(np.float32), iters=BA_ITERS)
    prob = ba.BAProblem(*(torch.as_tensor(spec[k], device=dev) for k in ("frame_idx", "anchor_idx", "meas_cam")))
    return prob, torch.as_tensor(spec["poses"], device=dev), torch.as_tensor(spec["anchors"], device=dev), spec


def _matvec_before(plan, Jc, Jl, Hll_inv, x, gauge):
    """``schur_ba_cg``'s ``S x`` before B18 (PR 16 to PR 22): the passes as
    PyTorch ops, the products summed by ``torch.sum``."""
    from xslam_tpu_torch.models import ba

    x = x * gauge
    u = ba._j(Jc, x[plan.ks])
    w = ba._block_solve(Hll_inv, plan.seg_l(ba._jT(Jl, u)))
    z = ba._j(Jl, w[plan.ls])
    hz = plan.seg_k(torch.cat([ba._jT(Jc, u), ba._jT(Jc, z)], 1))
    return (hz[:, :6] - hz[:, 6:] + SCHUR_DAMPING * x) * gauge


def _matvec_b18(plan, Jc, Jl, Hll_inv, x, gauge):
    """``schur_ba_cg``'s ``S x`` (the single form) through B18."""
    from xslam_tpu_torch.models import ba

    x = x * gauge
    v = ba.schur_cg_anchors(plan, Jc, Jl, x)
    hz = ba.schur_cg_keyframes(plan, Jc, Jl, Hll_inv, v, x)
    return (hz[:, :6] - hz[:, 6:] + SCHUR_DAMPING * x) * gauge


def phase_schur_cg(ctx):
    """B18 against its plain passes on a seeded problem of the loop backend's
    shape (184,320 observations sorted by keyframe as ``build_ba_problem``
    makes them, 41 keyframes, 12,253 anchors, R = 4): each output within
    ``SCHUR_MAX_ULP`` of the plain version's (the ulp histogram printed), S x
    within that of both outputs and within ``B18_BEFORE_TOL`` of the outputs'
    scale of the matvec before B18 (its histogram printed too), a second
    call's bits equal; each pass timed
    warm and cold beside its plain version and ``torch.segment_reduce`` over
    the pass's rows in its order (one pass's sum alone: a yardstick); the
    launches of one CG step's ``S x`` before B18 and through it; and
    ``schur_ba_cg`` on the sharded BA phase's problem through B18 and through
    the plain passes (poses within 1e-5)."""
    from xslam_tpu_torch.models import ba
    from xslam_tpu_torch.ops import kernels

    dev = ctx["device"]
    N, K, L, R = SCHUR_N, SCHUR_K, SCHUR_L, SCHUR_R
    rng = np.random.default_rng(SCHUR_SEED)
    ks = np.sort(rng.integers(0, K, N)).astype(np.int32)
    ls = rng.integers(0, L, N).astype(np.int32)
    gen = torch.Generator(device=dev).manual_seed(SCHUR_SEED)
    Jc = torch.randn((N, R, 6), generator=gen, device=dev)
    Jl = torch.randn((N, R, 3), generator=gen, device=dev)
    A = torch.randn((L, 3, 3), generator=gen, device=dev)
    Hll_inv = torch.linalg.inv_ex(A @ A.transpose(1, 2) + torch.eye(3, device=dev))[0].contiguous()
    gauge = ba._gauge(K, dev)
    x = torch.randn((K, 6), generator=gen, device=dev) * gauge
    prob = ba.BAProblem(torch.as_tensor(ks, device=dev), torch.as_tensor(ls, device=dev),
                        torch.zeros((N, 3), device=dev))
    plan = ba.SchurCgPlan(prob, K, L)
    v = ba.schur_cg_anchors(plan, Jc, Jl, x)
    v_plain = ba._anchors_plain(plan, Jc, Jl, x)
    hz = ba.schur_cg_keyframes(plan, Jc, Jl, Hll_inv, v_plain, x)
    hz_plain = ba._keyframes_plain(plan, Jc, Jl, Hll_inv, v_plain, x)
    torch.cuda.synchronize()
    again = (torch.equal(ba.schur_cg_anchors(plan, Jc, Jl, x), v)
             and torch.equal(ba.schur_cg_keyframes(plan, Jc, Jl, Hll_inv, v_plain, x), hz))
    sx, sx_plain = hz[:, :6] - hz[:, 6:], hz_plain[:, :6] - hz_plain[:, 6:]
    # the plain passes add each observation's products in B18's order; the matvec before them is held too
    sx_b18, sx_before = _matvec_b18(plan, Jc, Jl, Hll_inv, x, gauge), _matvec_before(plan, Jc, Jl, Hll_inv, x, gauge)
    vs_before = dict(ulp_histogram=_ulp_hist(sx_b18, sx_before), max_ulp=max_ulp(sx_b18, sx_before),
                     max_abs=max_abs(sx_b18, sx_before), frac_equal=frac_equal(sx_b18, sx_before),
                     share_of_scale=max_abs(sx_b18, sx_before) / float(sx_before.abs().max()))
    outs = {"schur_cg_anchors": (v, v_plain), "schur_cg_keyframes": (hz, hz_plain)}
    hists = {k: _ulp_hist(a, b) for k, (a, b) in outs.items()}
    worst = {k: max_ulp(a, b) for k, (a, b) in outs.items()}
    # each pass timed beside its plain version and its yardstick; then the matvec through B18 and the one before it
    calls = {"schur_cg_anchors": (lambda: ba.schur_cg_anchors(plan, Jc, Jl, x),
                                  lambda: ba._anchors_plain(plan, Jc, Jl, x)),
             "schur_cg_keyframes": (lambda: ba.schur_cg_keyframes(plan, Jc, Jl, Hll_inv, v_plain, x),
                                    lambda: ba._keyframes_plain(plan, Jc, Jl, Hll_inv, v_plain, x))}
    rows = {"schur_cg_anchors": (plan.seg_l, torch.randn((N, 3), generator=gen, device=dev)),
            "schur_cg_keyframes": (plan.seg_k, torch.randn((N, 12), generator=gen, device=dev))}
    ops = _schur_ops(R)
    result = {}
    for name, (kernel_call, plain_call) in calls.items():
        seg, contrib = rows[name]
        sorted_rows = contrib[seg.order].contiguous()
        lengths = (seg.end - seg.start).to(torch.int64)
        library = time_ms(lambda: torch.segment_reduce(sorted_rows, "sum", lengths=lengths, axis=0), 20)
        ms, cold = time_ms(kernel_call, 50), time_cold_ms(kernel_call, 20)
        plain = time_ms(plain_call, 5)
        n_bytes = _schur_bytes(name, N, R, K, L)
        bms, by = bound_ms(n_bytes, N * ops[name])
        a, b = outs[name]
        result[name] = dict(shape=dict(N=N, K=K, L=L, R=R), max_abs_err=max_abs(a, b), max_ulp=worst[name],
                            ulp_histogram=hists[name], frac_equal=frac_equal(a, b), ms=ms, cold_ms=cold,
                            plain_ms=plain, bound_ms=bms, bound_by=by, bound_bytes=n_bytes,
                            bound_ops=N * ops[name], library_ms=library,
                            library_note="torch.segment_reduce of the pass's rows in its order: one pass's sum "
                                         "alone, a yardstick")
    matvec_ms = time_ms(lambda: _matvec_b18(plan, Jc, Jl, Hll_inv, x, gauge), 20)
    before_ms = time_ms(lambda: _matvec_before(plan, Jc, Jl, Hll_inv, x, gauge), 5)
    before = _profiled_call(lambda: _matvec_before(plan, Jc, Jl, Hll_inv, x, gauge), kernel="schur_cg_kernel")
    after = _profiled_call(lambda: _matvec_b18(plan, Jc, Jl, Hll_inv, x, gauge), kernel="schur_cg_kernel")
    # schur_ba_cg through B18 and through the plain passes on the sharded BA phase's problem
    prob_s, poses, anchors, _ = _ba_scale_problem(dev)
    kernels.reset_launch_counts()
    with_b18 = ba.schur_ba_cg(poses, anchors, prob_s, iters=BA_ITERS)
    b18_launches = {k: kernels.launch_counts[k] for k in ("schur_cg_anchors", "schur_cg_keyframes")}
    passes = (ba.schur_cg_anchors, ba.schur_cg_keyframes)
    ba.schur_cg_anchors, ba.schur_cg_keyframes = ba._anchors_plain, ba._keyframes_plain
    try:
        plain_run = ba.schur_ba_cg(poses, anchors, prob_s, iters=BA_ITERS)
    finally:
        ba.schur_cg_anchors, ba.schur_cg_keyframes = passes
    solver_err = max_abs(with_b18.poses, plain_run.poses)
    emit("B18 schur_cg", card=ctx["card"], **{k: {kk: vv for kk, vv in r.items() if kk != "library_note"}
                                              for k, r in result.items()},
         sx_max_ulp=max_ulp(sx, sx_plain), sx_max_abs=max_abs(sx, sx_plain), second_call_bit_equal=again,
         sx_vs_matvec_before=vs_before,
         matvec_ms=matvec_ms, matvec_before_ms=before_ms,
         matvec_launches_before=before["device_events"], matvec_host_calls_before=before["host_calls"],
         matvec_launches_after=after["device_events"], matvec_host_calls_after=after["host_calls"],
         matvec_b18_device_ms=after["kernel_ms"], matvec_b18_events=after["kernel_events"],
         solver=dict(K=BA_SCALE["K"], L=BA_SCALE["L"], N=int(prob_s.frame_idx.shape[0]), iters=BA_ITERS,
                     b18_launches=b18_launches, poses_max_abs_vs_plain_passes=solver_err,
                     residual_last=float(with_b18.residual_history[-1]),
                     residual_last_plain=float(plain_run.residual_history[-1])))
    check(again, "B18: a second call gave other bits")
    check(all(w <= SCHUR_MAX_ULP for w in worst.values()), f"B18 against its plain passes: {worst} ulp, "
                                                            f"histograms {hists}")
    check(after["kernel_events"] == 2, f"B18: {after['kernel_events']} kernel events in one S x, expected 2")
    check(vs_before["share_of_scale"] <= B18_BEFORE_TOL, f"B18's S x against the matvec before it: {vs_before}")
    check(solver_err <= B18_SOLVER_TOL and b18_launches["schur_cg_anchors"] == BA_ITERS * 40,
          f"B18 in schur_ba_cg: poses {solver_err} from the plain passes', launches {b18_launches}")
    return result


def phase_sharded_ba(ctx):
    """The observation-sharded BA on the card: ``schur_ba(group=)`` and
    ``schur_ba_cg(group=)`` at one NCCL rank equal the single forms bit for
    bit on a seeded 60-keyframe, 6,000-anchor problem; over two ranks on this
    card (``tests/sharded_rank.py --backend gloo``, a ``"ba"`` job, each rank
    its half of the observations) both ranks hold the same bits, within 1e-4
    of the single forms."""
    import pickle
    import tempfile

    from xslam_tpu_torch.models import ba
    from xslam_tpu_torch.ops import kernels
    from xslam_tpu_torch.parallel.mesh import init_space_group

    dev = ctx["device"]
    if "space_group" not in ctx:
        ctx["space_group"] = init_space_group()
    group = ctx["space_group"]
    prob, poses, anchors, spec = _ba_scale_problem(dev)
    block = ba.observation_block(prob, group)
    single, one_rank, equal = {}, {}, {}
    for name, fn in (("dense", ba.schur_ba), ("cg", ba.schur_ba_cg)):
        single[name] = fn(poses, anchors, prob, iters=BA_ITERS)
        kernels.reset_launch_counts()
        one_rank[name] = fn(poses, anchors, block, iters=BA_ITERS, group=group)
        equal[name] = all(torch.equal(a, b) for a, b in zip(one_rank[name], single[name]))
    b18 = {k: kernels.launch_counts[k] for k in ("schur_cg_anchors", "schur_cg_keyframes")}
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "jobs.pkl"), "wb") as f:
            pickle.dump([{"name": "ba", "ba": spec}], f)
        np.save(os.path.join(tmp, "depths.npy"), np.zeros((1, 2, 2), np.uint16))
        env = dict(os.environ, PYTHONPATH=ROOT)
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "sharded_rank.py"),
                                   os.path.join(tmp, "jobs.pkl"), os.path.join(tmp, "depths.npy"),
                                   os.path.join(tmp, "out"), "--rank", str(r), "--world-size", str(TWO_RANKS),
                                   "--init-method", "file://" + os.path.join(tmp, "rendezvous"), "--backend", "gloo"],
                                  cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(TWO_RANKS)]
        try:
            logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        seconds = time.perf_counter() - t0
        check(all(p.returncode == 0 for p in procs), f"sharded BA, two ranks: exit codes "
                                                     f"{[p.returncode for p in procs]}: {logs[0][-2000:]}")
        ranks = [dict(np.load(os.path.join(tmp, f"out.{r}.npz"))) for r in range(TWO_RANKS)]
    two = {}
    for name in ("dense", "cg"):
        same = all(np.array_equal(ranks[0][f"ba.{name}_{k}"], ranks[1][f"ba.{name}_{k}"])
                   for k in ("poses", "anchors", "hist"))
        err = max(float(np.abs(ranks[0][f"ba.{name}_poses"] - single[name].poses.cpu().numpy()).max()),
                  float(np.abs(ranks[0][f"ba.{name}_anchors"] - single[name].anchors.cpu().numpy()).max()))
        two[name] = dict(ranks_equal=same, max_abs_to_single=err, residual_last=float(ranks[0][f"ba.{name}_hist"][-1]))
    emit("sharded BA", card=ctx["card"], K=BA_SCALE["K"], L=BA_SCALE["L"], N=int(prob.frame_idx.shape[0]),
         iters=BA_ITERS, one_rank=dict(backend=group.backend, world_size=group.world_size, bit_equal=equal,
                                       b18_launches_cg=b18),
         two_ranks=dict(backend="gloo on one card", rows_per_rank=int(ranks[0]["ba.rows"]), seconds=seconds, **two),
         residual_last={k: float(r.residual_history[-1]) for k, r in single.items()})
    check(all(equal.values()), f"sharded BA at one rank: not the single forms' bits {equal}")
    check(all(t["ranks_equal"] and t["max_abs_to_single"] <= BA_SHARDED_TOL for t in two.values()),
          f"sharded BA over two ranks: {two}")
    return {"one_rank_bit_equal": equal, "two_ranks": two}


def phase_backend_sharded_blackout(ctx):
    """The blackout run of "backend, blackout" (the same 60 frames of
    configs/ICL_blackout.yaml's rendered data) through ``run_slam --sharded``
    at one NCCL rank: ``RecoveringEngine`` over ``ShardedXSlamEngine``, then
    the refinement (B18 in ``schur_ba_cg``). Its ATE, recovery events,
    keyframes and refined ATE are the single engine's, to every digit."""
    t0 = time.perf_counter()
    root = _backend_data(ctx)
    n = BACKEND_RUNS["blackout"][1]
    run, parsed, probe, info = backend_run("blackout", root, n, ctx["card"], extra=("--sharded",),
                                           out_tag="blackout_sharded")
    ate, refined, events, keyframes, single_info = ctx["backend_blackout_run"]
    same = dict(ate=run.ate == ate, refined_ate=run.refined_ate == refined,
                recovery_events=list(run.engine.recovery_events) == events,
                keyframes=[k.frame_index for k in run.engine.keyframes] == keyframes)
    info.update(engine=type(run.engine.engine).__name__, ate_full=run.ate, refined_ate_full=run.refined_ate,
                single_engine_ate_full=ate, single_engine_refined_ate_full=refined, equal_to_single_engine=same,
                single_engine_schur_ba_cg_s=single_info["schur_ba_cg_s"], phase_s=time.perf_counter() - t0)
    emit("backend, sharded blackout", **info)
    _check_backend_common("blackout", run, parsed, probe, n, root, out_tag="blackout_sharded")
    check(type(run.engine.engine).__name__ == "ShardedXSlamEngine", f"sharded blackout: wrapped {info['engine']}")
    check(all(same.values()), f"sharded blackout: not the single engine's run: {same}")
    return info


# the phases in their order: (name, function)
PHASES = (("rounding", phase_rounding), ("bilateral_filter", phase_bilateral), ("fuse_volume", phase_fusion),
          ("bricks", phase_bricks), ("bilinear", phase_bilinear), ("B15", phase_b15), ("march_fixed", phase_march),
          ("raycast_refine", phase_refine), ("window", phase_window), ("normals", phase_normals), ("skip", phase_skip),
          ("brick refine", phase_brick_refine), ("first-event window", phase_first_event),
          ("dense marches", phase_dense_marches), ("extract", phase_extract), ("B17 meshers", phase_meshers),
          ("maps", phase_maps), ("icp_system", phase_icp), ("B19", phase_b19), ("B19 columns", phase_b19_columns),
          ("four levels", phase_levels),
          ("tsdf_loss", phase_tsdf_loss), ("schur_cg", phase_schur_cg),
          ("relocalize path", phase_relocalize_path), ("odometry path", phase_odometry_path),
          ("probes", phase_probes),
          ("main path", phase_main_path),
          ("main path, fixed association", phase_main_path_fixed_assoc),
          ("main path, brick fusion", phase_main_path_brick),
          ("main path, bench", phase_main_path_bench),
          ("A12", phase_a12),
          ("main path, bench refresh", phase_main_path_bench_refresh),
          ("main path, hier2", phase_main_path_hier2),
          ("main path, skip", phase_main_path_skip),
          ("main path, hier", phase_main_path_hier),
          ("main path, hier_skip", phase_main_path_hier_skip),
          ("main path, bench bilinear", phase_main_path_bench_bilinear),
          *((tag, lambda ctx, tag=tag: phase_main_path(ctx, tag)) for tag in BRICK_RAYCASTS),
          *((tag, lambda ctx, tag=tag: phase_main_path(ctx, tag)) for tag in B15_RUNS),
          *((tag, lambda ctx, tag=tag: phase_main_path_sharded(ctx, tag)) for tag in SHARDED_RUNS),
          ("main path, sharded bench refresh, 2 ranks", phase_main_path_sharded_two_ranks),
          ("sharded BA", phase_sharded_ba),
          ("process_frames", phase_process_frames),
          ("main path, ICL realistic", phase_main_path_icl),
          ("main path, 7-Scenes realistic", phase_main_path_7scenes),
          ("backend, blackout", phase_backend_blackout),
          ("backend, loop", phase_backend_loop),
          ("backend, realistic", phase_backend_realistic),
          ("backend, sharded blackout", phase_backend_sharded_blackout))


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"


def make_context(card: str) -> dict:
    """The phases' shared inputs: the synthetic orbit's configuration, depths and poses."""
    from xslam_tpu_torch.io.config import load_config
    from xslam_tpu_torch.io.synthetic import SyntheticDataset
    from xslam_tpu_torch.models.kinfu import XSlamEngine

    config = load_config(os.path.join(ROOT, "configs", "synthetic.yaml"))
    config.end_frame = N_FRAMES
    n_depths = N_FRAMES + PROFILE_RETAKES  # a main path's frames and the frames a retaken profile takes
    ds = SyntheticDataset(n_frames=n_depths, intr=config.intrinsics)
    return {
        "card": card,
        "device": torch.device("cuda"),
        "config": config,
        "engine_cfg": XSlamEngine(config).vol_cfg,
        "depths": [ds.get_depth(i) for i in range(n_depths)],
        "gt": [ds.get_pose(i) for i in range(n_depths)],
    }


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import xslam_tpu_torch  # noqa: F401  (sets the float32 precision pins)
    from xslam_tpu_torch.ops import kernels

    card = card_name()
    print(f"card: {card}", flush=True)
    print(f"pins: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    kernels.build_kernels()
    emit("build", seconds=time.perf_counter() - t0)

    ctx = make_context(card)

    results, failed = {}, []
    for name, phase in PHASES:
        if name == "probes":
            ctx.pop("volume", None)  # a main path's peak memory counts its own volume only
            ctx.pop("bench_inputs", None)
        try:
            results[name] = phase(ctx)
        except Exception:  # noqa: BLE001 — report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
        torch.cuda.synchronize()
    if torch.distributed.is_initialized():  # the sharded runs' group of one
        torch.distributed.destroy_process_group()
    if "backend_data" in ctx:
        import shutil

        shutil.rmtree(ctx["backend_data"], ignore_errors=True)

    if failed:
        print(f"chip_smoke: FAILED phases: {failed}", file=sys.stderr)
        return 1
    results.pop("rounding")
    results["icp_associate"] = ctx["icp_associate"]
    results.update(results.pop("tsdf_loss"))  # B12 and its band pass
    results["tsdf_loss"].update(ctx["tsdf_loss_path"])
    results["tsdf_loss"].update(ctx["backend_b12"])  # the blackout phase's relocalize calls and B12 launches
    results["tsdf_band"].update(ctx["tsdf_band_path"])
    results["tsdf_band"].update(ctx["backend_band"])
    results.update(results.pop("probes"))
    results.update(results.pop("maps"))
    results.update(results.pop("bricks"))
    results.update(results.pop("window"))
    results.update(results.pop("normals"))
    results.update(results.pop("skip"))
    results.update(results.pop("brick refine"))
    results.update(results.pop("first-event window"))
    results.update(results.pop("extract"))
    results.update(results.pop("B17 meshers"))
    results.pop("A12")
    results.update(results.pop("bilinear"))
    results.update(results.pop("B15"))
    results.update(results.pop("march_fixed"))
    results.update(results.pop("dense marches"))
    results.update(results.pop("B19"))
    results.update(results.pop("B19 columns"))
    results.update(results.pop("schur_cg"))
    # B5b's latency floor: its longest ray's rounds, each at least one dependent gather of probe E
    skip = results["march_skip"]
    skip["latency_floor_ms"] = skip["longest_ray_rounds"] * results["probe_e"]["ms"] / PROBE_E_STEPS
    counts = {path: results[path] for path in ("main path", "main path, fixed association", "main path, brick fusion",
                                               "main path, bench", "main path, bench refresh", "main path, hier2",
                                               "main path, skip", "main path, hier", "main path, hier_skip",
                                               "main path, bench bilinear", *BRICK_RAYCASTS, *B15_RUNS,
                                               *SHARDED_RUNS, "main path, sharded bench refresh, 2 ranks",
                                               "main path, ICL realistic", "main path, 7-Scenes realistic",
                                               "relocalize path", "odometry path")}
    counts["probe path"] = ctx["probe_counts"]
    counts["backend, blackout"] = {**{k: 0 for k in KERNELS}, **results["backend, blackout"]["kernels"]}
    table = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep, "path": path, "launches": counts[path][k],
         **({"folded_into": FOLDED[k]} if k in FOLDED else {}),
         **({"device_kernels_per_launch": list(DEVICE_KERNELS[k])} if k in DEVICE_KERNELS else {}),
         **{"library_ms": None, **results[k]}}
        for k, (src, rep, path) in KERNELS.items()
    ]
    never = [row["name"] for row in table if row["launches"] < 1 and row["name"] not in FOLDED]
    if never:
        print(f"chip_smoke: kernels never launched on their path: {never}", file=sys.stderr)
        return 1
    emit("wall", seconds=time.perf_counter() - t_start)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
