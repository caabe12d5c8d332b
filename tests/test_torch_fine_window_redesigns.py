"""The schedules of two redesigned kernels, held on the CPU (a CUDA kernel
cannot run here; the smoke run holds the kernels themselves to their plain
versions and to their earlier designs on the card).

- B15f, the fine classifier (``csrc/bricks.cu``, ``classify_bricks_fine_kernel``):
  a numpy twin of its lanes (a brick's ``lanes`` lanes in groups of two, each
  group classifying its share of the brick's 8 subcells in turn, the groups'
  classes folded by ballots of their leaders masked to the brick's lanes)
  and of its ranks over tiles of ``threads / lanes`` bricks (the single-pass
  scan's twin of ``tests/test_torch_fusion_brick.py``) gives
  ``classify_bricks_fine_plain`` + ``rank_bricks_plain`` bit for bit at every
  lanes a brick and block size the kernel was swept at, on the classifier
  scenes of ``tests/test_torch_fusion_classifiers.py`` and on seeded subcell
  grids with a cut last tile; and the wrapper's tile is the source's.
- B14c, the dense window repair (``csrc/window.cu``, ``window_dense_kernel``):
  a torch twin of its schedule (prev and every step of a round of
  ``BATCH`` read before any test, the steps tested in order, the next
  round only while an event is unknown) gives ``_window_repair``'s events bit
  for bit at windows 8, 12 and one above the round, strides 1 and 2, on the
  volume of ``tests/test_torch_dense_marches.py``'s scene (the small sweep's
  three frames, fused here by the port at their ground-truth poses) and on a
  sphere's volume seen from inside and from outside the volume; and the
  round covers every caller's window.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.helpers import small_config, small_dataset
from tests.test_torch_fusion_brick import _cfgs, _twin_scan
from tests.test_torch_fusion_classifiers import CLASS_CASES, TINTR, _inputs
from xslam_tpu_torch.csfd.single import CSFD
from xslam_tpu_torch.geometry import se3 as tse3
from xslam_tpu_torch.geometry.intrinsics import Intrinsics
from xslam_tpu_torch.ops import fusion as tfusion
from xslam_tpu_torch.ops import fusion_brick as tbrick
from xslam_tpu_torch.ops import kernels
from xslam_tpu_torch.ops import raycast as tray
from xslam_tpu_torch.ops.kernels import INF_T, RAY_MAX_M, RAY_MIN_M
from xslam_tpu_torch.ops.sampling import gather3d, to_index

CSRC = Path(__file__).resolve().parents[1] / "xslam_tpu_torch" / "csrc"


def _source_constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m is not None, f"{source} has no constexpr int {name}"
    return int(m.group(1))


CORNER_LANES = _source_constant("bricks.cu", "CORNER_LANES")
DENSE_ROUND = _source_constant("window.cu", "BATCH")  # the steps window_dense_kernel reads before it tests them


# ------------------------------------------------------------------ B15f
def fine_classes_twin(sub: np.ndarray, threads: int, lanes: int, box: int) -> np.ndarray:
    """A numpy twin of B15f's classes, lane by lane: ``sub`` the (X/4, Y/4,
    Z/4) subcell classes. Lane t of a launch of ``threads``-thread blocks
    (block = tile, in ticket order: the classes do not depend on it) takes
    brick ``tile * threads / lanes + tid / lanes``; its group ``q`` of
    ``box`` lanes classifies subcells ``q * S .. q * S + S - 1`` (S = 8 /
    groups, the box of subcell k at (2 bx + k >> 2, 2 by + (k >> 1) & 1, 2 bz
    + k & 1)) and ANDs their tests; with more than one group, a warp ballot of
    the group leaders' negated tests, shifted to the brick's first lane and
    masked to its lanes, folds them. Returns the flat classes (NONE past the
    volume's end is not written)."""
    nbx, nby, nbz = (s // 2 for s in sub.shape)
    n = nbx * nby * nbz
    tile = threads // lanes
    groups = lanes // box
    serial = 8 // groups
    t = np.arange(-(-n // tile) * threads)
    tid = t % threads
    lane = tid % 32
    b = (t // threads) * tile + tid // lanes
    bb = np.minimum(b, n - 1)
    bz, by, bx = bb % nbz, (bb // nbz) % nby, bb // (nby * nbz)
    q = (lane & (lanes - 1)) // box
    all_none = np.ones(t.shape, bool)
    all_far, all_farish = all_none.copy(), all_none.copy()
    for i in range(serial):
        k = q * serial + i
        sc = sub[2 * bx + (k >> 2), 2 * by + ((k >> 1) & 1), 2 * bz + (k & 1)]
        all_none &= sc == tbrick.NONE
        all_far &= sc == tbrick.FAR
        all_farish &= (sc == tbrick.FAR) | (sc == tbrick.FAR_PARTIAL)
    if groups > 1:
        group_leader = (lane & (box - 1)) == 0
        shift = lane & ~(lanes - 1)
        mask = (1 << lanes) - 1
        warp = t // 32

        def fold(flag):
            bits = (group_leader & ~flag).astype(np.int64) << lane
            ballot = np.bincount(warp, weights=bits).astype(np.int64)  # distinct bits: the sum is the OR
            return ((ballot[warp] >> shift) & mask) == 0

        all_none, all_far, all_farish = fold(all_none), fold(all_far), fold(all_farish)
    c = np.where(all_none, tbrick.NONE,
                 np.where(all_far, tbrick.FAR, np.where(all_farish, tbrick.FAR_PARTIAL, tbrick.ACTIVE)))
    c = np.where(b >= n, tbrick.NONE, c)
    leader = ((lane & (lanes - 1)) == 0) & (b < n)
    cls = np.full(n, -1, np.int32)
    cls[b[leader]] = c[leader]
    assert (cls >= 0).all()  # every brick written once, by its leader
    return cls


# (lanes a subcell, lanes a brick, threads a block) as the kernel was swept
SWEPT = ([(CORNER_LANES, lanes, threads) for lanes in (2, 4, 8, 16) for threads in (256, 512, 1024)]
         + [(1, 1, 256), (1, 2, 256), (1, 2, 512), (1, 4, 512), (1, 4, 768), (1, 4, 1024), (1, 8, 512), (1, 8, 1024),
            (1, 1, 1024), (1, 2, 1024)])


@functools.lru_cache(maxsize=None)
def _fine_case(name):
    """(4^3 grid classes, fine plain classes) of a classifier scene."""
    _, _, tcfg = _cfgs()
    _, _, _, table, pose = _inputs(name)
    sub = tbrick.classify_bricks_full_plain(table, pose, TINTR, tcfg, cell=tbrick.SUBCELL).cls.numpy()
    return sub, tbrick.classify_bricks_fine_plain(table, pose, TINTR, tcfg).reshape(-1)


def _seeded_grid(seed: int, nb=(5, 7, 9)):
    """Random subcell classes on a grid of ``nb`` bricks (315: a cut last tile at every swept tile), each brick's
    eight drawn from one of the fold's cases."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(nb))
    pools = ([tbrick.NONE], [tbrick.FAR], [tbrick.FAR, tbrick.FAR_PARTIAL], [tbrick.NONE, tbrick.FAR],
             [0, 1, 2, 3])
    kind = rng.integers(0, len(pools), n)
    s8 = np.stack([rng.choice(pools[k], 8) for k in kind]).astype(np.int32)
    sub = s8.reshape(*nb, 2, 2, 2).transpose(0, 3, 1, 4, 2, 5).reshape(*(2 * x for x in nb))
    t = torch.from_numpy(s8)  # the fold of classify_bricks_fine_plain, on these classes
    fine = torch.where((t == tbrick.NONE).all(-1), tbrick.NONE,
                       torch.where((t == tbrick.FAR).all(-1), tbrick.FAR,
                                   torch.where(((t == tbrick.FAR) | (t == tbrick.FAR_PARTIAL)).all(-1),
                                               tbrick.FAR_PARTIAL, tbrick.ACTIVE))).to(torch.int32)
    return sub, fine


def _check_fine(sub, fine_plain, threads, lanes, box, rng):
    cls = fine_classes_twin(sub, threads, lanes, box)
    np.testing.assert_array_equal(cls, fine_plain.numpy())
    n_active = int((fine_plain == tbrick.ACTIVE).sum())
    for cap in (max(n_active - 1, 0), len(cls)):
        plain = tbrick.rank_bricks_plain(fine_plain, cap)
        rank, active_ids, work_ids, totals, overflow, _, _ = _twin_scan(cls, cap, rng, None, 5, threads, lanes)
        n_act, n_work = plain.totals.tolist()
        assert list(totals) == [n_act, n_work] and overflow == bool(plain.overflow)
        assert np.array_equal(rank, plain.rank.numpy())
        assert np.array_equal(active_ids[:n_act], plain.active_ids[:n_act].numpy())
        assert np.array_equal(work_ids[:n_work], plain.work_ids[:n_work].numpy())


@pytest.mark.parametrize("box, lanes, threads", SWEPT)
def test_fine_schedule_equals_the_plain_classes_and_ranks(box, lanes, threads):
    rng = np.random.default_rng(box * lanes * threads)
    for name in CLASS_CASES:
        sub, fine = _fine_case(name)
        _check_fine(sub, fine, threads, lanes, box, rng)
    for seed in range(2):
        sub, fine = _seeded_grid(seed)
        _check_fine(sub, fine, threads, lanes, box, rng)


def test_fine_cases_cover_the_fold():
    """The scenes and grids hold every class the fold makes, and bricks that mix NONE with far subcells."""
    seen, mixed = set(), 0
    for name in CLASS_CASES:
        sub, fine = _fine_case(name)
        seen |= set(fine.tolist())
    sub, fine = _seeded_grid(0)
    seen |= set(fine.tolist())
    s = torch.from_numpy(sub).reshape(5, 2, 7, 2, 9, 2).permute(0, 2, 4, 1, 3, 5).reshape(-1, 8)
    mixed = int(((s == tbrick.NONE).any(-1) & (s == tbrick.FAR).any(-1) & (fine == tbrick.ACTIVE)).sum())
    assert seen == {tbrick.NONE, tbrick.FAR, tbrick.ACTIVE, tbrick.FAR_PARTIAL} and mixed > 0


def test_fine_tile_is_the_sources():
    box, lanes, threads = (_source_constant("bricks.cu", name)
                           for name in ("FINE_BOX_LANES", "FINE_LANES", "FINE_THREADS"))
    assert (box, lanes, threads) == (tbrick.FINE_BOX_LANES, tbrick.FINE_LANES, tbrick.FINE_THREADS)
    assert (box, lanes, threads) in SWEPT
    assert tbrick.FINE_TILE == threads // lanes < 2 ** 11  # STATUS_COUNT_BITS bounds a tile's counts
    assert tbrick.CLASSIFY_TILE == _source_constant("bricks.cu", "CLASSIFY_THREADS") // CORNER_LANES
    assert tbrick.classify_tiles(32768, fine=True) == 32768 // tbrick.FINE_TILE
    assert tbrick.classify_tiles(1000, fine=True) == -(-1000 // tbrick.FINE_TILE)
    assert tbrick.classify_tiles(32768) == 32768 // tbrick.CLASSIFY_TILE


# ------------------------------------------------------------------ B14c
def window_round_twin(ray_start: CSFD, dirs_v, coarse, window: int, cfg, value, round_: int = DENSE_ROUND):
    """A torch twin of ``window_dense_kernel``'s schedule: each anchored ray
    reads prev (the clamped voxel of t_begin) and the ``round_`` steps of a
    round before it tests any (a step past the window or past 5 m, or whose
    voxel lies outside, reads 0 + 1e-5), tests them in order (the first
    crossing and the first death by step), and reads the next round only
    while one of the two is unknown. The anchors and the arithmetic are
    ``_window_repair``'s (on the CPU both divide truly)."""
    voxel, step = cfg.voxel_size, cfg.trunc_dist * 0.8
    X, Y, Z = value.shape
    H, W = dirs_v.shape[-2:]
    t0 = tray.window_anchor(coarse, H, W)
    has_anchor = t0 < INF_T
    k0 = torch.floor((torch.where(has_anchor, t0, RAY_MIN_M) - RAY_MIN_M) / step) - 1.0
    t_begin = RAY_MIN_M + torch.clamp(k0, min=0.0) * step
    s = ray_start.v[:, None, None]

    def voxel_of(t):
        return to_index(torch.floor((s + dirs_v * t) / voxel))

    g = voxel_of(t_begin)
    prev = gather3d(value, g[0].clamp(0, X - 1), g[1].clamp(0, Y - 1), g[2].clamp(0, Z - 1)) + 1e-5
    kc = torch.full((H, W), -1, dtype=torch.int64)
    kd = torch.full((H, W), -1, dtype=torch.int64)
    marching = has_anchor.clone()
    for base in range(0, window, round_):
        # the round's reads, all before any test
        smp, live, inside = [], [], []
        for j in range(round_):
            k = base + j
            t_curr = t_begin + kernels.f32(np.float32(k) * np.float32(step))
            gk = voxel_of(t_curr + step)
            ins = (gk[0] >= 0) & (gk[0] < X) & (gk[1] >= 0) & (gk[1] < Y) & (gk[2] >= 0) & (gk[2] < Z)
            lv = marching & (k < window) & (t_curr < RAY_MAX_M)
            smp.append(torch.where(lv & ins, gather3d(value, gk[0], gk[1], gk[2]), 0.0) + 1e-5)
            live.append(lv)
            inside.append(ins)
        for j in range(round_):  # then the tests, in order
            tsdf = smp[j]
            crossing = live[j] & inside[j] & (prev > 0.0) & (tsdf < 0.0)
            death = live[j] & (~inside[j] | ((prev < 0.0) & (tsdf > 0.0)))
            kc = torch.where(crossing & (kc < 0), base + j, kc)
            kd = torch.where(death & (kd < 0), base + j, kd)
            prev = tsdf
        marching = marching & ~((kc >= 0) & (kd >= 0))
        if not bool(marching.any()):
            break
    def time_of(k):  # the step's t_curr, t_begin + float32(k * step), as the serial loop records it
        return torch.where(k >= 0, t_begin + k.clamp(min=0).to(torch.float32) * np.float32(step), INF_T)

    return time_of(kc), time_of(kd)


@functools.lru_cache(maxsize=None)
def _scene():
    """The small sweep's first three frames fused by the port at their ground-truth poses (the volume of
    tests/test_torch_dense_marches.py's scene), and the rays of frame 2's pose."""
    cfg = small_config()
    ds = small_dataset(3, degrees_per_frame=1.0)
    vcfg = tfusion.VolumeConfig(tuple(cfg.tsdf_size), cfg.voxel_size, cfg.trunc_dist, cfg.max_integration_weight)
    intr = Intrinsics(*ds.intr)
    w2v = np.asarray(cfg.world2volume, np.float32)
    vol = tfusion.create_volume(vcfg, "cpu")
    for i in range(3):
        c2v = torch.from_numpy((w2v @ ds.get_pose(i)).astype(np.float32))
        v2c = tse3.inverse(CSFD(c2v, torch.zeros(4, 4)))
        depth = tfusion.scale_depth(torch.from_numpy(np.asarray(ds.get_depth(i))))
        tfusion.integrate(vol, depth, tse3.rotation(v2c), tse3.translation(v2c), intr, vcfg)
    return vol.value, vcfg, _c2v_rays(w2v @ ds.get_pose(2), intr)


def _c2v_rays(c2v: np.ndarray, intr: Intrinsics):
    r = CSFD(torch.from_numpy(np.ascontiguousarray(c2v[:3, :3], np.float32)), torch.zeros(3, 3))
    t = CSFD(torch.from_numpy(np.ascontiguousarray(c2v[:3, 3], np.float32)), torch.zeros(3))
    ray_dir, ray_start = kernels.camera_rays(r, t, intr)
    return ray_start, ray_dir.v


@functools.lru_cache(maxsize=None)
def _sphere():
    """A sphere's volume (tests/test_torch_cg_march_redesigns.py's) seen from inside the volume and from outside
    it, each camera's rays."""
    from tests.test_torch_cg_march_redesigns import N_VOX, TRUNC, VOXEL, _cameras, _sphere_value

    vcfg = tfusion.VolumeConfig((N_VOX,) * 3, VOXEL, TRUNC, 100.0)
    return _sphere_value(), vcfg, [(ray_start, dirs) for dirs, ray_start in _cameras().values()]


def _scenes():
    value, vcfg, rays = _scene()
    yield value, vcfg, rays
    value, vcfg, cams = _sphere()
    for rays in cams:
        yield value, vcfg, rays


def _coarse(value, vcfg, ray_start, dirs_v, stride):
    """The coarse hits one level above a march at ``stride``: the plain fixed march at twice the stride."""
    d = dirs_v[:, :: 2 * stride, :: 2 * stride]
    return tray.RaycastHit(*kernels.march_fixed_plain(value, ray_start, CSFD(d, torch.zeros_like(d)),
                                                      vcfg.voxel_size, vcfg.trunc_dist))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("window", [DENSE_ROUND + 1, 8, 12, 13])
def test_window_round_schedule_equals_the_window_repair(window, stride):
    for value, vcfg, (ray_start, dirs_v) in _scenes():
        coarse = _coarse(value, vcfg, ray_start, dirs_v, stride)
        d = dirs_v[:, ::stride, ::stride]
        plain = tray._window_repair(ray_start, d, coarse, window, vcfg, tray._dense_reader(value),
                                    tuple(value.shape))
        t_found, t_dead = window_round_twin(ray_start, d, coarse, window, vcfg, value)
        assert torch.equal(t_found, plain.t_found) and torch.equal(t_dead, plain.t_dead)


def test_window_cases_cover_the_events():
    """Crossings, deaths, rays without an anchor and rays that know both events within the first round."""
    value, vcfg, (ray_start, dirs_v) = _scene()
    coarse = _coarse(value, vcfg, ray_start, dirs_v, 1)
    plain = tray._window_repair(ray_start, dirs_v, coarse, 12, vcfg, tray._dense_reader(value), tuple(value.shape))
    assert (plain.t_found < INF_T).float().mean() > 0.5 and (plain.t_dead < INF_T).any()
    assert any((tray.window_anchor(_coarse(v, c, s, d, 1), *d.shape[-2:]) >= INF_T).any()
               for v, c, (s, d) in _scenes())
    # a window one above the round: some ray records an event in the second round
    second = False
    for v, c, (s, d) in _scenes():
        coarse = _coarse(v, c, s, d, 1)
        longer, shorter = (window_round_twin(s, d, coarse, w, c, v) for w in (DENSE_ROUND + 1, DENSE_ROUND))
        second = second or any(bool((a != b).any()) for a, b in zip(longer, shorter))
    assert second

