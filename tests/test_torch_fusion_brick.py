"""The port's brick fusion (``xslam_tpu_torch.ops.fusion_brick``, plain
versions of kernels B3a-c) against ``xslam_tpu.ops.fusion_brick`` and against
the port's own dense fusion, on the CPU at the tests' scale (64^3 at 0.12 m,
160x120 depth).

- The mip table (B3a) equals the JAX package's ``_depth_mips`` bit for bit,
  its +inf / -inf / valid pads included.
- The classes (B3b) equal ``classify_bricks_full(split=False)``'s on at
  least 99.9% of bricks at the orbit, a volume corner and the JAX tests'
  window-misalignment regression pose: XLA on the CPU may fuse a
  multiply-add that PyTorch rounds twice, which can move a bound by an ulp.
  (On these inputs every brick agreed.)
- The port's ``integrate_brick`` equals the port's dense ``integrate`` bit
  for bit (``torch.equal`` on all three planes), also with a seeded
  derivative lane; against JAX's ``integrate_brick`` within K2's tolerances
  (weights >= 99.99% equal, value and grad within 1e-5 where they agree).
- The overflow: ``cap=4`` raises the flag as the JAX function does, and
  ``"flag"`` leaves the same bricks unfused; in the engine the flag
  propagates, ``"dense"`` gives the dense engine's volume bit for bit, and
  a brick-fusion run lies in the JAX brick engine's ATE class.
- B3b gives a brick eight lanes, a corner each, reduced by xor shuffles,
  picks the level by ballots and divides by a multiply-high, then ranks the
  bricks by a single-pass scan over tiles taken by ticket; B3a walks pixel
  columns with lanes adjacent in x and reduces each tile in a group of
  lanes, and B3c gives a warp a brick and a lane two z columns. Their numpy
  twins here show the division exact, the level and the classes the plain
  version's in any reduction order, the ranks flat brick order however the
  blocks interleave (and again on the same scratch), every pixel read once
  and every mip row with one owner (the twin's table the plain version's),
  every voxel of a brick visited once with the plain order of its
  camera-coordinate sums, and every work item taken once.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.helpers import SMALL_INTR, small_config, small_dataset, small_scene
from tests.torch_port_helpers import seeded_pose_direction, to_torch, torch_config
from xslam_tpu.csfd.single import CSFD as JCSFD
from xslam_tpu.io.synthetic import render_depth
from xslam_tpu.models.kinfu import XSlamEngine as JaxEngine
from xslam_tpu.ops import fusion as jfusion
from xslam_tpu.ops import fusion_brick as jbrick
from xslam_tpu.utils.evaluation import ate_rmse, normalize_to_first
from xslam_tpu_torch.geometry.intrinsics import Intrinsics
from xslam_tpu_torch.models.kinfu import XSlamEngine as TorchEngine
from xslam_tpu_torch.ops import fusion as tfusion
from xslam_tpu_torch.ops import fusion_brick as tbrick
from xslam_tpu_torch.ops import kernels

TINTR = Intrinsics(*SMALL_INTR)


def _cfgs():
    cfg = small_config()
    args = (tuple(cfg.tsdf_size), cfg.voxel_size, cfg.trunc_dist, cfg.max_integration_weight)
    return cfg, jfusion.VolumeConfig(*args), tfusion.VolumeConfig(*args)


def _look_at(eye, target):
    """Camera-to-volume pose of a camera at ``eye`` looking at ``target``."""
    z = (target - eye) / np.linalg.norm(target - eye)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    c2v = np.eye(4)
    c2v[:3, :3] = np.stack([x, np.cross(z, x), z], axis=1)
    c2v[:3, 3] = eye
    return c2v


def _regression_c2w():
    """tests/test_fusion_brick.py::test_window_misalignment_regression's pose:
    trial 9 of its seeded sweep."""
    rng = np.random.default_rng(0)
    for _ in range(9):
        rng.uniform(-0.4, 0.4, 3), rng.uniform(-0.5, 0.5, 3)
    ang, t = rng.uniform(-0.4, 0.4, 3), rng.uniform(-0.5, 0.5, 3)
    c, s = np.cos(ang), np.sin(ang)
    rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
    ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
    rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = (rx @ ry @ rz).astype(np.float32)
    c2w[:3, 3] = t
    return c2w


def _case(name):
    """(volume->camera pose (4, 4) float32, depth uint16) of a named case."""
    cfg = small_config()
    w2v = np.asarray(cfg.world2volume, np.float32)
    if name == "orbit":
        ds = small_dataset(4, degrees_per_frame=1.0)
        return np.linalg.inv(w2v @ ds.get_pose(3)).astype(np.float32), ds.get_depth(3)
    if name == "corner":
        extent = 64 * 0.12
        rng = np.random.default_rng(11)
        depth = rng.uniform(300.0, 7000.0, (SMALL_INTR.height, SMALL_INTR.width))
        depth[rng.random(depth.shape) < 0.1] = 0.0
        c2v = _look_at(np.full(3, 0.3), np.full(3, extent / 2))
        return np.linalg.inv(c2v).astype(np.float32), depth.astype(np.uint16)
    c2w = _regression_c2w()
    depth = np.asarray(render_depth(small_scene(), c2w, SMALL_INTR))
    return np.linalg.inv(w2v @ c2w).astype(np.float32), depth


CASES = ("orbit", "corner", "regression")


def _poses(v2c, seed=None):
    """(JAX r, t, port r, t) of a volume->camera pose; a seeded derivative lane if ``seed``."""
    g = np.zeros((4, 4), np.float32) if seed is None else seeded_pose_direction(seed)
    r = JCSFD(jnp.asarray(v2c[:3, :3]), jnp.asarray(g[:3, :3]))
    t = JCSFD(jnp.asarray(v2c[:3, 3]), jnp.asarray(g[:3, 3]))
    return r, t, to_torch(r), to_torch(t)


# --------------------------------------------------------------- B3a: mips
@pytest.mark.parametrize("source", ["orbit", "corner", "crop_117x157"])
def test_mip_table_equals_jax(source):
    if source == "crop_117x157":  # tiles that do not divide the image: padded rows and columns at every level
        depth = _case("orbit")[1][:117, :157].copy()
    else:
        depth = _case(source)[1].copy()
    depth[10:50, 20:70] = 0  # a hole: tiles with no valid depth (min +inf, max -inf)
    jdm = jfusion.scale_depth(jnp.asarray(depth))
    sizes, mins, maxs, allv = jbrick._depth_mips(jdm)
    want = np.concatenate([
        np.stack([np.asarray(a).reshape(-1), np.asarray(b).reshape(-1), np.asarray(c).reshape(-1).astype(np.float32)],
                 axis=1)
        for a, b, c in zip(mins, maxs, allv)
    ])
    got = tbrick.depth_mips(tfusion.scale_depth(torch.from_numpy(np.ascontiguousarray(depth)))).numpy()
    layout = tbrick.mip_layout(*depth.shape)
    assert list(layout.sizes) == list(sizes)
    assert got.shape == want.shape == (layout.rows, 3)
    assert np.array_equal(got, want)  # inf pads compare equal as numbers
    assert np.isposinf(got[:, 0]).any() and np.isneginf(got[:, 1]).any()


def test_mip_layout_offsets():
    layout = tbrick.mip_layout(120, 160)
    assert layout.sizes == tuple(ts for ts in tbrick.MIP_LEVELS if ts <= 120)
    assert layout.offsets[0] == 0
    for i in range(1, len(layout.sizes)):
        h, w = layout.shapes[i - 1]
        assert layout.offsets[i] == layout.offsets[i - 1] + h * w
    assert layout.rows == sum(h * w for h, w in layout.shapes)


MIP_THREADS, MIP_ROWS = 256, 64  # csrc/bricks.cu: threads of a depth_mips block, most rows a thread walks


def _mip_blocks(ts, h, w):
    """csrc/bricks.cu::read_levels for one level: (tiles a warp or a block
    takes across, blocks of the level)."""
    if ts <= min(32, MIP_ROWS):  # a warp's tiles: 32 // ts across, MIP_ROWS // ts tile rows down
        across, stack = 32 // ts, MIP_ROWS // ts
        warps = -(-h // stack) * -(-w // across)
        return across, -(-warps // (MIP_THREADS // 32))
    runs = -(-ts // MIP_ROWS)
    blocks_across = -(-w // (MIP_THREADS // (ts * runs)))
    return -(-w // blocks_across), h * blocks_across


def _segment_reduce(vals, ops, ends):
    """numpy twin of csrc/bricks.cu::segment_reduce: the shuffle-down steps
    1, 2, 4, 8, 16, each lane taking lane + off while that lies before its
    segment's end. ``vals``: a list of (32,) arrays, reduced by ``ops``."""
    lane = np.arange(32)
    vals = [v.copy() for v in vals]
    for off in (1, 2, 4, 8, 16):
        src = np.minimum(lane + off, 31)  # a shuffle past lane 31 returns the lane's own value
        take = lane + off < ends
        vals = [np.where(take, op(v, v[src]), v) for v, op in zip(vals, ops)]
    return vals


def _twin_mip_level(depth, ts, h, w):
    """numpy twin of csrc/bricks.cu::depth_mips_kernel at one level: the
    level's (h * w, 3) rows, each pixel's read count and each row's owner
    count. A tile up to a warp wide: warp u takes 32 // ts tiles side by
    side and MIP_ROWS // ts tile rows down, lane = (tile, column), each lane
    walking its pixel column with the warp, and at each tile row's end the
    lanes of a tile reduce it by segment_reduce, its first lane writing the
    row. A wider tile: a block's thread (run, column) walks at most MIP_ROWS
    rows of one column; the partials go through shared memory and G aligned
    lanes reduce each tile. Asserts what the design promises: at most
    MIP_ROWS loads a thread, lanes adjacent in x on one row (two, where a
    warp holds the end of one run and the start of the next)."""
    H, W = depth.shape
    per_block, blocks = _mip_blocks(ts, h, w)
    rows = np.full((h * w, 3), np.nan, np.float32)
    reads = np.zeros((H, W), np.int64)
    owners = np.zeros(h * w, np.int64)
    fmin, fmax, fand = np.minimum, np.maximum, np.logical_and
    if ts <= min(32, MIP_ROWS):
        across, stack = per_block, MIP_ROWS // ts
        strips = -(-w // across)
        lane = np.arange(32)
        t, c = lane // ts, lane % ts
        for u in range(blocks * (MIP_THREADS // 32)):
            ty0, tx0 = (u // strips) * stack, (u % strips) * across
            if ty0 >= h:
                continue
            x = (tx0 + t) * ts + c
            tile_ok = (t < across) & (tx0 + t < w)
            readable = tile_ok & (x < W)
            yb = min(min(ty0 + stack, h) * ts, H)
            assert yb - ty0 * ts <= MIP_ROWS
            xs = x[readable]
            assert np.array_equal(xs, np.arange(xs[0], xs[0] + len(xs)))  # one contiguous run of the row
            for ty in range(ty0, min(ty0 + stack, h)):
                ys = np.arange(ty * ts, min((ty + 1) * ts, H))
                d = depth[np.ix_(ys, np.clip(x, 0, W - 1))]
                reads[np.ix_(ys, x[readable])] += 1
                ok = readable[None, :]
                mn = np.where(ok & (d > 0), d, np.inf).min(0).astype(np.float32)
                mx = np.where(ok & (d > 0), d, -np.inf).max(0).astype(np.float32)
                av = ~(ok & ~(d > 0)).any(0)
                mn, mx, av = _segment_reduce([mn, mx, av], (fmin, fmax, fand), (t + 1) * ts)
                for tt in np.flatnonzero(tile_ok & (c == 0)):
                    row = ty * w + tx0 + t[tt]
                    owners[row] += 1
                    rows[row] = (mn[tt], mx[tt], float(av[tt]))
        return rows, reads, owners
    runs = -(-ts // MIP_ROWS)
    run_rows, span, cells = -(-ts // runs), per_block * ts, ts * runs
    blocks_across = blocks // h
    G = 1
    while 2 * G <= cells and G < 32:
        G *= 2
    assert 32 % G == 0 and cells <= MIP_THREADS and per_block * G <= MIP_THREADS
    tid = np.arange(MIP_THREADS)
    r, c = tid // span, tid % span
    for bi in range(blocks):
        ty, tx0 = bi // blocks_across, (bi % blocks_across) * per_block
        n_tiles = min(per_block, w - tx0)
        x = tx0 * ts + c
        ya = ty * ts + r * run_rows
        yb = np.minimum(np.minimum(ya + run_rows, (ty + 1) * ts), H)
        live = (r < runs) & (c < n_tiles * ts) & (x < W)
        assert (yb - ya)[live].max(initial=0) <= MIP_ROWS
        for warp in range(MIP_THREADS // 32):
            lanes = np.flatnonzero(live[32 * warp:32 * warp + 32]) + 32 * warp
            firsts = np.unique(ya[lanes])
            assert len(firsts) <= 2
            for y0 in firsts:
                xs = x[lanes][ya[lanes] == y0]
                assert np.array_equal(xs, np.arange(xs[0], xs[0] + len(xs)))
        ys = ya[:, None] + np.arange(MIP_ROWS)[None, :]
        take = live[:, None] & (ys < yb[:, None])
        xs = np.broadcast_to(x[:, None], ys.shape)
        np.add.at(reads, (ys[take], xs[take]), 1)
        d = depth[np.clip(ys, 0, H - 1), np.clip(xs, 0, W - 1)]
        s_mn = np.where(take & (d > 0), d, np.inf).min(1)
        s_mx = np.where(take & (d > 0), d, -np.inf).max(1)
        s_av = ~(take & ~(d > 0)).any(1)
        for t_ in range(n_tiles):
            group = np.flatnonzero(tid // G == t_)
            assert len(group) == G and group[0] % G == 0
            cell = np.concatenate([np.arange(jj, cells, G) for jj in range(G)])  # every cell by one lane
            assert np.array_equal(np.sort(cell), np.arange(cells))
            q = (cell // ts) * span + t_ * ts + cell % ts
            assert np.array_equal(np.sort(q), np.flatnonzero((r < runs) & (c // ts == t_)))
            row = ty * w + tx0 + t_
            owners[row] += 1
            rows[row] = (s_mn[q].min(), s_mx[q].max(), float(s_av[q].all()))
    return rows, reads, owners


def _seeded_depth(H=480, W=640, seed=8):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.3, 7.0, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.05] = 0.0
    depth[100:160, 200:330] = 0.0  # tiles with no valid depth
    return depth


@pytest.mark.parametrize("ts", tbrick.MIP_LEVELS)
def test_mip_walk_reads_every_pixel_once(ts):
    """The twin of depth_mips_kernel at each level of a 480x640 frame: every
    pixel of the image read once (the tiles' padding, past the image, read
    by none), every row of the level written by one owner, and the rows the
    plain version's bit for bit."""
    depth = _seeded_depth()
    layout = tbrick.mip_layout(*depth.shape)
    k = layout.sizes.index(ts)
    h, w = layout.shapes[k]
    rows, reads, owners = _twin_mip_level(depth, ts, h, w)
    assert (reads == 1).all() and (owners == 1).all()
    plain = tbrick.depth_mips_plain(torch.from_numpy(depth)).numpy()
    assert np.array_equal(rows, plain[layout.offsets[k]:layout.offsets[k] + h * w])


@pytest.mark.parametrize("shape", [(117, 157), (120, 160), (477, 637)])
def test_mip_twin_table_equals_plain(shape):
    """The twin's whole table, level after level, at shapes whose tiles
    leave padded rows and columns: the plain version's, inf pads included."""
    depth = _seeded_depth(*shape, seed=shape[0])
    layout = tbrick.mip_layout(*shape)
    table = np.concatenate([_twin_mip_level(depth, ts, h, w)[0] for ts, (h, w) in zip(layout.sizes, layout.shapes)])
    assert table.shape == (layout.rows, 3)
    assert np.array_equal(table, tbrick.depth_mips_plain(torch.from_numpy(depth)).numpy())


# --------------------------------------------------------- B3b: classes
@pytest.mark.parametrize("name", CASES)
def test_classes_match_jax(name):
    _, jcfg, tcfg = _cfgs()
    v2c, depth = _case(name)
    r, t, tr, tt = _poses(v2c)
    jcls = np.asarray(jbrick.classify_bricks_full(jfusion.scale_depth(jnp.asarray(depth)), r.v, t.v, SMALL_INTR,
                                                  jcfg, jcfg.resolution, split=False).cls)
    table = tbrick.depth_mips(tfusion.scale_depth(torch.from_numpy(depth)))
    tcls = tbrick.classify_bricks_plain(table, kernels.fusion_pose(tr, tt), TINTR, tcfg).numpy()
    assert tcls.shape == jcls.shape == (8, 8, 8)
    differ = int((tcls != jcls).sum())
    assert differ <= 0.001 * tcls.size, f"{differ} of {tcls.size} bricks differ"
    counts = np.bincount(tcls.reshape(-1), minlength=4)
    assert counts[tbrick.ACTIVE] > 10 and counts[tbrick.NONE] > 10, counts


def test_classes_reach_far_and_far_partial():
    """A uniform far depth makes FAR bricks and, at the frustum's sides,
    FAR_PARTIAL ones (tests/test_fusion_brick.py's check of the JAX classes)."""
    _, jcfg, tcfg = _cfgs()
    v2c, _ = _case("orbit")
    r, t, tr, tt = _poses(v2c)
    far = np.full((SMALL_INTR.height, SMALL_INTR.width), 4000, np.uint16)
    table = tbrick.depth_mips(tfusion.scale_depth(torch.from_numpy(far)))
    tcls = tbrick.classify_bricks_plain(table, kernels.fusion_pose(tr, tt), TINTR, tcfg).numpy()
    jcls = np.asarray(jbrick.classify_bricks_full(jfusion.scale_depth(jnp.asarray(far)), r.v, t.v, SMALL_INTR, jcfg,
                                                  jcfg.resolution).cls)
    assert (tcls == tbrick.FAR).sum() > 0 and (tcls == tbrick.FAR_PARTIAL).sum() > 0
    assert (tcls != jcls).sum() <= 0.001 * tcls.size


CORNER_LANES, CLASSIFY_THREADS = 2, 256  # csrc/bricks.cu: lanes of a brick, threads of a block
DIVIDE_LIMIT = 1 << 16  # csrc/bricks.cu: the classifier's exact division holds below this
STATUS_COUNT_BITS = 11  # csrc/bricks.cu: a status word's counts; the launch's epoch above them


def _magic(ts):
    """csrc/bricks.cu::read_levels: ceil(2^32 / ts), for each tile size."""
    ts = np.asarray(ts, np.uint64)
    return (np.uint64(2 ** 32 - 1) + ts) // ts


def _divide(i, ts):
    """csrc/bricks.cu::divide: the high word of i * magic(ts)."""
    return ((np.asarray(i, np.uint64) * _magic(ts)) >> np.uint64(32)).astype(np.int64)


@pytest.mark.parametrize("ts", tbrick.MIP_LEVELS)
def test_exact_division_equals_floor_division(ts):
    """The classifier's multiply-high equals ``//`` for every pixel index below
    the limit the kernel checks, the image's [0, 640) among them."""
    i = np.arange(DIVIDE_LIMIT)
    assert _magic(ts) < 2 ** 32
    assert np.array_equal(_divide(i, ts), i // ts)
    assert np.array_equal(_divide(i[:640], ts), np.arange(640) // ts)


def _min_nan(a, b):
    """torch.minimum: NaN if either is."""
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b, np.minimum(a, b)))


def _max_nan(a, b):
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b, np.maximum(a, b)))


def _to_index(x):
    """ops/sampling.py::to_index: NaN -> -1, clamped to +-2^30, truncated."""
    return np.clip(np.where(np.isnan(x), np.float32(-1.0), x), -(2.0 ** 30), 2.0 ** 30).astype(np.int64)


def _group(x, op, width):
    """csrc/bricks.cu::group_min / group_max and the cells' reduction: xor
    shuffles over offsets 1, 2, ... below ``width``, on (bricks, lanes)
    arrays; every lane of a group of ``width`` gets the result."""
    lane = np.arange(x.shape[-1])
    off = 1
    while off < width:
        x = op(x, x[..., lane ^ off])
        off <<= 1
    return x


def _twin_level(pr, cu, cv, ucl, vcl, sizes, lanes=CORNER_LANES):
    """csrc/bricks.cu's level: each lane of a brick's ``lanes`` counts the
    levels j, j + lanes, ... whose tile is smaller than ``pr``, and the group
    adds the counts (searchsorted's level, ``base``); then round r tests
    levels base + r lanes + j, a level a lane, and the group stops at the
    first round whose ballot holds a covering level, taking the lowest. A
    level of ``len(sizes)``: none covers. Arrays of bricks in, levels out."""
    n = len(sizes)
    base = np.zeros(pr.shape, np.int64)
    for k in range(n):
        base += (np.float32(sizes[k]) < pr).astype(np.int64)
    level = np.full(pr.shape, n)
    searching = base < n
    k0 = base.copy()
    while searching.any():
        bits = np.zeros(pr.shape, np.int64)
        for j in range(lanes):
            k = k0 + j
            ok = searching & (k < n)
            s = np.asarray(sizes)[np.minimum(k, n - 1)]
            cover = ok & (ucl < ((_divide(cu, s) + 2) * s).astype(np.float32)) & (
                vcl < ((_divide(cv, s) + 2) * s).astype(np.float32))
            bits |= cover.astype(np.int64) << j
        lowest = np.log2(np.maximum(bits & -bits, 1)).astype(np.int64)
        level = np.where(searching & (bits != 0), k0 + lowest, level)
        searching = searching & (bits == 0) & (k0 + lanes < n)
        k0 = k0 + lanes
    return level


def _top_down_level(pr, cu, cv, ucl, vcl, sizes):
    """classify_bricks_plain's scan: searchsorted's level, then every level
    from the top down, keeping the last that covers at or above it."""
    n = len(sizes)
    base = torch.searchsorted(torch.tensor(sizes, dtype=torch.float32), torch.from_numpy(pr)).numpy()
    level = np.full(pr.shape, n)
    for li in reversed(range(n)):
        s = sizes[li]
        cover = (ucl < ((cu // s) + 2) * s) & (vcl < ((cv // s) + 2) * s)
        level = np.where(cover & (base <= li), li, level)
    return level


def _twin_classify(table, pose, intr, cfg, corners=tuple(range(8)), lanes=CORNER_LANES):
    """numpy twin of csrc/bricks.cu::classify_brick on every brick: lane j of
    a brick's ``lanes`` takes corners ``corners[j * 8 // lanes:...]`` (the
    kernel: j * 8 / lanes onward, in order) and reduces them, then the group
    reduces by xor shuffles; the level by rounds of ballots
    (:func:`_twin_level`); lane j of the first min(lanes, 4) reads 4 /
    min(lanes, 4) of the window's cells in order, and the group reduces them
    over lanes j ^ 1, then j ^ 2. The division by |f| is a true one, as the
    plain version's on the CPU (the kernel multiplies by the reciprocal, as
    the plain version on the card). Returns the classes (every lane's must
    agree) and the footprint (pr, cu, cv, ucl, vcl) and level of each brick."""
    f = np.float32
    H, W = intr.height, intr.width
    layout = tbrick.mip_layout(H, W)
    sizes = layout.sizes
    nbx, nby, nbz = (s // 8 for s in cfg.resolution)
    R, t = pose[:9].reshape(3, 3), pose[18:21]
    bm = f(8 * cfg.voxel_size)
    b = np.arange(nbx * nby * nbz)
    bx0 = (b // (nby * nbz)).astype(f)[:, None] * bm
    by0 = ((b // nbz) % nby).astype(f)[:, None] * bm
    bz0 = (b % nbz).astype(f)[:, None] * bm
    planes = ((f(intr.fx), f(0), f(intr.cx - 2.5)), (f(-intr.fx), f(0), f((W - 0.5) - intr.cx)),
              (f(0), f(intr.fy), f(intr.cy - 2.5)), (f(0), f(-intr.fy), f((H - 0.5) - intr.cy)))
    per = 8 // lanes
    lane_corners = np.asarray(corners).reshape(lanes, per)
    ops = (_min_nan, _max_nan, _min_nan, _max_nan, _min_nan, _max_nan) + (_max_nan,) * 4
    acc = None
    for c in range(per):
        k = lane_corners[:, c][None, :]
        px = bx0 + np.where(k & 4, bm, f(0))
        py = by0 + np.where(k & 2, bm, f(0))
        pz = bz0 + np.where(k & 1, bm, f(0))
        cam = [((R[i, 0] * px + R[i, 1] * py) + R[i, 2] * pz) + t[i] for i in range(3)]
        zc = _max_nan(cam[2], f(1e-6))
        vals = [(f(intr.fx) * cam[0]) / zc + f(intr.cx), (f(intr.fy) * cam[1]) / zc + f(intr.cy), cam[2]]
        vals += [(a * cam[0] + b_ * cam[1]) + c_ * cam[2] for a, b_, c_ in planes]
        now = [vals[0], vals[0], vals[1], vals[1], vals[2], vals[2]] + vals[3:]
        acc = now if acc is None else [op(a, x) for op, a, x in zip(ops, acc, now)]
    umin, umax, vmin, vmax, zmin, zmax, *pmax = [_group(a, op, lanes) for op, a in zip(ops, acc)]
    frustum_out = (pmax[0] < 0) | (pmax[1] < 0) | (pmax[2] < 0) | (pmax[3] < 0)
    o = [-((R[0, i] * t[0] + R[1, i] * t[1]) + R[2, i] * t[2]) for i in range(3)]
    lo, hi = [], []
    for b0, oi in zip((bx0, by0, bz0), o):
        lo.append(np.abs(oi - _min_nan(_max_nan(oi, b0), b0 + bm)))
        hi.append(_max_nan(np.abs(b0 - oi), np.abs(b0 + bm - oi)))
    dist_min = _max_nan(np.sqrt((lo[0] * lo[0] + lo[1] * lo[1]) + lo[2] * lo[2]), f(1e-3))
    dist_max = np.sqrt((hi[0] * hi[0] + hi[1] * hi[1]) + hi[2] * hi[2])
    umin, umax, vmin, vmax = umin - f(1), umax + f(1), vmin - f(1), vmax + f(1)
    fully_behind = zmax < 0
    z_safe = zmin > f(1e-3)
    fully_outside = z_safe & ((umax < f(2.5)) | (umin > f(W - 0.5)) | (vmax < f(2.5)) | (vmin > f(H - 0.5)))
    fully_inside = z_safe & (umin >= f(2.5)) & (umax <= f(W - 1.5)) & (vmin >= f(2.5)) & (vmax <= f(H - 1.5))
    pr = np.where(z_safe, f(0.5) * _max_nan(umax - umin, vmax - vmin), f(np.inf))
    u, v = f(0.5) * (umin + umax), f(0.5) * (vmin + vmax)
    cu = np.clip(_to_index(u - pr), 0, W - 1)
    cv = np.clip(_to_index(v - pr), 0, H - 1)
    ucl = _min_nan(_max_nan(umax, f(0)), f(W - 1))
    vcl = _min_nan(_max_nan(vmax, f(0)), f(H - 1))
    level = _twin_level(pr, cu, cv, ucl, vcl, sizes, lanes)
    level_ok = level < len(sizes)
    lv = np.minimum(level, len(sizes) - 1)
    ts = np.asarray(sizes)[lv]
    mh = np.asarray([h for h, _ in layout.shapes])[lv]
    mw = np.asarray([w for _, w in layout.shapes])[lv]
    first = np.asarray(layout.offsets)[lv]
    cu0 = np.minimum(_divide(cu, ts), mw - 1)
    cv0 = np.minimum(_divide(cv, ts), mh - 1)
    cell_lanes = min(lanes, 4)
    per_lane = 4 // cell_lanes
    dmin = dmax = av = None
    for c in range(per_lane):
        cell = (np.arange(lanes)[None, :] & (cell_lanes - 1)) * per_lane + c
        y = np.minimum(cv0 + (cell >> 1), mh - 1)
        x = np.minimum(cu0 + (cell & 1), mw - 1)
        rows = table[first + y * mw + x]
        dmin = rows[..., 0] if c == 0 else _min_nan(dmin, rows[..., 0])
        dmax = rows[..., 1] if c == 0 else _max_nan(dmax, rows[..., 1])
        av = rows[..., 2] if c == 0 else av * rows[..., 2]
    dmin = _group(dmin, _min_nan, cell_lanes)
    dmax = _group(dmax, _max_nan, cell_lanes)
    all_valid = _group(av, np.multiply, cell_lanes) > f(0.5)

    def coord_interval(c0, c1, centre, fl):
        a0, a1 = np.abs(c0 - f(centre)), np.abs(c1 - f(centre))
        inside = (c0 <= f(centre)) & (f(centre) <= c1)
        return np.where(inside, f(0), _min_nan(a0, a1)) / f(abs(fl)), _max_nan(a0, a1) / f(abs(fl))

    xl_lo, xl_hi = coord_interval(_min_nan(_max_nan(umin, f(0)), f(W - 1)), ucl, intr.cx, intr.fx)
    yl_lo, yl_hi = coord_interval(_min_nan(_max_nan(vmin, f(0)), f(H - 1)), vcl, intr.cy, intr.fy)
    lam_min = np.sqrt((xl_lo * xl_lo + yl_lo * yl_lo) + f(1))
    lam_max = np.sqrt((xl_hi * xl_hi + yl_hi * yl_hi) + f(1))
    proj_ok = z_safe & level_ok
    none = fully_behind | fully_outside | frustum_out | (proj_ok & (dmax * lam_max - dist_min < f(-cfg.trunc_dist)))
    far = proj_ok & all_valid & (dmin * lam_min - dist_max > f(cfg.trunc_dist))
    cls = np.where(none, tbrick.NONE, np.where(far, np.where(fully_inside, tbrick.FAR, tbrick.FAR_PARTIAL),
                                                  tbrick.ACTIVE))
    assert (cls == cls[:, :1]).all()  # the group agrees
    return cls[:, 0].reshape(nbx, nby, nbz), dict(pr=pr[:, 0], cu=cu[:, 0], cv=cv[:, 0], ucl=ucl[:, 0],
                                                    vcl=vcl[:, 0], level=level[:, 0])


@pytest.mark.parametrize("lanes, corners", [(2, tuple(range(8))), (2, (5, 2, 7, 0, 3, 6, 1, 4)),
                                            (1, (6, 1, 3, 4, 0, 7, 2, 5)), (8, (6, 1, 3, 4, 0, 7, 2, 5))],
                         ids=["2_lanes", "2_lanes_shuffled", "1_lane_shuffled", "8_lanes_shuffled"])
@pytest.mark.parametrize("name", CASES)
def test_lane_split_twin_gives_plain_classes(name, lanes, corners):
    """The twin of the kernel's lane split (corners on lanes, xor-shuffle
    reductions, rounds of ballots for the level, cells on lanes) gives the
    plain version's classes, whichever corner a lane takes and in whatever
    order the reductions meet them: min and max round nothing, and no class
    reads the sign of a zero."""
    _, _, tcfg = _cfgs()
    v2c, depth = _case(name)
    _, _, tr, tt = _poses(v2c)
    pose = kernels.fusion_pose(tr, tt)
    table = tbrick.depth_mips(tfusion.scale_depth(torch.from_numpy(depth)))
    plain = tbrick.classify_bricks_plain(table, pose, TINTR, tcfg).numpy()
    twin, _ = _twin_classify(table.numpy(), pose.numpy(), TINTR, tcfg, corners, lanes)
    assert np.array_equal(twin, plain)
    assert len(np.unique(plain)) >= 2


@pytest.mark.parametrize("source", ("random",) + CASES)
def test_level_rounds_equal_top_down_scan(source):
    """The level the rounds of ballots give (upward from searchsorted's, the
    lowest covering level of the first round that has one) is the top-down
    scan's, on random footprints of a 480x640 frame and on every brick of the
    three test poses, with 1, 2 and 8 lanes a brick."""
    if source == "random":
        rng = np.random.default_rng(3)
        n = 200_000
        sizes = tbrick.mip_layout(480, 640).sizes
        pr = rng.uniform(0.0, 200.0, n).astype(np.float32)
        pr[rng.random(n) < 0.05] = np.inf  # a brick not safely in front of the camera
        cu, cv = rng.integers(0, 640, n), rng.integers(0, 480, n)
        ucl = np.minimum(cu + rng.uniform(0.0, 4.0, n) * np.minimum(pr, 300), 639).astype(np.float32)
        vcl = np.minimum(cv + rng.uniform(0.0, 4.0, n) * np.minimum(pr, 300), 479).astype(np.float32)
    else:
        _, _, tcfg = _cfgs()
        v2c, depth = _case(source)
        _, _, tr, tt = _poses(v2c)
        table = tbrick.depth_mips(tfusion.scale_depth(torch.from_numpy(depth)))
        sizes = tbrick.mip_layout(SMALL_INTR.height, SMALL_INTR.width).sizes
        _, fp = _twin_classify(table.numpy(), kernels.fusion_pose(tr, tt).numpy(), TINTR, tcfg)
        pr, cu, cv, ucl, vcl = (np.ascontiguousarray(fp[k]) for k in ("pr", "cu", "cv", "ucl", "vcl"))
    want = _top_down_level(pr, cu, cv, ucl, vcl, sizes)
    for lanes in (1, 2, 8):
        assert np.array_equal(_twin_level(pr, cu, cv, ucl, vcl, sizes, lanes), want)
    assert (want < len(sizes)).any() and len(np.unique(want)) >= 3


def _twin_scan(cls_flat, cap, rng, scratch=None, resident=5, threads=CLASSIFY_THREADS, lanes=CORNER_LANES):
    """numpy twin of classify_bricks_kernel's ranks, blocks as coroutines: the
    blocks start in a seeded order, at most ``resident`` at a time, and each
    takes its tile by the ticket (the counter runs on from launch to launch;
    the host passes the tickets taken so far and the launch's epoch, as
    ops/fusion_brick.py::ClassifyScratch does); a step of a random running
    block at a time. A block ballots its bricks' ACTIVE and work flags (a
    leader lane a brick, every ``lanes`` lanes), publishes its tile's counts
    under the epoch, sums the counts of every earlier tile (reloading those
    not yet published under this epoch: a word of an earlier launch is
    stale), and writes its ranks and lists. Returns (rank, active_ids,
    work_ids, totals, overflow, tile of each block, scratch)."""
    n = cls_flat.size
    warps = threads // 32
    tile_size = threads // lanes
    tiles = -(-n // tile_size)
    if scratch is None:  # zeroed when made
        scratch = dict(ticket=0, status=[0] * tiles, tickets=0, launches=0)
    base = scratch["tickets"] % 2 ** 32
    scratch["tickets"] += tiles
    scratch["launches"] += 1
    epoch = scratch["launches"]
    status = scratch["status"]
    mask = (1 << STATUS_COUNT_BITS) - 1
    rank, active_ids, work_ids = (np.full(n, -7, np.int64) for _ in range(3))  # -7: never written
    out = dict(tiles={})

    def block(idx):
        tile = (scratch["ticket"] - base) % 2 ** 32
        scratch["ticket"] += 1
        assert tile < tiles
        out["tiles"][idx] = tile
        yield
        words = []  # each warp's ballots of ACTIVE and of work leaders, in flat order
        for w in range(warps):
            act = wrk = 0
            for g in range(32 // lanes):
                b = tile * tile_size + w * (32 // lanes) + g
                c = cls_flat[b] if b < n else tbrick.NONE
                act |= int(c == tbrick.ACTIVE) << (g * lanes)
                wrk |= int(c != tbrick.NONE) << (g * lanes)
            words.append((act, wrk))
        pops = np.array([[bin(a).count("1"), bin(w_).count("1")] for a, w_ in words])
        before = np.cumsum(pops, 0) - pops  # within the tile
        tile_a, tile_w = (int(x) for x in pops.sum(0))
        status[tile] = (epoch << 2 * STATUS_COUNT_BITS) | (tile_a << STATUS_COUNT_BITS) | tile_w
        yield
        ba = bw = 0
        pending = list(range(tile))
        while True:
            still = []
            for i in pending:  # the lanes' loads, all together
                s = status[i]
                if s >> 2 * STATUS_COUNT_BITS == epoch:
                    ba += (s >> STATUS_COUNT_BITS) & mask
                    bw += s & mask
                else:
                    still.append(i)
            pending = still
            if not pending:
                break
            yield  # reload
        if tile == tiles - 1:
            out["totals"] = (ba + tile_a, bw + tile_w)
            out["overflow"] = ba + tile_a > cap
        yield
        for wi, (act, wrk) in enumerate(words):
            for g in range(32 // lanes):
                lane = g * lanes
                b = tile * tile_size + wi * (32 // lanes) + g
                if b >= n:
                    continue
                below = (1 << lane) - 1
                ra = ba + int(before[wi, 0]) + bin(act & below).count("1")
                rank[b] = ra if act >> lane & 1 else -1
                if act >> lane & 1:
                    active_ids[ra] = b
                if wrk >> lane & 1:
                    work_ids[bw + int(before[wi, 1]) + bin(wrk & below).count("1")] = b

    waiting = list(rng.permutation(tiles))  # blockIdx in the order the blocks start
    running = []
    while waiting or running:
        if waiting and (len(running) < resident) and (not running or rng.random() < 0.5):
            running.append(block(int(waiting.pop(0))))
        k = int(rng.integers(len(running)))
        try:
            next(running[k])
        except StopIteration:
            running.pop(k)
    return rank, active_ids, work_ids, out["totals"], out["overflow"], out["tiles"], scratch


@pytest.mark.parametrize("n", [512, 1000, 32768])
def test_rank_twin_is_flat_order(n):
    """The single-pass scan's twin, its tiles taken in a shuffled ticket
    order, gives rank_bricks_plain's ranks, lists, counts and flag."""
    rng = np.random.default_rng(n)
    cls = rng.choice(4, size=n, p=[0.6, 0.2, 0.15, 0.05]).astype(np.int32)
    n_active = int((cls == tbrick.ACTIVE).sum())
    rank, active_ids, work_ids, totals, overflow, tiles, scratch = _twin_scan(cls, n_active - 1, rng)
    plain = tbrick.rank_bricks_plain(torch.from_numpy(cls), cap=n_active - 1)
    n_work = int(plain.totals[1])
    assert list(totals) == plain.totals.tolist() and overflow and bool(plain.overflow)
    assert np.array_equal(rank, plain.rank.numpy())
    assert np.array_equal(active_ids[:n_active], plain.active_ids[:n_active].numpy())
    assert np.array_equal(work_ids[:n_work], plain.work_ids[:n_work].numpy())
    assert np.array_equal(active_ids[:n_active], np.flatnonzero(cls == tbrick.ACTIVE))
    assert (plain.active_ids[n_active:] == n).all()  # the plain version pads with NB
    assert sorted(tiles.values()) == list(range(len(tiles)))
    if len(tiles) > 2:
        assert any(idx != tile for idx, tile in tiles.items())  # tiles follow the tickets, not blockIdx
    assert scratch["ticket"] == len(tiles)


@pytest.mark.parametrize("threads, lanes", [(256, 2), (512, 2), (256, 8)])
@pytest.mark.parametrize("resident", [1, 3, 64])
def test_scan_twin_back_to_back_on_one_scratch(resident, threads, lanes):
    """Three launches back to back on one scratch, with different classes
    (the second overflows its cap, the others do not), each give the plain
    lists: the status words an earlier launch left carry its epoch and count
    for nothing, and the ticket counter runs on. With one resident block the
    tiles run one after another; a block never waits on a tile whose block
    has not started."""
    rng = np.random.default_rng(resident * 10 + lanes)
    n = 32 * 8 * 12 + 5  # a cut last tile
    first = rng.choice(4, size=n, p=[0.5, 0.2, 0.2, 0.1]).astype(np.int32)
    second = rng.choice(4, size=n, p=[0.3, 0.1, 0.5, 0.1]).astype(np.int32)
    third = rng.choice(4, size=n, p=[0.8, 0.1, 0.05, 0.05]).astype(np.int32)
    cap = int((first == tbrick.ACTIVE).sum())
    scratch, flags = None, []
    for cls in (first, second, third):
        rank, active_ids, work_ids, totals, overflow, _, scratch = _twin_scan(cls, cap, rng, scratch, resident,
                                                                             threads, lanes)
        plain = tbrick.rank_bricks_plain(torch.from_numpy(cls), cap)
        n_active, n_work = plain.totals.tolist()
        assert list(totals) == [n_active, n_work] and overflow == bool(plain.overflow)
        assert np.array_equal(rank, plain.rank.numpy())
        assert np.array_equal(active_ids[:n_active], plain.active_ids[:n_active].numpy())
        assert np.array_equal(work_ids[:n_work], plain.work_ids[:n_work].numpy())
        flags.append(overflow)
    assert flags == [False, True, False]
    assert scratch["ticket"] == scratch["tickets"] == 3 * -(-n // (threads // lanes))


def test_classify_scratch_counts_tickets_and_epochs():
    """The wrapper's scratch gives each launch the tickets taken before it
    (mod 2^32) and its epoch, from 1, and counts only the launches the card
    accepted."""
    scratch = tbrick.ClassifyScratch(torch.device("cpu"), 1 + 256)
    assert scratch.words.numel() == 257 and not scratch.words.any()
    assert scratch.next_launch() == (0, 1)
    assert scratch.next_launch() == (0, 1)  # a refused launch took no tickets
    scratch.launched(256)
    assert scratch.next_launch() == (256, 2)
    scratch.launched(256)
    scratch.tickets = 2 ** 32 - 3
    assert scratch.next_launch() == (2 ** 32 - 3, 3)
    scratch.launched(256)
    assert scratch.next_launch() == (253, 4)  # the device's counter wraps as an unsigned int
    assert tbrick.classify_tiles(32768) == 32768 // tbrick.CLASSIFY_TILE
    assert tbrick.CLASSIFY_TILE == CLASSIFY_THREADS // CORNER_LANES



# ---------------------------------------------------- B3c: the fused volume
def _fuse_both(name, seed=None, cap=512, overflow="flag"):
    """(port dense volume, port brick volume, brick flags) after the case's
    frame, each from the same pre-frame volume: the orbit's frames 0-2 fused
    densely."""
    cfg, _, tcfg = _cfgs()
    w2v = np.asarray(cfg.world2volume, np.float32)
    ds = small_dataset(3, degrees_per_frame=1.0)
    pre = tfusion.create_volume(tcfg, "cpu")
    for i in range(3):
        v2c = np.linalg.inv(w2v @ ds.get_pose(i)).astype(np.float32)
        _, _, tr, tt = _poses(v2c, seed=None if seed is None else seed + i)
        tfusion.integrate(pre, tfusion.scale_depth(torch.from_numpy(ds.get_depth(i))), tr, tt, TINTR, tcfg)
    v2c, depth = _case(name)
    _, _, tr, tt = _poses(v2c, seed)
    dm = tfusion.scale_depth(torch.from_numpy(depth))
    dense = tfusion.VolumeState(*(x.clone() for x in pre))
    brick = tfusion.VolumeState(*(x.clone() for x in pre))
    tfusion.integrate(dense, dm, tr, tt, TINTR, tcfg)
    flags = tfusion.integrate_brick(brick, dm, tr, tt, TINTR, tcfg, cap=cap, overflow=overflow)
    return pre, dense, brick, flags


def _twin_brick_column(b, c, nby, nbz, Y, Z):
    """numpy twin of csrc/bricks.cu::brick_column: brick b's (x, y) column c
    (0..63) -> (x, y, z0, index of its first voxel in the dense planes)."""
    bz, by, bx = b % nbz, (b // nbz) % nby, b // (nby * nbz)
    x, y, z0 = bx * 8 + c // 8, by * 8 + c % 8, bz * 8 + 0 * c
    return x, y, z0, (x * Y + y) * Z + z0


def _twin_brick_columns(b, nby, nbz, Y, Z):
    """What fuse_bricks_kernel's warp does with brick(s) ``b``: lane l
    computes columns l and l + 32; the staging loads take float4 f = l + 32 q
    (q < 4), the half f % 2 of column f // 2. Returns the computed columns'
    (x, y, z0, first index), each (..., 32, 2), and the staged float4s'
    first indices, (..., 32, 4)."""
    b = np.asarray(b)[..., None, None]
    lane = np.arange(32)[:, None]
    x, y, z0, idx = _twin_brick_column(b, lane + 32 * np.arange(2)[None, :], nby, nbz, Y, Z)
    f = lane + 32 * np.arange(4)[None, :]
    staged = _twin_brick_column(b, f // 2, nby, nbz, Y, Z)[3] + 4 * (f % 2)
    return x, y, z0, idx, staged


@pytest.mark.parametrize("res", [(8, 8, 8), (16, 24, 32), (64, 64, 64)])
def test_brick_columns_cover_each_voxel_once(res):
    """A warp's 32 lanes x 2 columns x 8 z voxels cover each voxel of its
    brick once, and the bricks together the volume; brick b's voxels are
    row b of ``to_bricks``, the plain version's. The staging loads, 16 bytes
    each, also cover every voxel once, 16-byte aligned."""
    X, Y, Z = res
    nbx, nby, nbz = X // 8, Y // 8, Z // 8
    x, y, z0, idx, staged = _twin_brick_columns(np.arange(nbx * nby * nbz), nby, nbz, Y, Z)
    assert (idx % 8 == 0).all() and (z0 % 8 == 0).all() and (staged % 4 == 0).all()
    rows = tbrick.to_bricks(torch.arange(X * Y * Z).reshape(X, Y, Z)).numpy()
    for first, n in ((idx, 8), (staged, 4)):
        voxels = first[..., None] + np.arange(n)  # (bricks, lanes, columns or loads, z)
        assert (np.bincount(voxels.reshape(-1), minlength=X * Y * Z) == 1).all()
        assert np.array_equal(np.sort(voxels.reshape(len(rows), -1), axis=1), np.sort(rows, axis=1))
    assert np.array_equal(idx, (x * Y + y) * Z + z0)


def test_staged_brick_slots_and_write_back_cover_each_voxel_once():
    """fuse_bricks_kernel's shared-memory brick: the staging loads (float4
    f = lane + 32 q of each plane: half f % 2 of column f // 2) fill slot
    c * 9 + z of each (column c, z) once; the compute reads a lane's columns
    lane and lane + 32 there; the write-back takes (column 4 s + lane // 8,
    z = lane % 8), so 8 lanes store a column's 32 contiguous bytes and every
    (column, z) is taken once."""
    stride = 9  # csrc/bricks.cu::COLUMN_STRIDE
    lane = np.arange(32)
    f = (lane[:, None] + 32 * np.arange(4)[None, :]).reshape(-1)
    slots = ((f // 2) * stride + 4 * (f % 2))[:, None] + np.arange(4)
    want = (np.arange(64)[:, None] * stride + np.arange(8)).reshape(-1)
    assert np.array_equal(np.sort(slots.reshape(-1)), want)
    computed = (np.concatenate([lane, lane + 32])[:, None] * stride + np.arange(8)).reshape(-1)
    assert np.array_equal(np.sort(computed), want)
    banks = (lane * stride) % 32  # a z step of the compute: the lanes' slots lie in 32 different banks
    assert len(set(banks.tolist())) == 32
    taken = np.zeros((64, 8), np.int64)
    for s_ in range(16):
        c, z = 4 * s_ + lane // 8, lane % 8
        taken[c, z] += 1
        for group in range(4):  # 8 lanes, one column, z in order: 32 contiguous bytes
            assert len(set(c[8 * group:8 * group + 8].tolist())) == 1
            assert np.array_equal(z[8 * group:8 * group + 8], np.arange(8))
    assert (taken == 1).all()


def test_brick_column_sums_keep_the_plain_order():
    """B3c takes R[i][0] gx + R[i][1] gy once a column (fusion.cuh's
    column_sums), then adds R[i][2] gz and t for each of its 8 voxels: the
    sum ((a + b) + c) + t of the plain version's camera coordinates, bit
    for bit in float32, on both lanes of a seeded pose."""
    v2c, _ = _case("regression")
    _, _, tr, tt = _poses(v2c, seed=5)
    vs = np.float32(0.12)
    x, y, z0, _, _ = _twin_brick_columns(np.arange(512), 8, 8, 64, 64)
    gx, gy = (x.astype(np.float32) + np.float32(0.5)) * vs, (y.astype(np.float32) + np.float32(0.5)) * vs
    gz = (z0[..., None].astype(np.float32) + np.arange(8, dtype=np.float32) + np.float32(0.5)) * vs
    for R, t in ((tr.v.numpy(), tt.v.numpy()), (tr.g.numpy(), tt.g.numpy())):
        for i in range(3):
            sums = R[i, 0] * gx + R[i, 1] * gy  # once a column
            hoisted = (sums[..., None] + R[i, 2] * gz) + t[i]
            R_t, t_t = torch.from_numpy(R), torch.from_numpy(t)
            plain = (R_t[i, 0] * torch.from_numpy(np.broadcast_to(gx[..., None], gz.shape).copy())
                     + R_t[i, 1] * torch.from_numpy(np.broadcast_to(gy[..., None], gz.shape).copy())
                     + R_t[i, 2] * torch.from_numpy(gz) + t_t[i]).numpy()
            assert hoisted.dtype == np.float32
            assert np.array_equal(hoisted.view(np.int32), plain.view(np.int32))


def _twin_fuse_schedule(n_warps, items, n_bricks):
    """numpy twin of fuse_bricks_kernel's walk: warp w takes items w,
    w + n_warps, ...; lane i of a batch of 32 fetches item first + i n_warps,
    the warp stops at the first item past ``items``. How often each item is
    taken, and the most batches of fetches a warp makes."""
    taken = np.zeros(n_bricks, np.int64)
    batches = 0
    for warp in range(n_warps):
        b = 0
        for first in range(warp, n_bricks, 32 * n_warps):
            if first >= items:
                break
            b += 1
            item = first + np.arange(32) * n_warps
            taken[item[item < items]] += 1
        batches = max(batches, b)
    return taken, batches


@pytest.mark.parametrize("n_warps, items", [(4224, 3119), (4224, 5671), (4224, 32768), (8448, 32768), (100, 32768),
                                            (100, 5000), (4224, 0)])
def test_fuse_schedule_takes_every_item_once(n_warps, items):
    taken, batches = _twin_fuse_schedule(n_warps, items, 32768)
    assert (taken[:items] == 1).all() and (taken[items:] == 0).all()
    assert batches == -(-items // (32 * n_warps))  # warp 0 has the most
    if n_warps >= 1024:  # a card's wave: one batch of fetches a warp, the chain of loads once
        assert batches <= 1


@pytest.mark.parametrize("seed", [None, 4], ids=["no_seed", "gradient_seed"])
@pytest.mark.parametrize("name", CASES)
def test_brick_fusion_equals_dense_bit_for_bit(name, seed):
    pre, dense, brick, (overflow, n_active) = _fuse_both(name, seed)
    assert not bool(overflow) and int(n_active) > 10
    assert int((dense.weight != pre.weight).sum()) > 500  # the frame updates the volume
    for d, b in zip(dense, brick):
        assert torch.equal(d.view(torch.int32), b.view(torch.int32))  # every bit, the sign of zero too
    if seed is not None:
        assert float(dense.grad.abs().max()) > 1e-3  # the derivative lane carries values


@pytest.mark.parametrize("name", CASES)
def test_brick_fusion_matches_jax(name):
    """One frame into an empty volume with a seeded pose: the port's
    integrate_brick against JAX's, within K2's tolerances."""
    _, jcfg, tcfg = _cfgs()
    v2c, depth = _case(name)
    r, t, tr, tt = _poses(v2c, seed=6)
    jvol, joverflow = jbrick.integrate_brick(jfusion.create_volume(jcfg), jfusion.scale_depth(jnp.asarray(depth)),
                                             r, t, SMALL_INTR, jcfg, cap=512)
    tvol = tfusion.create_volume(tcfg, "cpu")
    toverflow, _ = tfusion.integrate_brick(tvol, tfusion.scale_depth(torch.from_numpy(depth)), tr, tt, TINTR, tcfg,
                                           cap=512)
    assert bool(joverflow) == bool(toverflow) is False
    jw, tw = np.asarray(jvol.weight), tvol.weight.numpy()
    assert (jw > 0).sum() > 500
    assert np.mean(jw == tw) >= 0.9999
    same = jw == tw
    for plane in ("value", "grad"):
        np.testing.assert_allclose(getattr(tvol, plane).numpy()[same], np.asarray(getattr(jvol, plane))[same],
                                   atol=1e-5)


def test_cap_overflow_flags_and_leaves_the_same_bricks_unfused():
    _, jcfg, tcfg = _cfgs()
    v2c, depth = _case("orbit")
    r, t, tr, tt = _poses(v2c)
    jdm = jfusion.scale_depth(jnp.asarray(depth))
    jvol, joverflow = jbrick.integrate_brick(jfusion.create_volume(jcfg), jdm, r, t, SMALL_INTR, jcfg, cap=4)
    tvol = tfusion.create_volume(tcfg, "cpu")
    dm = tfusion.scale_depth(torch.from_numpy(depth))
    toverflow, n_active = tfusion.integrate_brick(tvol, dm, tr, tt, TINTR, tcfg, cap=4)
    assert bool(joverflow) and bool(toverflow) and int(n_active) > 4
    # the bricks each leaves unfused: ACTIVE ones of flat rank >= cap
    jcls = np.asarray(jbrick.classify_bricks_full(jdm, r.v, t.v, SMALL_INTR, jcfg, jcfg.resolution).cls).reshape(-1)
    classes = tbrick.classify_bricks(tbrick.depth_mips(dm), kernels.fusion_pose(tr, tt), TINTR, tcfg, 4)
    jdropped = np.flatnonzero(jcls == tbrick.ACTIVE)[4:]
    tdropped = np.flatnonzero(classes.rank.numpy() >= 4)
    assert len(tdropped) > 0 and np.array_equal(jdropped, tdropped)
    # there the weights stay 0 in both; the fused bricks carry the updates
    jw = jbrick.to_bricks(jvol.weight)
    tw = tbrick.to_bricks(tvol.weight)
    assert not np.asarray(jw[tdropped]).any() and not bool(tw[tdropped].any())
    assert np.mean(np.asarray(jvol.weight) == tvol.weight.numpy()) >= 0.9999
    assert int(tw.sum()) > 0


def test_brick_wrappers_launch_nothing_on_cpu():
    before = dict(kernels.launch_counts)
    _fuse_both("orbit")
    assert kernels.launch_counts == before
    assert before["depth_mips"] == before["classify_bricks"] == before["fuse_bricks"] == 0


def test_integrate_brick_checks_its_options():
    _, _, tcfg = _cfgs()
    vol = tfusion.create_volume(tcfg, "cpu")
    with pytest.raises(ValueError):
        tfusion.integrate_brick(vol, torch.zeros(120, 160), None, None, TINTR, tcfg, cap=4, overflow="drop")
    odd = tfusion.VolumeConfig((60, 64, 64), tcfg.voxel_size, tcfg.trunc_dist, tcfg.max_weight)
    with pytest.raises(ValueError):
        tbrick.classify_bricks_plain(torch.zeros(1, 3), torch.zeros(24), TINTR, odd)


# ------------------------------------------------------------- the engine
N_FRAMES = 6


def _engine_run(n, **options):
    cfg = small_config(end_frame=n, **options)
    ds = small_dataset(n, degrees_per_frame=1.0)
    engine = TorchEngine(torch_config(cfg), device="cpu")
    state = engine.init_state()
    flags, actives = [], []
    for i in range(n):
        state, res = engine.process_frame(state, ds.get_depth(i), gt_pose=ds.get_pose(i))
        engine.log_pose(res)
        flags.append(bool(res.fusion_overflow))
        actives.append(None if res.fusion_active is None else int(res.fusion_active))
    return state, flags, actives, engine


@pytest.mark.parametrize("overflow", ["flag", "dense"])
def test_engine_overflow(overflow):
    """tests/test_fusion_brick.py::test_engine_overflow_propagates_and_dense_fallback
    for the port: oracle poses (a crippled map must not stop integration)."""
    state, flags, actives, _ = _engine_run(2, use_gt_pose=True, fusion_mode="brick", fusion_brick_cap=4,
                                           fusion_overflow=overflow)
    assert all(a is not None and a > 4 for a in actives)
    dense, dflags, dactives, _ = _engine_run(2, use_gt_pose=True)
    assert dflags == [False, False] and dactives == [None, None]
    if overflow == "flag":
        assert flags == [True, True]
        assert not torch.equal(state.volume.weight, dense.volume.weight)
    else:
        assert flags == [False, False]
        for a, b in zip(state.volume, dense.volume):
            assert torch.equal(a, b)


@pytest.fixture(scope="module")
def brick_runs():
    """Six tracked frames with bench.py's fusion (brick, cap 2816, dense on
    overflow) on both engines, and the port's dense run."""
    options = dict(fusion_mode="brick", fusion_brick_cap=2816, fusion_overflow="dense")
    cfg = small_config(end_frame=N_FRAMES, **options)
    ds = small_dataset(N_FRAMES, degrees_per_frame=1.0)
    jeng = JaxEngine(cfg)
    jstate = jeng.init_state()
    jax_poses = []
    for i in range(N_FRAMES):
        jstate, jres = jeng.process_frame(jstate, ds.get_depth(i))
        jax_poses.append(np.array(jres.camera2world.v))
    runs = {}
    for mode, opts in (("brick", options), ("dense", {})):
        engine = TorchEngine(torch_config(small_config(end_frame=N_FRAMES, **opts)), device="cpu")
        state = engine.init_state()
        oks, actives = [], []
        for i in range(N_FRAMES):
            state, res = engine.process_frame(state, ds.get_depth(i))
            engine.log_pose(res)
            oks.append(bool(res.align_ok))
            actives.append(None if res.fusion_active is None else int(res.fusion_active))
        runs[mode] = (state, engine.pose_log, oks, actives)
    gt = normalize_to_first([ds.get_pose(i) for i in range(N_FRAMES)])
    return jax_poses, runs, gt


def test_brick_run_in_the_jax_engines_ate_class(brick_runs):
    jax_poses, runs, gt = brick_runs
    _, poses, oks, actives = runs["brick"]
    assert all(oks) and all(0 < a <= 2816 for a in actives)
    ate_j = ate_rmse(normalize_to_first(jax_poses), gt)
    ate_t = ate_rmse(normalize_to_first(poses), gt)
    assert ate_j < 0.06 and ate_t < 0.06, (ate_j, ate_t)
    assert abs(ate_j - ate_t) < 5e-3, (ate_j, ate_t)


def test_brick_run_equals_the_dense_run(brick_runs):
    """Brick fusion gives dense fusion's volume every frame, so the whole
    tracked run is the dense run's, pose for pose and bit for bit."""
    _, runs, _ = brick_runs
    bstate, bposes, _, _ = runs["brick"]
    dstate, dposes, _, _ = runs["dense"]
    for a, b in zip(bstate.volume, dstate.volume):
        assert torch.equal(a, b)
    for a, b in zip(bposes, dposes):
        assert np.array_equal(a, b)
