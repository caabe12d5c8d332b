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
- B3b ranks bricks by per-block counts and warp ballots, B3a walks pixel
  columns with lanes adjacent in x and reduces each tile in a group of
  lanes, and B3c gives a warp a brick and a lane two z columns; their numpy
  twins here show the ranks are flat brick order, every pixel is read once
  and every mip row has one owner (the twin's table the plain version's),
  every voxel of a brick is visited once with the plain order of its
  camera-coordinate sums, and every work item is taken once.
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


def _twin_rank(cls_flat, cap, block=tbrick.CLASSIFY_BLOCK):
    """numpy twin of csrc/bricks.cu's rank_bricks_kernel: block b adds the
    counts of blocks < b, then ranks its own bricks by warp ballots (the
    warps' popcounts before it, then the lanes' below it)."""
    n = cls_flat.size
    blocks = -(-n // block)
    padded = np.full(blocks * block, tbrick.NONE, np.int64)
    padded[:n] = cls_flat
    per_block = padded.reshape(blocks, block)
    counts = [((per_block == tbrick.ACTIVE).sum(1)), ((per_block != tbrick.NONE).sum(1))]
    rank = np.full(n, -1, np.int64)
    active_ids = np.full(n, -1, np.int64)
    work_ids = np.full(n, -1, np.int64)
    for b in range(blocks):
        for pred, before, out in ((per_block[b] == tbrick.ACTIVE, counts[0][:b].sum(), active_ids),
                                  (per_block[b] != tbrick.NONE, counts[1][:b].sum(), work_ids)):
            warps = pred.reshape(-1, 32)
            pops = warps.sum(1)
            for w in range(warps.shape[0]):
                for lane in range(32):
                    if warps[w, lane]:
                        r = before + pops[:w].sum() + warps[w, :lane].sum()
                        out[r] = b * block + w * 32 + lane
                        if out is active_ids:
                            rank[b * block + w * 32 + lane] = r
    return rank, active_ids, work_ids, counts[0].sum(), counts[1].sum()


@pytest.mark.parametrize("n", [512, 1000, 32768])
def test_rank_twin_is_flat_order(n):
    rng = np.random.default_rng(n)
    cls = rng.choice(4, size=n, p=[0.6, 0.2, 0.15, 0.05]).astype(np.int32)
    rank, active_ids, work_ids, n_active, n_work = _twin_rank(cls, cap=0)
    plain = tbrick.rank_bricks_plain(torch.from_numpy(cls), cap=int(n_active) - 1)
    assert np.array_equal(rank, plain.rank.numpy())
    assert np.array_equal(active_ids[:n_active], plain.active_ids[:n_active].numpy())
    assert np.array_equal(work_ids[:n_work], plain.work_ids[:n_work].numpy())
    assert np.array_equal(active_ids[:n_active], np.flatnonzero(cls == tbrick.ACTIVE))
    assert plain.totals.tolist() == [n_active, n_work] and bool(plain.overflow)
    assert (plain.active_ids[n_active:] == n).all()  # the plain version pads with NB


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
