"""The schedules of two redesigned kernels, held on the CPU (a CUDA kernel
cannot run here; the smoke run holds the kernels themselves to their plain
versions on the card).

- B15c, the subcell stage (``csrc/bricks.cu``, ``classify_subcells_kernel``):
  a numpy twin of its lanes (a candidate row's 8 subcell boxes, ``box``
  lanes each, ``threads`` lanes a block) and of its single-pass scan (the
  blocks take their runs of rows by an atomic ticket, in a seeded order, a
  few at a time; each publishes its tiles' counts as two status words tagged
  with the launch's epoch, sums the counts of every earlier tile, reloading
  words not yet published under this epoch, and ranks its boxes by its
  warps' ballots) gives ``classify_subcells_plain``'s ranks, counts and flag
  bit for bit: at caps 1, 16, 300, 2816 and 5000 (a cut last tile), at every
  lanes a box, block and tile size the kernel was swept at, with candidates
  past the ACTIVE count and stale words of an earlier launch on the scratch;
  and on the classifier scenes' own subcell classes. The wrapper's constants
  are the source's.
- K5r, the refine over brick rows (``csrc/refine.cu``, ``refine_rows_kernel``):
  the per-axis row terms sum to ``ops/bricks.py::flat_index`` (rows.cuh's
  ``row_index``) at every voxel of grids whose brick counts differ on every
  axis; the normal stage's block of 20 voxels, addressed from the vertex
  cell's terms and one term a face, names each staged sample's own taps, and
  a sample that reads its own cell takes the vertex cell's terms on the other
  axes; and ``refine`` with a trilinear twin that addresses every tap by the
  terms gives ``refine`` through ``trilinear_pair_bricks`` bit for bit on the
  scene of ``tests/test_torch_brick_raycasts.py`` (its configuration, frames
  and rays, the volume fused here by the port).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.helpers import small_config, small_dataset
from tests.test_torch_brick_raycasts import _bits
from tests.test_torch_fusion_classifiers import TINTR, _cfgs, _inputs
from tests.test_torch_raycast import _cell_twin, _rule_vertices
from tests.torch_port_helpers import seeded_pose_direction
from xslam_tpu_torch.csfd import vec3
from xslam_tpu_torch.csfd.single import CSFD, lift
from xslam_tpu_torch.geometry import se3
from xslam_tpu_torch.ops import bricks as tbricks
from xslam_tpu_torch.ops import fusion as tfusion
from xslam_tpu_torch.ops import fusion_brick as tbrick
from xslam_tpu_torch.ops import kernels
from xslam_tpu_torch.ops import raycast as traycast
from xslam_tpu_torch.ops import raycast_bricks as trb
from xslam_tpu_torch.ops.kernels import INF_T
from xslam_tpu_torch.ops.sampling import to_index

CSRC = Path(__file__).resolve().parents[1] / "xslam_tpu_torch" / "csrc"


def _source_constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m is not None, f"{source} has no constexpr int {name}"
    return int(m.group(1))


COUNT_BITS = _source_constant("bricks.cu", "SUBCELL_COUNT_BITS")  # a tile's count of one id in a status word
# (lanes a box, threads a block, rows a tile) the kernel was swept at: every tile that divides a block's rows
SWEPT = ([(1, t, tile) for t in (128, 256, 512) for tile in (8, 16, 32) if tile <= t // 8]
         + [(2, t, tile) for t in (128, 256, 512) for tile in (8, 16, 32) if tile <= t // 16])


def test_subcell_constants_are_the_source_s():
    """The wrapper's lanes, threads, tile, rows a block and epoch bits are
    ``csrc/bricks.cu``'s; B3b and B15s keep two lanes a box."""
    assert (tbrick.SUBCELL_BOX_LANES, tbrick.SUBCELL_THREADS, tbrick.SUBCELL_TILE) == tuple(
        _source_constant("bricks.cu", k) for k in ("SUBCELL_BOX_LANES", "SUBCELL_THREADS", "SUBCELL_TILE"))
    assert (tbrick.SUBCELL_BOX_LANES, tbrick.SUBCELL_THREADS, tbrick.SUBCELL_TILE) in SWEPT
    assert tbrick.SUBCELL_ROWS == tbrick.SUBCELL_THREADS // (8 * tbrick.SUBCELL_BOX_LANES)
    assert tbrick.SUBCELL_EPOCH_BITS == 64 - 4 * COUNT_BITS and tbrick.SUBCELL_TILE < 2 ** COUNT_BITS
    assert _source_constant("bricks.cu", "CORNER_LANES") == 2
    assert tbrick.subcell_tiles(2816) == tbrick.subcell_blocks(2816) * (tbrick.SUBCELL_ROWS // tbrick.SUBCELL_TILE)


# ------------------------------------------------------------------ B15c
def _plain_lists(cls: np.ndarray, subcell_cap: int):
    """``classify_subcells_plain``'s ranks, counts and flag of (cap, 8) classes."""
    c = torch.from_numpy(cls)
    active = c == tbrick.ACTIVE
    rank = torch.where(active, torch.cumsum(active.to(torch.int32), 0) - 1, -1).to(torch.int32)
    counts = active.sum(0).to(torch.int32)
    return rank.numpy(), counts.numpy(), bool((counts > subcell_cap).any())


def _popcount(x):
    return np.bitwise_count(np.asarray(x, np.uint64)).astype(np.int64)


def subcell_scan_twin(cls, n_rows, subcell_cap, box, threads, tile, rng, scratch=None, resident=5):
    """A numpy twin of classify_subcells_kernel, blocks as coroutines (as
    ``tests/test_torch_fusion_brick.py::_twin_scan``): they start in a seeded
    order, at most ``resident`` at a time, a step of a random running block at
    a time, each taking its run of ``threads / (8 box)`` rows by the ticket
    (the counter runs on from launch to launch; the host passes the tickets
    taken so far and the launch's epoch). Thread t of a block is lane j = t %
    box of box g = t / box: subcell g % 8 of row g / 8, its class ``cls[row]``
    below ``n_rows``, else NONE. A block with no candidate writes NONE and no
    rank and leaves (the first also zero counts). Else each warp ballots its
    boxes' ACTIVE flags (a box's first lane), the block publishes each tile's
    8 counts as two words, ``epoch << 4 COUNT_BITS`` over four ids' counts,
    one store each, then sums the counts of every earlier tile, reloading the
    tiles whose two words do not both carry this epoch, and ranks each box by
    its id's subcells before the block, before its warp and below its lane.
    The block of the last candidate writes the counts and the flag. Returns
    (classes, ranks, counts, flag, scratch)."""
    cap = cls.shape[0]
    rows_a_block = threads // (8 * box)
    warps, tile_warps = threads // 32, tile // (32 // (8 * box))
    blocks = -(-cap // rows_a_block)
    tiles_a_block = rows_a_block // tile
    id_lanes = sum(1 << (r * 8 * box) for r in range(32 // (8 * box)))
    if scratch is None:  # zeroed when made
        scratch = dict(ticket=0, status=np.zeros((0, 2), np.uint64), tickets=0, launches=0)
    if scratch["status"].shape[0] < blocks * tiles_a_block:  # grown with zeros: epoch 0 is no launch's
        scratch["status"] = np.concatenate(
            [scratch["status"], np.zeros((blocks * tiles_a_block - scratch["status"].shape[0], 2), np.uint64)])
    base = scratch["tickets"] % 2 ** 32
    scratch["tickets"] += blocks
    scratch["launches"] += 1
    epoch = scratch["launches"]
    status = scratch["status"]
    shift, mask = np.uint64(4 * COUNT_BITS), np.uint64((1 << COUNT_BITS) - 1)
    out_cls, out_rank = np.full((cap, 8), -7), np.full((cap, 8), -7)  # -7: never written
    out = {}
    t = np.arange(threads)
    j, g, warp, lane = t % box, t // box, t // 32, t % 32
    s = g % 8

    def block():
        blk = (scratch["ticket"] - base) % 2 ** 32
        scratch["ticket"] += 1
        assert blk < blocks
        yield
        row = blk * rows_a_block + g // 8
        stored = (j == 0) & (row < cap)
        if blk * rows_a_block >= n_rows:
            out_cls[row[stored], s[stored]] = tbrick.NONE
            out_rank[row[stored], s[stored]] = -1
            if blk == 0:
                out["counts"], out["flag"] = np.zeros(8, np.int64), False
            return
        c = np.where(row < n_rows, cls[np.minimum(row, cap - 1), s], tbrick.NONE)
        active = (j == 0) & (c == tbrick.ACTIVE)
        ballot = (active.astype(np.uint64) << lane.astype(np.uint64)).reshape(warps, 32).sum(1)
        count = np.stack([_popcount(ballot & np.uint64(id_lanes << (i * box))) for i in range(8)], 1)
        per_tile = count.reshape(tiles_a_block, tile_warps, 8).sum(1)
        assert (per_tile < 2 ** COUNT_BITS).all()
        tile0 = blk * tiles_a_block
        for k in range(tiles_a_block):
            for h in range(2):  # two stores: a reader may find one of them published
                word = sum(int(per_tile[k, 4 * h + i]) << (COUNT_BITS * i) for i in range(4))
                status[tile0 + k, h] = (epoch << (4 * COUNT_BITS)) | word
                yield
        before = np.zeros(8, np.int64)
        pending = np.arange(tile0)
        for _ in range(10_000):  # the kernel traps after LOOK_BACK_LIMIT_NS
            w = status[pending]  # the lanes' loads, all together
            done = ((w >> shift) == np.uint64(epoch)).all(1)
            for k in range(8):
                before[k] += int(((w[done, k >> 2] >> np.uint64(COUNT_BITS * (k & 3))) & mask).sum())
            pending = pending[~done]
            if not pending.size:
                break
            yield  # reload
        assert not pending.size
        base_w = before + np.cumsum(count, 0) - count  # each id's subcells before each warp's rows
        if (blk + 1) * rows_a_block >= n_rows:
            total = before + count.sum(0)
            out["counts"], out["flag"] = total, bool((total > subcell_cap).any())
        yield
        below = (np.uint64(1) << lane.astype(np.uint64)) - np.uint64(1)
        mine = _popcount(ballot[warp] & (np.uint64(id_lanes) << (s * box).astype(np.uint64)) & below)
        out_cls[row[stored], s[stored]] = c[stored]
        out_rank[row[stored], s[stored]] = np.where(c == tbrick.ACTIVE, base_w[warp, s] + mine, -1)[stored]

    waiting, running = blocks, []
    while waiting or running:
        if waiting and len(running) < resident and (not running or rng.random() < 0.5):
            running.append(block())
            waiting -= 1
        k = int(rng.integers(len(running)))
        try:
            next(running[k])
        except StopIteration:
            running.pop(k)
    assert scratch["ticket"] == scratch["tickets"]
    return out_cls, out_rank, out["counts"], out["flag"], scratch


@pytest.mark.parametrize("box, threads, tile", SWEPT)
@pytest.mark.parametrize("cap", [1, 16, 300, 2816, 5000])
def test_subcell_scan_twin_gives_the_plain_ranks(cap, box, threads, tile):
    """Two launches of the twin on one scratch give the plain version's
    classes (NONE past the candidates), ranks, counts and flag: every row a
    candidate under a list capacity of the cap, then, over the first launch's
    stale words, candidates past the ACTIVE count under a starved capacity."""
    rng = np.random.default_rng(cap * 1000 + threads + 10 * tile + box)
    scratch = None
    for n_rows, starved in ((cap, False), (int(rng.integers((cap + 1) // 2, cap + 1)), True)):
        cls = rng.integers(0, 4, (cap, 8))
        subcell_cap = max(1, n_rows // 8) if starved else cap
        want = np.where(np.arange(cap)[:, None] < n_rows, cls, tbrick.NONE)
        out_cls, rank, counts, flag, scratch = subcell_scan_twin(cls, n_rows, subcell_cap, box, threads, tile, rng,
                                                                 scratch)
        p_rank, p_counts, p_flag = _plain_lists(want, subcell_cap)
        np.testing.assert_array_equal(out_cls, want)
        np.testing.assert_array_equal(rank, p_rank)
        np.testing.assert_array_equal(counts, p_counts)
        assert flag == p_flag
    assert scratch["launches"] == 2


@pytest.mark.parametrize("box, threads, tile", [SWEPT[0], SWEPT[-1]])
def test_subcell_scan_twin_with_no_candidate(box, threads, tile):
    """No ACTIVE brick: the first block writes zero counts and no flag, every
    row NONE and no rank."""
    rng = np.random.default_rng(3)
    out_cls, rank, counts, flag, _ = subcell_scan_twin(np.full((300, 8), tbrick.ACTIVE), 0, 1, box, threads, tile,
                                                       rng)
    assert (out_cls == tbrick.NONE).all() and (rank == -1).all() and not counts.any() and not flag


@pytest.mark.parametrize("name", ["orbit", "corner", "regression", "step"])
def test_subcell_scan_twin_on_the_classifier_scenes(name):
    """On the classifier scenes' candidates (the first ``cap`` ACTIVE bricks),
    the twin at the kernel's constants gives ``classify_subcells_plain``'s
    ranks, counts and flag from its classes, at a list capacity of the cap
    and at a starved 4."""
    _, _, tcfg = _cfgs()
    _, _, _, table, pose = _inputs(name)
    cap = 64
    rng = np.random.default_rng(5)
    for subcell_cap in (cap, 4):
        classes = tbrick.classify_bricks(table, pose, TINTR, tcfg, cap)
        n_rows = min(int(classes.totals[0]), cap)
        plain = tbrick.classify_subcells_plain(table, pose, TINTR, tcfg, classes, cap, subcell_cap)
        out_cls, rank, counts, flag, _ = subcell_scan_twin(
            plain.cls.numpy(), n_rows, subcell_cap, tbrick.SUBCELL_BOX_LANES, tbrick.SUBCELL_THREADS,
            tbrick.SUBCELL_TILE, rng)
        np.testing.assert_array_equal(out_cls, plain.cls.numpy())
        np.testing.assert_array_equal(rank, plain.rank.numpy())
        np.testing.assert_array_equal(counts, plain.counts.numpy())
        assert flag == bool(plain.overflow)


# ------------------------------------------------------------------ K5r
def row_term(res, axis: int, v):
    """``csrc/refine.cu::row_term``: axis ``axis``'s share of a voxel's row
    index, (v >> 3) times the axis's brick stride in elements plus (v & 7)
    times its lane stride, in 32-bit unsigned arithmetic."""
    _, nby, nbz = tbricks.brick_grid(res)
    lanes = tbricks.BRICK ** 3
    brick = (nby * nbz * lanes, nbz * lanes, lanes)[axis]
    out = (v >> 3) * brick + ((v & 7) << (6, 3, 0)[axis])
    return out % 2 ** 32 if isinstance(out, np.ndarray) else out


@pytest.mark.parametrize("nb", [(1, 2, 3), (3, 5, 2), (4, 1, 6)])
def test_row_terms_sum_to_flat_index(nb):
    res = tuple(8 * n for n in nb)
    x, y, z = np.meshgrid(*(np.arange(r, dtype=np.int64) for r in res), indexing="ij")
    terms = row_term(res, 0, x) + row_term(res, 1, y) + row_term(res, 2, z)
    flat = tbricks.flat_index(res, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(terms, flat)
    # row_index's own grouping, ((bx nby + by) nbz + bz) 512 + lane
    b = ((x >> 3) * nb[1] + (y >> 3)) * nb[2] + (z >> 3)
    np.testing.assert_array_equal(terms, b * 512 + (((x & 7) << 6) | ((y & 7) << 3) | (z & 7)))
    assert np.unique(terms).size == terms.size and terms.max() == terms.size - 1


def _rows_block_twin(vertex, voxel_size, res):
    """K5r's normal stage (``csrc/refine.cu::axis_difference`` with L_ROWS) in
    numpy: the vertex cell's terms vt (two an axis), each face's addresses
    from one term on its axis and vt on the other two, the staged taps picked
    from the block and the face as K5 picks them, and a sample that reads its
    own cell from vt on the other axes and two terms of its own. Returns, for
    the six samples, (the flat indices of the taps its own cell names, the
    addresses the kernel reads, whether it took them from the block)."""
    f = np.float32
    vs, inv_vs, half = f(voxel_size), f(kernels.reciprocal_f32(voxel_size)), f(voxel_size * 0.5)
    gv = [np.floor(vertex[i] * inv_vs).astype(np.int64) for i in range(3)]
    cv = [_cell_twin(vertex[i], inv_vs, vs, res[i])[0] for i in range(3)]
    vt = [[row_term(res, i, cv[i] + e) for e in range(2)] for i in range(3)]
    corners = [[(k >> 2) & 1, (k >> 1) & 1, k & 1] for k in range(8)]
    own, read, staged = [], [], []
    for a in range(3):
        upper = cv[a] == gv[a]
        face = np.where(upper, gv[a] - 1, gv[a] + 1)
        # along axis a, line m holds the term of the voxel at g - 1 + m: the block's (at cv, cv + 1) or the face's
        fterm = row_term(res, a, face)
        line = [np.where(upper, fterm, vt[a][0]), np.where(upper, vt[a][0], vt[a][1]),
                np.where(upper, vt[a][1], fterm)]
        for s, sign in enumerate((1.0, -1.0)):
            q = [vertex[i].copy() for i in range(3)]
            q[a] = (vertex[a] + f(sign) * half).astype(f)
            cells = [_cell_twin(q[i], inv_vs, vs, res[i]) for i in range(3)]
            ok = cells[0][1] & cells[1][1] & cells[2][1]
            took = ok & (cells[a][0] == gv[a] - s)
            # the sample's own cell on axis a (the vertex cell's base where out of bounds), vt on the others
            b = np.where(ok, cells[a][0], cv[a])
            own_terms = [row_term(res, a, b), row_term(res, a, b + 1)]
            flat, addr = [], []
            for d in corners:
                xyz = [torch.from_numpy(cells[i][0] + d[i]) for i in range(3)]
                flat.append(tbricks.flat_index(res, *xyz).numpy())
                others = sum(vt[i][d[i]] for i in range(3) if i != a)
                addr.append(np.where(took, line[d[a] + 1 - s], own_terms[d[a]]) + others)
            own.append(np.stack(flat, 1))
            read.append(np.stack(addr, 1))
            staged.append(took)
    return own, read, staged


@pytest.mark.parametrize("voxel_size, res", [(0.03, (256, 256, 256)), (0.12, (64, 72, 48))])
@pytest.mark.parametrize("kind", ["random", "cell edges", "cell centres"])
def test_normal_block_terms_read_each_sample_s_taps(kind, voxel_size, res):
    """Inside the normal's margin every one of the six samples reads, tap by
    tap, the voxels its own cell names, whether from the block addressed by
    terms or from its own cell; both ways are taken on vertices near cell
    edges."""
    vertex = _rule_vertices(kind, voxel_size, res)
    own, read, staged = _rows_block_twin(vertex, voxel_size, res)
    for o, r, s in zip(own, read, staged):
        np.testing.assert_array_equal(r, o)
    if kind == "cell edges":
        assert 0.0 < 1.0 - np.mean(staged) < 0.5


def _terms_trilinear(vg, res, px: CSFD, py: CSFD, pz: CSFD, voxel_size: float) -> CSFD:
    """``trilinear_pair_bricks`` with every tap addressed as K5r addresses it:
    the cell's two terms an axis (``row_term``), summed (the bounds fills, the
    +1e-5 bias, the weights and the order of the sums are the plain one's)."""
    X, Y, Z = res
    inv_vs = 1.0 / voxel_size
    g = [to_index(torch.floor(p.v * inv_vs)) for p in (px, py, pz)]
    ok = (g[0] > 0) & (g[0] < X - 1) & (g[1] > 0) & (g[1] < Y - 1) & (g[2] > 0) & (g[2] < Z - 1)
    g = [gi - (p.v < (gi.to(torch.float32) + 0.5) * voxel_size).to(gi.dtype) for gi, p in zip(g, (px, py, pz))]
    w0 = [p * inv_vs - (gi.to(torch.float32) + 0.5) for p, gi in zip((px, py, pz), g)]
    one = lift(1.0)
    w1 = [one - w for w in w0]
    ext = (X, Y, Z)
    term = [[row_term(res, i, (g[i] + e).clamp(0, ext[i] - 1)) for e in range(2)] for i in range(3)]
    inside = [[(g[i] + e >= 0) & (g[i] + e < ext[i]) for e in range(2)] for i in range(3)]

    def tap(dx, dy, dz) -> CSFD:
        idx = term[0][dx] + term[1][dy] + term[2][dz]
        okt = inside[0][dx] & inside[1][dy] & inside[2][dz]
        r = vg[idx.reshape(-1)].reshape(*idx.shape, 2)
        return CSFD(torch.where(okt, r[..., 0], 0.0) + 1e-5, torch.where(okt, r[..., 1], 0.0))

    weights = {0: w1, 1: w0}
    out = None
    for k in range(8):
        d = ((k >> 2) & 1, (k >> 1) & 1, k & 1)
        part = tap(*d) * (weights[d[0]][0] * weights[d[1]][1] * weights[d[2]][2])
        out = part if out is None else out + part
    return CSFD(torch.where(ok, out.v, torch.nan), torch.where(ok, out.g, 0.0))


@pytest.fixture(scope="module")
def rows_scene():
    """The scene of ``tests/test_torch_brick_raycasts.py``: the small
    configuration's 64^3 volume over 4 orbit frames at 1 degree a frame,
    fused here by the port (dense fusion, whose bits brick fusion keeps) and
    laid out as brick rows; frame 3's rays with a seeded derivative lane on
    the camera pose, the volume->world pose and the skip march's hits."""
    cfg = small_config()
    tcfg = tfusion.VolumeConfig(tuple(cfg.tsdf_size), cfg.voxel_size, cfg.trunc_dist, cfg.max_integration_weight)
    res = tcfg.resolution
    ds = small_dataset(4, degrees_per_frame=1.0)
    w2v = lift(torch.from_numpy(np.asarray(cfg.world2volume, np.float32)))
    vol = tfusion.create_volume(tcfg, "cpu")
    for i in range(4):
        v2c = se3.inverse(se3.matmul(w2v, lift(torch.from_numpy(np.asarray(ds.get_pose(i), np.float32)))))
        tfusion.integrate(vol, tfusion.scale_depth(torch.from_numpy(ds.get_depth(i))), se3.rotation(v2c),
                          se3.translation(v2c), TINTR, tcfg)
    rows = tbricks.from_dense(*vol)
    c2v = se3.matmul(w2v, lift(torch.from_numpy(np.asarray(ds.get_pose(3), np.float32))))
    c2v = CSFD(c2v.v, torch.from_numpy(np.asarray(seeded_pose_direction(2), np.float32)))
    ray_dir, ray_start = kernels.camera_rays(se3.rotation(c2v), se3.translation(c2v), TINTR)
    packed = trb._value_reader(tbricks.skip_rows(rows, res), res)
    hit = traycast.march_skip_plain(ray_start, ray_dir.v, tcfg, packed, res)
    v2w = se3.inverse(w2v)
    return dict(tcfg=tcfg, rows=rows, start=ray_start, dir=ray_dir, hit=hit,
                v2w=(se3.rotation(v2w), se3.translation(v2w)))


def test_terms_refine_is_the_pair_refine(rows_scene):
    """``refine`` with every tap addressed by the terms gives K5r's plain
    version, ``refine`` through ``trilinear_pair_bricks``, bit for bit (every
    lane of both maps, both masks) on the scene's frame 3."""
    tcfg, hit = rows_scene["tcfg"], rows_scene["hit"]
    res = tcfg.resolution
    accept = hit.t_found < torch.clamp(hit.t_dead, max=INF_T)
    assert float(accept.float().mean()) > 0.5
    args = (rows_scene["start"], rows_scene["dir"], hit.t_found, accept, *rows_scene["v2w"], tcfg)
    vg = trb.interleave_vg(rows_scene["rows"])

    def terms(p):
        return _terms_trilinear(vg, res, *(vec3.comp(p, i) for i in range(3)), tcfg.voxel_size)

    want = traycast.refine(None, *args, trilin_fn=trb._pair_trilinear(rows_scene["rows"], tcfg), shape=res)
    got = traycast.refine(None, *args, trilin_fn=terms, shape=res)
    for a, b in zip((got[0].v, got[0].g, got[1].v, got[1].g), (want[0].v, want[0].g, want[1].v, want[1].g)):
        assert _bits(a, b)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert float(want[3].float().mean()) > 0.5
