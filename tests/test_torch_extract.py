"""The port's surface extraction (``xslam_tpu_torch.ops.extract``) against
``xslam_tpu.ops.extract`` on the CPU.

- Points: ``extract_points_plain`` (the plain version of kernel B13, which
  the wrapper runs on CPU tensors) on a 64^3 volume fused from 3 frames of
  the small synthetic sweep, on its brick layout's dense twin, and at a
  capacity below the count. ``count`` and the points equal JAX's bit for
  bit; the normals within 1e-5, because XLA on the CPU contracts
  multiply-adds that PyTorch rounds twice.
- Meshes: marching tetrahedra and the 256-case marching cubes against JAX's
  on a 32^3 cut of that volume, triangle for triangle in the same order,
  within 1e-5 (the same contractions), also below capacity; the derived MC
  table equals JAX's.
- B13's compaction (a kernel cannot run here): a numpy twin of its tiles,
  chunks, ballots and row offsets gives every crossing of the fused volume
  its row in the plain version's order. B13's tile constant is the kernel
  source's, and the wrapper raises for inputs it cannot take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import SMALL_INTR, small_config, small_dataset
from xslam_tpu.ops import bricks as jbricks
from xslam_tpu.ops import extract as jextract
from xslam_tpu.ops import fusion as jfusion
from xslam_tpu_torch.csfd.single import lift
from xslam_tpu_torch.geometry import se3 as tse3
from xslam_tpu_torch.geometry.intrinsics import Intrinsics
from xslam_tpu_torch.ops import bricks as tbricks
from xslam_tpu_torch.ops import extract as textract
from xslam_tpu_torch.ops import fusion as tfusion
from xslam_tpu_torch.ops import kernels

NORMAL_TOL = 1e-5
MESH = 32  # the meshers' volume: a 32^3 cut of the fused one


@pytest.fixture(scope="module")
def fused():
    """A 64^3 volume fused from 3 frames (numpy planes) and its configs."""
    cfg = small_config()
    tcfg = tfusion.VolumeConfig(tuple(cfg.tsdf_size), cfg.voxel_size, cfg.trunc_dist, cfg.max_integration_weight)
    jcfg = jfusion.VolumeConfig(tuple(cfg.tsdf_size), cfg.voxel_size, cfg.trunc_dist, cfg.max_integration_weight)
    ds = small_dataset(5, degrees_per_frame=2.0)
    w2v = torch.as_tensor(np.asarray(cfg.world2volume, np.float32))
    vol = tfusion.create_volume(tcfg, "cpu")
    for frame in (0, 2, 4):
        c2w = np.linalg.inv(ds.get_pose(0)) @ ds.get_pose(frame)
        v2c = tse3.inverse(tse3.matmul(lift(w2v), lift(torch.as_tensor(c2w.astype(np.float32)))))
        depth = tfusion.scale_depth(torch.from_numpy(ds.get_depth(frame)))
        tfusion.integrate(vol, depth, tse3.rotation(v2c), tse3.translation(v2c), Intrinsics(*SMALL_INTR), tcfg)
    planes = tuple(x.numpy().copy() for x in vol)
    return planes, tcfg, jcfg


def _jax_points(planes, jcfg, capacity):
    jvol = jfusion.VolumeState(*(jnp.asarray(p) for p in planes))
    pc = jax.jit(lambda v: jextract.extract_points(v, jcfg, capacity=capacity))(jvol)
    return int(pc.count), np.asarray(pc.points), np.asarray(pc.normals)


def _port_points(planes, tcfg, capacity):
    pc = textract.extract_points(tfusion.VolumeState(*(torch.from_numpy(p) for p in planes)), tcfg, capacity)
    assert pc.count.dtype == torch.int32
    return int(pc.count), pc.points.numpy(), pc.normals.numpy()


def _same_points(j, t):
    (jn, jp, jnrm), (tn, tp, tnrm) = j, t
    assert tn == jn
    assert tp.shape == jp.shape and tp.dtype == np.float32
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(tnrm, jnrm, rtol=0, atol=NORMAL_TOL)
    # the rows past the count are zero points with zero normals
    assert not tp[tn:].any() and not tnrm[tn:].any()


@pytest.mark.parametrize("capacity", [200_000, 1_000], ids=["full", "below_count"])
def test_points_against_jax(fused, capacity):
    planes, tcfg, jcfg = fused
    j = _jax_points(planes, jcfg, capacity)
    t = _port_points(planes, tcfg, capacity)
    _same_points(j, t)
    if capacity == 200_000:
        assert 1_000 < t[0] < capacity
        norms = np.linalg.norm(t[2][:t[0]], axis=1)
        assert (norms > 0).mean() > 0.9
    else:
        assert t[0] == capacity  # the volume holds more crossings than that


def test_points_on_the_brick_layouts_dense_twin(fused):
    """The CLI extracts ``engine.dense_volume(state)``: on the brick layout the
    dense twin of the (NB, 512) rows. Each package's twin of the same rows,
    then each package's extraction."""
    planes, tcfg, jcfg = fused
    rows = tbricks.from_dense(*(torch.from_numpy(p) for p in planes))
    twin = tbricks.to_dense(rows, tcfg.resolution)
    jtwin = jbricks.to_dense(jbricks.BrickVolume(*(jnp.asarray(r.numpy()) for r in rows)), jcfg.resolution)
    np.testing.assert_array_equal(twin.value.numpy(), np.asarray(jtwin.value))
    j = _jax_points(tuple(np.asarray(p) for p in jtwin), jcfg, 200_000)
    t = _port_points(tuple(p.numpy() for p in twin), tcfg, 200_000)
    _same_points(j, t)


def _mesh_volume(fused):
    planes, tcfg, jcfg = fused
    cut = tuple(np.ascontiguousarray(p[16:16 + MESH, 8:8 + MESH, 32:32 + MESH]) for p in planes)  # holds the wall
    t = tfusion.VolumeConfig((MESH,) * 3, tcfg.voxel_size, tcfg.trunc_dist, tcfg.max_weight)
    j = jfusion.VolumeConfig((MESH,) * 3, jcfg.voxel_size, jcfg.trunc_dist, jcfg.max_weight)
    return cut, t, j


@pytest.mark.parametrize("capacity", [60_000, 500], ids=["full", "below_count"])
@pytest.mark.parametrize("mesher", ["extract_mesh", "extract_mesh_mc"])
def test_meshers_against_jax(fused, mesher, capacity):
    cut, tcfg, jcfg = _mesh_volume(fused)
    jvol = jfusion.VolumeState(*(jnp.asarray(p) for p in cut))
    jm = jax.jit(lambda v: getattr(jextract, mesher)(v, jcfg, capacity=capacity))(jvol)
    tm = getattr(textract, mesher)(tfusion.VolumeState(*(torch.from_numpy(p) for p in cut)), tcfg, capacity)
    n = int(tm.count)
    assert tm.count.dtype == torch.int32 and n == int(jm.count)
    assert n == capacity if capacity == 500 else 1_000 < n < capacity
    np.testing.assert_allclose(tm.vertices.numpy(), np.asarray(jm.vertices), rtol=0, atol=NORMAL_TOL)
    assert not tm.vertices[n:].any()


def test_mc_table_is_jax_table():
    np.testing.assert_array_equal(textract._MC_TABLE, jextract._MC_TABLE)


def _kernel_constants():
    import re

    src = (kernels.CSRC_DIR / "extract.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
                 for name in ("EXTRACT_THREADS", "EXTRACT_ROUNDS"))


def _b13_rows(masks: np.ndarray, threads: int, rounds: int) -> np.ndarray:
    """The row csrc/extract.cu gives each crossing of ``masks`` ((3, N) bool,
    axis a's +a edges in C order), -1 elsewhere: the tiles' counts and their
    chunks' (a warp's 32 voxels of a round: chunk r * warps + w of a tile
    holds its voxels r * threads + 32 w + lane), a tile's three row offsets
    (the counts of axis a's earlier tiles after every earlier axis's total),
    each chunk's first row (the offset and the counts of the tile's earlier
    chunks), then the lanes below a lane in the chunk's ballot."""
    n = masks.shape[1]
    tile = threads * rounds
    n_tiles = -(-n // tile)
    padded = np.zeros((3, n_tiles * tile), bool)
    padded[:, :n] = masks
    chunks = padded.reshape(3, n_tiles, tile // 32, 32)
    chunk_counts = chunks.sum(-1)
    counts = chunk_counts.sum(-1)
    total = counts.sum(1)
    rows = np.full(padded.shape, -1)
    for t in range(n_tiles):
        before = counts[:, :t].sum(1)
        row0 = [before[0], total[0] + before[1], total[0] + total[1] + before[2]]
        for a in range(3):
            first = row0[a] + np.cumsum(chunk_counts[a, t]) - chunk_counts[a, t]
            below = np.cumsum(chunks[a, t], axis=1) - chunks[a, t]
            rows[a, t * tile:(t + 1) * tile] = np.where(chunks[a, t], first[:, None] + below, -1).reshape(-1)
    return rows[:, :n]


def test_b13_compaction_twin_is_the_plain_order(fused):
    planes, _, _ = fused
    value, weight = torch.from_numpy(planes[0]), torch.from_numpy(planes[2])
    masks = np.stack([textract._edge_crossings(value, weight, a)[0].reshape(-1).numpy() for a in range(3)])
    threads, rounds = _kernel_constants()
    for t, r in ((threads, rounds), (64, 3)):  # the kernel's tiles, and small ones: many tiles, a ragged last
        rows = _b13_rows(masks, t, r)
        np.testing.assert_array_equal(rows[masks], np.arange(int(masks.sum())))
        assert (rows[~masks] == -1).all()


def test_extract_tile_is_the_kernels():
    threads, rounds = _kernel_constants()
    assert threads % 32 == 0 and textract.EXTRACT_CHUNK == 32
    assert textract.EXTRACT_TILE == threads * rounds
    # each tile's three counts, then its chunks' (rounds * warps of them), three counts packed a chunk
    assert textract.extract_scratch_ints(256 ** 3) == 1024 * (3 + rounds * threads // 32)
    assert "extract.cu" in kernels.SOURCES and "extract_points" in kernels.launch_counts


def test_extract_points_wrapper_checks(fused):
    planes, tcfg, _ = fused
    vol = tfusion.VolumeState(*(torch.from_numpy(p) for p in planes))
    with pytest.raises(ValueError, match="capacity"):
        textract.extract_points(vol, tcfg, capacity=0)
    kernels.reset_launch_counts()
    textract.extract_points(vol, tcfg, capacity=10)
    assert kernels.launch_counts["extract_points"] == 0  # the plain version on CPU tensors: nothing launched
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        textract.extract_points(tfusion.VolumeState(vol.value.to("meta"), vol.grad, vol.weight), tcfg)
