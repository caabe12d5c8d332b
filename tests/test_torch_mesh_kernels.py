"""B17, the meshers' kernels (``csrc/mesh.cu``), on the CPU, where they cannot
run: a numpy twin of their tiles, counts, scan and ballot ranks, and of
their vertex arithmetic, gives the plain versions' buffers exactly.

- The twin (:func:`_b17_rows`, :func:`_b17_mesh`) takes B17's triangle
  table (``ops/extract.py::mesh_table``) and reproduces
  ``extract_mesh_plain`` and ``extract_mesh_mc_plain`` bit for bit (count,
  every vertex, the zero rows past the count; tolerance 0) on
  ``tests/test_torch_extract.py``'s 32^3 cut, on a ragged 29x31x30 crop of
  it, and at a capacity below the count, with the kernel's tiles and with
  small ones (many tiles, a ragged last; marching cubes also with another
  slab).
- The table is the plain versions' tables rewritten, the kernel's tile
  constants and tetrahedra are the module's, the scratch size is the
  kernel's layout, and the wrappers launch nothing on CPU tensors.
"""

import re

import numpy as np
import pytest
import torch

from tests.test_torch_extract import _mesh_volume, fused  # noqa: F401  (the fused volume fixture)
from xslam_tpu_torch.ops import extract as textract
from xslam_tpu_torch.ops import fusion as tfusion
from xslam_tpu_torch.ops import kernels

NO_TRIANGLE = 0xFF


def _kernel_constants():
    src = (kernels.CSRC_DIR / "mesh.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
                 for name in ("MESH_THREADS", "MESH_ROUNDS"))


def _corners(plane: np.ndarray) -> np.ndarray:
    """(cells, 8): each cell's corner c at (c & 1, c >> 1 & 1, c >> 2 & 1), cells in C order."""
    X, Y, Z = plane.shape
    return np.stack([plane[(c & 1):X - 1 + (c & 1), (c >> 1 & 1):Y - 1 + (c >> 1 & 1),
                           (c >> 2 & 1):Z - 1 + (c >> 2 & 1)] for c in range(8)], -1).reshape(-1, 8)


def _codes(F: np.ndarray, mc: bool) -> np.ndarray:
    """(cells, slots): each slot's inside-code, as mesh.cu's slot_code."""
    inside = (F < 0).astype(np.int64)
    if mc:
        code = (inside << np.arange(8)).sum(1)
        return np.repeat(code[:, None], textract._MC_TABLE.shape[1], 1)
    tet = np.stack([(inside[:, ids] << np.arange(4)).sum(1) for ids in textract._TETS], 1)
    return np.repeat(tet, 2, 1)


def _b17_rows(present: np.ndarray, shape, slab: int, threads: int, rounds: int):
    """The row mesh.cu gives each (cell, slot) of ``present`` ((cells, slots)
    bool), -1 elsewhere, and the total: per group (an X-slab of ``slab``
    cells) its tiles of ``threads * rounds`` cells, each tile's count of each
    slot, the exclusive scan of the counts laid out (group, slot, tile), and
    in a tile the cells of earlier rounds, of earlier warps of the round, then
    the lanes below in the warp's ballot."""
    X, Y, Z = shape
    ny, nz = Y - 1, Z - 1
    tile = threads * rounds
    slots = present.shape[1]
    groups = -(-(X - 1) // slab)
    tiles = -(-(min(slab, X - 1) * ny * nz) // tile)
    per_group = []
    for g in range(groups):
        part = present[g * slab * ny * nz: min((g + 1) * slab, X - 1) * ny * nz]
        padded = np.zeros((slots, tiles * tile), bool)
        padded[:, :len(part)] = part.T
        per_group.append(padded.reshape(slots, tiles, rounds * threads // 32, 32))
    counts = np.stack([p.sum((2, 3)) for p in per_group])  # (groups, slots, tiles)
    tile_rows = (np.cumsum(counts.reshape(-1)) - counts.reshape(-1)).reshape(counts.shape)
    rows = np.full(present.shape, -1)
    for g, lanes in enumerate(per_group):
        chunk = lanes.sum(-1)  # (slots, tiles, chunks): a chunk is warp w of round r, chunk r * warps + w
        ahead = (np.cumsum(chunk, 2) - chunk)[..., None] + np.cumsum(lanes, 3) - lanes
        row = tile_rows[g][:, :, None, None] + ahead
        n = min((g + 1) * slab, X - 1) * ny * nz - g * slab * ny * nz
        rows[g * slab * ny * nz: g * slab * ny * nz + n] = np.where(lanes, row, -1).reshape(slots, -1)[:, :n].T
    return rows, int(counts.sum())


def _b17_mesh(value, weight, vs, mc: bool, capacity: int, slab: int, threads: int, rounds: int):
    """mesh.cu's buffer and count: each present (cell, slot) written at its
    row below the capacity with mesh.cu's vertex arithmetic in float32."""
    table = textract.mesh_table(mc)
    X, Y, Z = value.shape
    F, W = _corners(value), _corners(weight)
    observed = np.all((W > 0) & (np.abs(F) < 1.0), axis=1)
    codes = _codes(F, mc)
    entries = table[np.arange(table.shape[0])[None, :], codes]  # (cells, slots, 3)
    present = observed[:, None] & (entries[..., 0] != NO_TRIANGLE)
    rows, total = _b17_rows(present, (X, Y, Z), slab if mc else X - 1, threads, rounds)
    out = np.zeros((capacity, 3, 3), np.float32)
    cell, slot = np.nonzero(present & (rows < capacity))
    ny, nz = Y - 1, Z - 1
    ijk = np.stack([cell // (ny * nz), cell // nz % ny, cell % nz], 1)
    vs = np.float32(vs)
    for v in range(3):
        e = entries[cell, slot, v].astype(np.int64)
        a, b = e & 15, e >> 4
        fi, fj = F[cell, a], F[cell, b]
        d = fi - fj
        frac = np.minimum(np.maximum(fi / np.where(d == 0, np.float32(1), d), np.float32(0)), np.float32(1))
        keep = np.float32(1) - frac
        for ax in range(3):
            pa = ((ijk[:, ax] + (a >> ax & 1)).astype(np.float32) + np.float32(0.5)) * vs
            pb = ((ijk[:, ax] + (b >> ax & 1)).astype(np.float32) + np.float32(0.5)) * vs
            out[rows[cell, slot], v, ax] = pa * keep + pb * frac
    return out, min(total, capacity)


def _volumes(fused):  # noqa: F811
    cut, tcfg, _ = _mesh_volume(fused)
    ragged = tuple(np.ascontiguousarray(p[1:30, :31, 2:32]) for p in cut)
    return {"cut 32^3": cut, "crop 29x31x30": ragged}, tcfg


@pytest.mark.parametrize("tiles", ["kernel", "small"])
@pytest.mark.parametrize("capacity", [60_000, 700], ids=["full", "below_count"])
@pytest.mark.parametrize("mesher", ["tetra", "mc", "mc slab 5"])
def test_b17_twin_is_the_plain_version(fused, mesher, capacity, tiles):  # noqa: F811
    volumes, tcfg = _volumes(fused)
    threads, rounds = _kernel_constants() if tiles == "kernel" else (64, 3)
    mc, slab = mesher != "tetra", 5 if mesher == "mc slab 5" else 16
    for name, (value, _, weight) in volumes.items():
        vol = tfusion.VolumeState(*(torch.from_numpy(p) for p in (value, np.zeros_like(value), weight)))
        plain = (textract.extract_mesh_mc_plain(vol, tcfg, capacity, slab) if mc
                 else textract.extract_mesh_plain(vol, tcfg, capacity))
        out, count = _b17_mesh(value, weight, tcfg.voxel_size, mc, capacity, slab, threads, rounds)
        assert int(plain.count) == count, name
        assert count == capacity if capacity == 700 else 1_000 < count < capacity
        np.testing.assert_array_equal(out, plain.vertices.numpy(), err_msg=name)


def test_b17_table_is_the_plain_tables():
    """Each slot's entry names the plain versions' triangle edges as cube-corner
    pairs; the tetrahedra of mesh.cu are ops/extract.py's."""
    tet, mc = textract.mesh_table(False), textract.mesh_table(True)
    assert tet.shape == (12, 16, 3) and mc.shape == (10, 256, 3) and tet.dtype == mc.dtype == np.uint8
    for case in range(256):
        n = int((textract._MC_TABLE[case, :, 0] >= 0).sum())
        assert (mc[:n, case] != NO_TRIANGLE).all() and (mc[n:, case] == NO_TRIANGLE).all()
        for t in range(n):
            pairs = textract._MC_EDGES[textract._MC_TABLE[case, t]]
            np.testing.assert_array_equal(mc[t, case] & 15, pairs[:, 0])
            np.testing.assert_array_equal(mc[t, case] >> 4, pairs[:, 1])
    for code in range(16):
        for k in range(2):
            present = tet[k::2, code, 0] != NO_TRIANGLE
            assert (present == (textract._TET_NTRIS[code] > k)).all()
    src = (kernels.CSRC_DIR / "mesh.cu").read_text()
    tets = re.search(r"TETS\[6\]\[4\] = \{(.*?)\};", src).group(1)
    assert [[int(c) for c in re.findall(r"\d", t)] for t in re.findall(r"\{([^{}]*)\}", tets)] == \
        textract._TETS.tolist()


def test_b17_tile_and_scratch_are_the_kernels():
    threads, rounds = _kernel_constants()
    assert threads % 32 == 0 and textract.MESH_TILE == threads * rounds and textract.MESH_ROUNDS == rounds
    # 256^3: tetrahedra one group of 1013 tiles, 12 slots; marching cubes 16 slabs of 64 tiles, 10 slots
    assert textract.mesh_scratch_ints((256,) * 3, 12, 255) == 1013 * (2 * 12 + rounds)
    assert textract.mesh_scratch_ints((256,) * 3, 10, 16) == 16 * 64 * (2 * 10 + rounds)
    assert "mesh.cu" in kernels.SOURCES and {"mesh_tetra", "mesh_mc"} <= set(kernels.launch_counts)


def test_meshers_launch_nothing_on_the_cpu(fused):  # noqa: F811
    cut, tcfg, _ = _mesh_volume(fused)
    vol = tfusion.VolumeState(*(torch.from_numpy(p) for p in cut))
    kernels.reset_launch_counts()
    for mesher, plain in ((textract.extract_mesh, textract.extract_mesh_plain),
                          (textract.extract_mesh_mc, textract.extract_mesh_mc_plain)):
        got, want = mesher(vol, tcfg, 5_000), plain(vol, tcfg, 5_000)
        assert int(got.count) == int(want.count) and torch.equal(got.vertices, want.vertices)
    assert kernels.launch_counts["mesh_tetra"] == kernels.launch_counts["mesh_mc"] == 0
    with pytest.raises(ValueError, match="capacity"):
        textract.extract_mesh(vol, tcfg, capacity=0)
    with pytest.raises(ValueError, match="slab"):
        textract.extract_mesh_mc(vol, tcfg, slab=0)
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        textract.extract_mesh_mc(tfusion.VolumeState(vol.value.to("meta"), vol.grad, vol.weight), tcfg)
