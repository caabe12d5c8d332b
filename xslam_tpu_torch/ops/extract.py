"""Surface extraction from the TSDF volume: points, normals, mesh.

Port of ``xslam_tpu/ops/extract.py`` (reference ``ExtractPointCloud.cu``).

Points: kernel B13, :func:`extract_points` (``csrc/extract.cu``), the
zero crossings along each +axis edge with trilinear central-difference
normals, compacted into a fixed-capacity buffer in the JAX function's order
(axis-major, then C order) with no atomic cursor. Its plain version is
:func:`extract_points_plain`. The wrapper runs the plain version on CPU
tensors and launches the kernel on CUDA tensors; any other device raises.

Meshes: kernels B17t, :func:`extract_mesh` (marching tetrahedra), and
B17m, :func:`extract_mesh_mc` (256-case marching cubes, its table derived at
import), both in ``csrc/mesh.cu``: the triangles in the JAX functions' order,
compacted as B13 compacts its points. Their plain versions,
:func:`extract_mesh_plain` and :func:`extract_mesh_mc_plain`, sweep the cells
in X-slabs, so their per-cell tensors stay O(slab * Y * Z): at 256^3 the
unslabbed ones are several GB. The wrappers run the plain versions on CPU
tensors and launch the kernels on CUDA tensors; any other device raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..csfd.single import lift
from . import kernels
from .fusion import VolumeConfig, VolumeState
from .raycast import trilinear_tsdf_shard

EXTRACT_TILE = 16384  # voxels a block of B13 counts and compacts (csrc/extract.cu::EXTRACT_TILE)
EXTRACT_CHUNK = 32  # voxels of one of B13's chunks, a warp's (csrc/extract.cu)
MESH_TILE = 16384  # cells a block of B17 counts and compacts (csrc/mesh.cu::MESH_TILE)
MESH_ROUNDS = 64  # rounds of MESH_TILE / MESH_ROUNDS cells in one of B17's tiles (csrc/mesh.cu::MESH_ROUNDS)


def extract_scratch_ints(n_voxels: int) -> int:
    """B13's scratch, int32: each tile's count for each axis, then each of its
    chunks' three counts packed in one int."""
    n_tiles = -(-n_voxels // EXTRACT_TILE)
    return n_tiles * (3 + EXTRACT_TILE // EXTRACT_CHUNK)


class PointCloud(NamedTuple):
    points: torch.Tensor  # (capacity, 3) f32, valid entries first
    normals: torch.Tensor  # (capacity, 3) f32
    count: torch.Tensor  # int32 scalar


def _edge_crossings(value: torch.Tensor, weight: torch.Tensor, axis: int):
    """Zero-crossing detection + linear interpolation along one +axis edge.

    Mirrors extractKernel's per-axis checks: both voxels must be observed
    (weight > 0) and non-saturated, with a strict sign change."""
    F0, W0 = value, weight
    F1 = torch.roll(value, -1, axis)
    W1 = torch.roll(weight, -1, axis)
    # exclude wrap-around at the far face
    n = value.shape[axis]
    last = (torch.arange(n, device=value.device) == n - 1).reshape([-1 if a == axis else 1 for a in range(3)])
    observed = (W0 > 0) & (W1 > 0) & (F0.abs() < 1.0) & (F1.abs() < 1.0)
    crossing = observed & ~last & (torch.sign(F0) != torch.sign(F1)) & (F0 != 0)
    d = F0 - F1
    frac = torch.clamp(F0 / torch.where(d == 0.0, 1.0, d), 0.0, 1.0)
    return crossing, frac


def _point_normals(vol: VolumeState, points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Central differences of the trilinear TSDF at +- half a voxel along each
    axis (extractNormalsKernel, ExtractPointCloud.cu:213-362), normalised."""
    half = 0.5 * voxel_size

    def tsdf_at(axis, sign):
        q = [points[:, 0], points[:, 1], points[:, 2]]
        q[axis] = q[axis] + sign * half
        return trilinear_tsdf_shard(vol.value, vol.grad, lift(q[0]), lift(q[1]), lift(q[2]), voxel_size).v

    n = [tsdf_at(a, 1) - tsdf_at(a, -1) for a in range(3)]
    norm = torch.sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])[:, None]
    normals = torch.where(norm > 0, torch.stack(n, -1) / torch.clamp(norm, min=1e-20), 0.0)
    return torch.nan_to_num(normals)


def extract_points_plain(vol: VolumeState, cfg: VolumeConfig, capacity: int = 500_000) -> PointCloud:
    """Plain version of B13: the port of ``xslam_tpu/ops/extract.py::extract_points``
    (``x_offset`` 0: the port has no sharded engine). The compaction takes
    the crossings' flat positions in order and keeps the first ``capacity``."""
    X, Y, Z = vol.value.shape
    vs = cfg.voxel_size
    dev = vol.value.device
    crossings, fracs = zip(*(_edge_crossings(vol.value, vol.weight, axis) for axis in range(3)))
    at = torch.nonzero(torch.cat([c.reshape(-1) for c in crossings])).squeeze(1)[:capacity]
    count = at.numel()
    axis, voxel = at // (X * Y * Z), at % (X * Y * Z)
    ijk = (voxel // (Y * Z), (voxel // Z) % Y, voxel % Z)
    frac = torch.cat([f.reshape(-1) for f in fracs])[at]
    points = torch.zeros((capacity, 3), dtype=torch.float32, device=dev)
    for a in range(3):
        points[:count, a] = (ijk[a].to(torch.float32) + 0.5 + torch.where(axis == a, frac, 0.0)) * vs
    normals = _point_normals(vol, points, vs)
    return PointCloud(points=points, normals=normals, count=torch.tensor(count, dtype=torch.int32, device=dev))


def extract_points(vol: VolumeState, cfg: VolumeConfig, capacity: int = 500_000) -> PointCloud:
    """Zero-crossing surface points with trilinear central-difference normals
    (``extractPoints`` + ``extractNormals``, ExtractPointCloud.cu:188-362).

    Returns a fixed-capacity buffer (the reference likewise caps output via a
    user buffer, DEFAULT_CLOUD_BUFFER_SIZE, Internal.h:40) with ``count``
    valid leading entries and zeros after them. Points are in volume metric
    coordinates. On CUDA tensors one launch of B13 (its three kernels)."""
    if capacity < 1:
        raise ValueError(f"capacity: expected at least 1, got {capacity}")
    if kernels.on_cpu(vol.value, vol.weight):
        return extract_points_plain(vol, cfg, capacity)
    if vol.value.dim() != 3:
        raise ValueError(f"value: expected (X, Y, Z), got {tuple(vol.value.shape)}")
    X, Y, Z = vol.value.shape
    kernels.check_tensor(vol.value, "value", torch.float32)
    kernels.check_tensor(vol.weight, "weight", torch.float32, (X, Y, Z))
    if 3 * X * Y * Z >= 1 << 31:
        raise ValueError(f"B13 indexes the edges of a volume with 32 bits, got {X * Y * Z} voxels")
    dev = vol.value.device
    points = torch.empty((capacity, 3), dtype=torch.float32, device=dev)
    normals = torch.empty_like(points)
    count = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(extract_scratch_ints(X * Y * Z), dtype=torch.int32, device=dev)
    vs = cfg.voxel_size
    kernels.launch("extract_points", dev, vol.value, vol.weight, scratch, points, normals, count,
                   kernels.f32(vs), kernels.reciprocal_f32(vs), kernels.f32(0.5 * vs))
    kernels.launch_counts["extract_points"] += 1
    return PointCloud(points=points, normals=normals, count=count)


# ---------------------------------------------------------------- mesh (MT)
# Kuhn triangulation: tets (0, a, a|b, 7) over the 6 monotone paths
# 0 -> axis -> axis-pair -> 7; they exactly tile the cube.
_TETS = np.array(
    [[0, 1, 3, 7], [0, 1, 5, 7], [0, 2, 3, 7], [0, 2, 6, 7], [0, 4, 5, 7], [0, 4, 6, 7]],
    np.int64,
)
# cube corner offsets indexed by corner id
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
    np.int64,
)
# tet edge order: 0:(0,1) 1:(0,2) 2:(0,3) 3:(1,2) 4:(1,3) 5:(2,3)
_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int64)


def _tet_tables():
    """Marching tetrahedra's triangle tables over the 16 inside-codes: the
    first and second triangle (tet edge ids), and the number of triangles."""
    E = {tuple(e): i for i, e in enumerate(_TET_EDGES.tolist())}
    cases = {
        1: [[(0, 1), (0, 2), (0, 3)]],
        2: [[(0, 1), (1, 3), (1, 2)]],
        3: [[(0, 2), (0, 3), (1, 3)], [(0, 2), (1, 3), (1, 2)]],
        4: [[(0, 2), (1, 2), (2, 3)]],
        5: [[(0, 1), (1, 2), (2, 3)], [(0, 1), (2, 3), (0, 3)]],
        6: [[(0, 1), (0, 2), (2, 3)], [(0, 1), (2, 3), (1, 3)]],
        7: [[(0, 3), (1, 3), (2, 3)]],
    }
    tri = np.zeros((2, 16, 3), np.int64)
    n_tris = np.zeros(16, np.int64)
    for lo, tris in cases.items():
        for code in (lo, 15 - lo):
            n_tris[code] = len(tris)
            for k, t in enumerate(tris):
                tri[k, code] = [E[e] for e in t]
    return tri, n_tris


_TET_TRI, _TET_NTRIS = _tet_tables()
TETRA_SLAB = 16  # X-slab of extract_mesh's cell sweep: its per-cell tensors stay O(TETRA_SLAB * Y * Z)


class Mesh(NamedTuple):
    vertices: torch.Tensor  # (capacity, 3, 3): triangle vertex positions
    count: torch.Tensor  # number of valid triangles (int32)


def _slab_cells(vol: VolumeState, x0: int, nx: int):
    """The cells of X-slab [x0, x0 + nx): their 8 corner values (cells, 8),
    whether all 8 corners are observed, and their base voxels (cells, 3)."""
    X, Y, Z = vol.value.shape

    def corner(plane, c):
        dx, dy, dz = (int(d) for d in _CORNERS[c])
        return plane[x0 + dx: x0 + nx + dx, dy: Y - 1 + dy, dz: Z - 1 + dz]

    F = torch.stack([corner(vol.value, c) for c in range(8)], -1).reshape(-1, 8)
    W = torch.stack([corner(vol.weight, c) for c in range(8)], -1).reshape(-1, 8)
    observed = torch.all((W > 0) & (F.abs() < 1.0), dim=-1)
    ny, nz = Y - 1, Z - 1
    cix = torch.arange(nx * ny * nz, device=F.device)
    base = torch.stack([x0 + cix // (ny * nz), (cix // nz) % ny, cix % nz], -1)
    return F, observed, base


def _edge_points(F, base, corners, edges, vs):
    """Linear zero-crossing points on the given corner-pair edges of each
    cell: (cells, edges, 3)."""
    corners_pos = ((base[:, None, :] + corners).to(torch.float32) + 0.5) * vs
    fi, fj = F[:, edges[:, 0]], F[:, edges[:, 1]]
    d = fi - fj
    frac = torch.clamp(fi / torch.where(d == 0.0, 1.0, d), 0.0, 1.0)[..., None]
    pi, pj = corners_pos[:, edges[:, 0]], corners_pos[:, edges[:, 1]]
    return pi * (1 - frac) + pj * frac


def _gather_triangles(e_pts: torch.Tensor, edge_idx: torch.Tensor) -> torch.Tensor:
    """(cells, 3, 3): each cell's triangle over its edge points."""
    return torch.take_along_dim(e_pts, edge_idx[..., None].expand(-1, -1, 3), dim=1)


def _compact(parts, capacity: int, device) -> Mesh:
    """The triangles of ``parts`` (in order) in a fixed-capacity buffer."""
    tris = torch.cat(parts) if parts else torch.zeros((0, 3, 3), dtype=torch.float32, device=device)
    count = min(tris.shape[0], capacity)
    buf = torch.zeros((capacity, 3, 3), dtype=torch.float32, device=device)
    buf[:count] = tris[:count]
    return Mesh(vertices=buf, count=torch.tensor(count, dtype=torch.int32, device=device))


def extract_mesh_plain(vol: VolumeState, cfg: VolumeConfig, capacity: int = 1_000_000) -> Mesh:
    """Plain version of B17t: isosurface triangles by marching tetrahedra
    over observed cells, in the JAX function's order: tet by tet, its first
    then its second triangle, each over the cells in C order. The cells are
    swept in X-slabs of :data:`TETRA_SLAB`; each (tet, triangle) keeps its
    slabs' triangles in order."""
    X, Y, Z = vol.value.shape
    vs = cfg.voxel_size
    dev = vol.value.device
    tri = torch.as_tensor(_TET_TRI, device=dev)
    n_tris = torch.as_tensor(_TET_NTRIS, device=dev)
    edges = torch.as_tensor(_TET_EDGES, device=dev)
    parts = [[] for _ in range(2 * len(_TETS))]
    for x0 in range(0, X - 1, TETRA_SLAB):
        F, observed, base = _slab_cells(vol, x0, min(TETRA_SLAB, X - 1 - x0))
        for t, ids in enumerate(_TETS):
            f = F[:, torch.as_tensor(ids, device=dev)]
            inside = (f < 0.0).to(torch.int64)
            code = inside[:, 0] + 2 * inside[:, 1] + 4 * inside[:, 2] + 8 * inside[:, 3]
            e_pts = _edge_points(f, base, torch.as_tensor(_CORNERS[ids], device=dev), edges, vs)
            for k in range(2):
                m = observed & (n_tris[code] >= k + 1)
                parts[2 * t + k].append(_gather_triangles(e_pts[m], tri[k][code[m]]))
    return _compact([p for pass_ in parts for p in pass_], capacity, dev)


# ------------------------------------------------------------- mesh (MC-256)
# Full 256-case marching cubes; the triangle table is DERIVED here as in the
# JAX package: for every 8-bit corner-sign case, each cube face contributes
# marching-squares segments between its crossing edges (the 4-crossing face
# saddle always isolates the cycle's odd corners, so two cells sharing a face
# agree and the mesh is watertight); the segments form loops over the 12 cube
# edges, fan-triangulated and oriented toward the outside (positive TSDF).

# 12 cube edges as corner-id pairs (x-, y-, z-aligned groups)
_MC_EDGES = np.array(
    [[0, 1], [2, 3], [4, 5], [6, 7], [0, 2], [1, 3], [4, 6], [5, 7], [0, 4], [1, 5], [2, 6], [3, 7]],
    np.int64,
)


def _build_mc_table():
    eid = {frozenset(map(int, e)): i for i, e in enumerate(_MC_EDGES)}
    faces = [(0, 2, 6, 4), (1, 3, 7, 5), (0, 1, 5, 4), (2, 3, 7, 6), (0, 1, 3, 2), (4, 5, 7, 6)]
    mids = 0.5 * (_CORNERS[_MC_EDGES[:, 0]] + _CORNERS[_MC_EDGES[:, 1]])
    table = []
    max_t = 0
    for case in range(256):
        inside = [(case >> c) & 1 for c in range(8)]
        segs = []
        for cyc in faces:
            pts = []
            for k in range(4):
                a, b = cyc[k], cyc[(k + 1) % 4]
                if inside[a] != inside[b]:
                    pts.append(eid[frozenset((a, b))])
            if len(pts) == 2:
                segs.append((pts[0], pts[1]))
            elif len(pts) == 4:
                # saddle: isolate cyc[1] and cyc[3] (consistent across the
                # two cells sharing this face — same cyclic order)
                segs.append((pts[0], pts[1]))
                segs.append((pts[2], pts[3]))
        # stitch degree-2 segments into closed loops over edge ids
        adj = {}
        for a, b in segs:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, []).append(a)
        seen = set()
        tris = []
        ci = [c for c in range(8) if inside[c]]
        co = [c for c in range(8) if not inside[c]]
        if ci and co:
            d_out = _CORNERS[co].mean(0) - _CORNERS[ci].mean(0)
            for start in list(adj):
                if start in seen:
                    continue
                loop = [start]
                seen.add(start)
                prev, cur = None, start
                while True:
                    nxt = [n for n in adj[cur] if n != prev]
                    # both neighbours unvisited at the start: pick either
                    step = nxt[0] if nxt[0] not in seen or nxt[0] != loop[0] or len(loop) < 3 else nxt[-1]
                    if step == loop[0] and len(loop) >= 3:
                        break
                    prev, cur = cur, step
                    loop.append(cur)
                    seen.add(cur)
                    if len(loop) > 12:
                        raise AssertionError(f"runaway loop in case {case}")
                for k in range(1, len(loop) - 1):
                    i, j, l = loop[0], loop[k], loop[k + 1]
                    n = np.cross(mids[j] - mids[i], mids[l] - mids[i])
                    tris.append([i, l, j] if float(n @ d_out) < 0 else [i, j, l])
        max_t = max(max_t, len(tris))
        table.append(tris)
    out = np.full((256, max_t, 3), -1, np.int64)
    for case, tris in enumerate(table):
        for t, tri in enumerate(tris):
            out[case, t] = tri
    return out


_MC_TABLE = _build_mc_table()  # (256, max_tris, 3) edge ids, -1 padded


def extract_mesh_mc_plain(vol: VolumeState, cfg: VolumeConfig, capacity: int = 1_000_000,
                          slab: int = 16) -> Mesh:
    """Plain version of B17m: isosurface triangles by full 256-case marching
    cubes over observed cells — same contract as :func:`extract_mesh`, in
    the JAX function's order: X-slab by X-slab of ``slab`` cells, then the
    case table's rows, then the slab's cells in C order."""
    X, Y, Z = vol.value.shape
    vs = cfg.voxel_size
    dev = vol.value.device
    table = torch.as_tensor(_MC_TABLE, device=dev)
    corners = torch.as_tensor(_CORNERS, device=dev)
    edges = torch.as_tensor(_MC_EDGES, device=dev)
    weights = torch.tensor([1 << c for c in range(8)], device=dev)
    parts = []
    for x0 in range(0, X - 1, slab):
        F, observed, base = _slab_cells(vol, x0, min(slab, X - 1 - x0))
        case = torch.sum((F < 0.0).to(torch.int64) * weights, dim=-1)
        e_pts = _edge_points(F, base, corners, edges, vs)
        for t in range(_MC_TABLE.shape[1]):
            edge_idx = table[case, t]
            m = observed & (edge_idx[:, 0] >= 0)
            parts.append(_gather_triangles(e_pts[m], edge_idx[m]))
    return _compact(parts, capacity, dev)


# ------------------------------------------------------------ B17 wrappers
def mesh_table(mc: bool) -> np.ndarray:
    """B17's triangle table, (slots, codes, 3) uint8: for each slot (B17t:
    tet ``s // 2``'s triangle ``s % 2``, over its 16 inside-codes; B17m: the
    MC table's row, over the 256 cases) and code, the three vertices' edges
    as cube-corner pairs ``a | b << 4``, or 0xFF where the slot has no
    triangle. The plain versions' tables, rewritten for ``csrc/mesh.cu``."""
    if mc:
        out = np.full((_MC_TABLE.shape[1], 256, 3), 0xFF, np.uint8)
        for case in range(256):
            for t in range(_MC_TABLE.shape[1]):
                if _MC_TABLE[case, t, 0] >= 0:
                    pairs = _MC_EDGES[_MC_TABLE[case, t]]
                    out[t, case] = pairs[:, 0] | pairs[:, 1] << 4
        return out
    out = np.full((2 * len(_TETS), 16, 3), 0xFF, np.uint8)
    for t, ids in enumerate(_TETS):
        for k in range(2):
            for code in range(16):
                if _TET_NTRIS[code] >= k + 1:
                    pairs = ids[_TET_EDGES[_TET_TRI[k, code]]]
                    out[2 * t + k, code] = pairs[:, 0] | pairs[:, 1] << 4
    return out


def mesh_scratch_ints(shape, slots: int, slab: int) -> int:
    """B17's scratch, int32, for a volume of ``shape`` swept in X-slabs of
    ``slab`` cells (B17t: one slab of every cell), a block a tile of a slab:
    each tile's count of each slot, then its first row of each slot, then
    its rounds' marks (the warps that hold a triangle)."""
    X, Y, Z = shape
    groups = -(-(X - 1) // slab)
    tiles = -(-(min(slab, X - 1) * (Y - 1) * (Z - 1)) // MESH_TILE)
    return groups * tiles * (2 * slots + MESH_ROUNDS)


_MESH_TABLES = {mc: mesh_table(mc) for mc in (False, True)}  # B17t's and B17m's tables, copied to the card a launch


def _launch_mesh(kernel: str, vol: VolumeState, cfg: VolumeConfig, capacity: int, slab: int) -> Mesh:
    """One launch of B17t (``mesh_tetra``) or B17m (``mesh_mc``) on the
    card."""
    if vol.value.dim() != 3:
        raise ValueError(f"value: expected (X, Y, Z), got {tuple(vol.value.shape)}")
    X, Y, Z = vol.value.shape
    kernels.check_tensor(vol.value, "value", torch.float32)
    kernels.check_tensor(vol.weight, "weight", torch.float32, (X, Y, Z))
    mc = kernel == "mesh_mc"
    slots = _MC_TABLE.shape[1] if mc else 2 * len(_TETS)
    if min(X, Y, Z) < 2:
        raise ValueError(f"B17 needs a cell: at least 2 voxels along each axis, got {(X, Y, Z)}")
    if X * Y * Z >= 1 << 31 or slots * (X - 1) * (Y - 1) * (Z - 1) >= 1 << 31:
        raise ValueError(f"B17 indexes the voxels and the (slot, cell) pairs with 32 bits, got {X * Y * Z} voxels")
    dev = vol.value.device
    table = torch.from_numpy(_MESH_TABLES[mc]).to(dev)
    vertices = torch.empty((capacity, 3, 3), dtype=torch.float32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(mesh_scratch_ints((X, Y, Z), slots, slab), dtype=torch.int32, device=dev)
    args = (vol.value, vol.weight, table, scratch, vertices, count) + ((slab,) if mc else ())
    kernels.launch(kernel, dev, *args, kernels.f32(cfg.voxel_size))
    kernels.launch_counts[kernel] += 1
    return Mesh(vertices=vertices, count=count)


def extract_mesh(vol: VolumeState, cfg: VolumeConfig, capacity: int = 1_000_000) -> Mesh:
    """Isosurface triangles by marching tetrahedra over observed cells
    (:func:`extract_mesh_plain`'s contract and order): a fixed-capacity
    ``(capacity, 3, 3)`` buffer with ``count`` valid leading triangles and
    zeros after them. On CUDA tensors one launch of B17t."""
    if capacity < 1:
        raise ValueError(f"capacity: expected at least 1, got {capacity}")
    if kernels.on_cpu(vol.value, vol.weight):
        return extract_mesh_plain(vol, cfg, capacity)
    return _launch_mesh("mesh_tetra", vol, cfg, capacity, vol.value.shape[0] - 1)


def extract_mesh_mc(vol: VolumeState, cfg: VolumeConfig, capacity: int = 1_000_000, slab: int = 16) -> Mesh:
    """Isosurface triangles by 256-case marching cubes over observed cells
    (:func:`extract_mesh_mc_plain`'s contract and order, X-slabs of ``slab``
    cells). On CUDA tensors one launch of B17m."""
    if capacity < 1:
        raise ValueError(f"capacity: expected at least 1, got {capacity}")
    if slab < 1:
        raise ValueError(f"slab: expected at least 1, got {slab}")
    if kernels.on_cpu(vol.value, vol.weight):
        return extract_mesh_mc_plain(vol, cfg, capacity, slab)
    return _launch_mesh("mesh_mc", vol, cfg, capacity, slab)
