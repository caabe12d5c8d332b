// B17: isosurface meshes of the TSDF volume, marching tetrahedra (B17t) and 256-case marching cubes (B17m).
//
// xs_extract_mesh replaces the XLA code of xslam_tpu/ops/extract.py::extract_mesh (mc 0: the 6 Kuhn tetrahedra of
//   each cell, at most 2 triangles each) and ::extract_mesh_mc (mc 1: the derived 256-case table, at most 10
//   triangles a cell) on the dense (X, Y, Z) value and weight planes. A cell is the cube of 8 voxels at (i, j, k)
//   .. (i + 1, j + 1, k + 1); it is observed where all 8 have W > 0 and |F| < 1, and only observed cells give
//   triangles. A triangle's vertices are the linear crossings on three of the cell's edges (corners a, b):
//   frac = clamp(F_a / (F_a - F_b, or 1 where that is 0), 0, 1), p = p_a * (1 - frac) + p_b * frac per axis, with
//   p_c = ((float)(i + dx_c) + 0.5f) * vs. Plain version: ops/extract.py::extract_mesh_plain and
//   ::extract_mesh_mc_plain, whose roundings these are (built with -fmad=false), so the bits are theirs.
//
//   The order is part of the result: the triangles come as (group, slot, cell), each list in C order of the
//   cells. Marching tetrahedra have one group (every cell) and 12 slots (tetrahedron t's first, then its second
//   triangle: slot 2t + k); marching cubes have a group an X-slab of `slab` cells and 10 slots (the table's rows).
//   The output is the first `capacity` triangles, zeros after them, and count = min(total, capacity). The slots'
//   triangles come from a table the wrapper makes from the plain version's (ops/extract.py::mesh_table): for each
//   slot and inside-code, the three vertices' edges as corner pairs (a | b << 4), or 0xFF where the slot has no
//   triangle; the blocks keep it in shared memory (576 B for tetrahedra, 7,680 B for cubes).
//
//   Three kernels in one launch call, with no atomic cursor (two launches give equal bits): mesh_count_kernel, a
//   block a tile of MESH_TILE cells of one group walked in rounds of MESH_THREADS, counts the tile's triangles of
//   each slot by warp ballots and marks the rounds whose warps hold any; mesh_scan_kernel, one block, turns the
//   counts, laid out (group, slot, tile), into each tile's first row of each slot by one exclusive scan and writes
//   the count; mesh_rows_kernel zeroes its share of the rows past the count, and where its tile holds triangles
//   walks again only the marked rounds: each cell's slots by a ballot ranked among the lanes below it, the warps
//   before it in the round and the rounds before it in the tile (lane s of each warp keeps slot s's next row, and
//   hands the warp its first row by a shuffle), and each triangle written at its row, its cell's corners read from
//   shared memory by the table's corner ids.
//
//   Bound: bytes. The two planes read once (8 B a voxel, 134 MB at 256^3) and the buffer written once (36 B a
//   row, 72 MB at run_slam's 2,000,000); a cell's tests are some 30 operations. This design reads each voxel's
//   eight cells' corners through L1 and L2 in the count kernel and again only in the marked rounds.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MESH_THREADS = 256;  // cells of one round of a block, a thread each
constexpr int MESH_ROUNDS = 64;    // rounds of a tile
constexpr int MESH_TILE = MESH_THREADS * MESH_ROUNDS;  // ops/extract.py::MESH_TILE
constexpr int WARPS = MESH_THREADS / 32;
constexpr int SCAN_THREADS = 1024;
constexpr uint8_t NO_TRIANGLE = 0xFF;

// ops/extract.py::_TETS: the Kuhn tetrahedra's cube corners (corner c is at (c & 1, c >> 1 & 1, c >> 2 & 1))
__constant__ int TETS[6][4] = {{0, 1, 3, 7}, {0, 1, 5, 7}, {0, 2, 3, 7}, {0, 2, 6, 7}, {0, 4, 5, 7}, {0, 4, 6, 7}};

template <bool MC>
struct Mode;
template <>
struct Mode<false> {  // marching tetrahedra: a code a tetrahedron (its 4 corners' signs)
  static constexpr int SLOTS = 12, CODES = 16;
};
template <>
struct Mode<true> {  // marching cubes: one code a cell (its 8 corners' signs)
  static constexpr int SLOTS = 10, CODES = 256;
};

struct MeshGrid {
  int X, Y, Z;     // voxels
  int ny, nz;      // cells along y and z (nx = X - 1)
  int slab;        // cells along x of a group
  int tiles;       // tiles of a group
  int capacity;    // rows of the buffer
  float vs;
};

// the cells of group grp
__device__ __forceinline__ int group_cells(const MeshGrid& g, int grp) {
  return min(g.slab, g.X - 1 - grp * g.slab) * g.ny * g.nz;
}

// a thread's cell, round after round: (i, j, k), stepped by MESH_THREADS cells a round without a division
struct Walk {
  int i, j, k;
};

__device__ __forceinline__ Walk walk_from(const MeshGrid& g, int c) {
  return {c / (g.ny * g.nz), (c / g.nz) % g.ny, c % g.nz};
}

__device__ __forceinline__ void walk_on(const MeshGrid& g, Walk& w) {
  w.k += MESH_THREADS;
  while (w.k >= g.nz) {
    w.k -= g.nz;
    if (++w.j == g.ny) {
      w.j = 0;
      ++w.i;
    }
  }
}

// the cell's 8 corner values; whether all 8 are observed
__device__ __forceinline__ bool load_cell(const float* __restrict__ value, const float* __restrict__ weight,
                                          const MeshGrid& g, const Walk& w, float F[8]) {
  const int v = (w.i * g.Y + w.j) * g.Z + w.k;
  bool observed = true;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int at = v + (c & 1) * g.Y * g.Z + (c >> 1 & 1) * g.Z + (c >> 2 & 1);
    F[c] = __ldg(value + at);
    observed = observed && __ldg(weight + at) > 0.0f && fabsf(F[c]) < 1.0f;
  }
  return observed;
}

// slot s's inside-code of the cell: the signs of its tetrahedron's corners, or of all 8 corners
template <bool MC>
__device__ __forceinline__ int slot_code(const float F[8], int s) {
  int code = 0;
  if (MC) {
#pragma unroll
    for (int c = 0; c < 8; ++c) code |= (F[c] < 0.0f) << c;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) code |= (F[TETS[s >> 1][q]] < 0.0f) << q;
  }
  return code;
}

// the cell's slots that hold a triangle, a bit each
template <bool MC>
__device__ __forceinline__ unsigned cell_slots(const float F[8], const uint8_t* tbl) {
  using M = Mode<MC>;
  unsigned m = 0;
#pragma unroll
  for (int s = 0; s < M::SLOTS; ++s)
    m |= (unsigned)(tbl[(s * M::CODES + slot_code<MC>(F, s)) * 3] != NO_TRIANGLE) << s;
  return m;
}

template <bool MC>
__device__ __forceinline__ void load_table(const uint8_t* __restrict__ table, uint8_t* tbl) {
  using M = Mode<MC>;
  for (int i = threadIdx.x; i < M::SLOTS * M::CODES * 3; i += MESH_THREADS) tbl[i] = table[i];
}

// scratch: tile_counts[(grp * SLOTS + s) * tiles + t], the triangles of slot s in tile t of group grp; then
// tile_rows, the same layout, each one's first row; then round_bits[block * MESH_ROUNDS + r], the warps of round r
// that hold a triangle
template <bool MC>
__global__ void __launch_bounds__(MESH_THREADS)
    mesh_count_kernel(const float* __restrict__ value, const float* __restrict__ weight,
                      const uint8_t* __restrict__ table, int* __restrict__ tile_counts,
                      unsigned* __restrict__ round_bits, MeshGrid g) {
  using M = Mode<MC>;
  __shared__ uint8_t tbl[M::SLOTS * M::CODES * 3];
  __shared__ int warp_counts[M::SLOTS][WARPS];
  __shared__ unsigned rbits[MESH_ROUNDS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_table<MC>(table, tbl);
  if (threadIdx.x < MESH_ROUNDS) rbits[threadIdx.x] = 0;
  __syncthreads();
  const int grp = blockIdx.x / g.tiles, tile = blockIdx.x % g.tiles;
  const int cells = group_cells(g, grp), first = tile * MESH_TILE;
  int counts[M::SLOTS];
#pragma unroll
  for (int s = 0; s < M::SLOTS; ++s) counts[s] = 0;
  Walk w = walk_from(g, grp * g.slab * g.ny * g.nz + first + threadIdx.x);
  for (int r = 0; r < MESH_ROUNDS && first + r * MESH_THREADS < cells; ++r) {
    unsigned m = 0;
    if (first + r * MESH_THREADS + (int)threadIdx.x < cells) {
      float F[8];
      if (load_cell(value, weight, g, w, F)) m = cell_slots<MC>(F, tbl);
    }
#pragma unroll
    for (int s = 0; s < M::SLOTS; ++s) counts[s] += __popc(__ballot_sync(0xffffffffu, m >> s & 1u));
    if (__any_sync(0xffffffffu, m != 0) && lane == 0) atomicOr(&rbits[r], 1u << warp);
    walk_on(g, w);
  }
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < M::SLOTS; ++s) warp_counts[s][warp] = counts[s];
  }
  __syncthreads();
  if (threadIdx.x < M::SLOTS) {
    int sum = 0;
    for (int i = 0; i < WARPS; ++i) sum += warp_counts[threadIdx.x][i];
    tile_counts[(grp * M::SLOTS + threadIdx.x) * g.tiles + tile] = sum;
  }
  if (threadIdx.x < MESH_ROUNDS) round_bits[blockIdx.x * MESH_ROUNDS + threadIdx.x] = rbits[threadIdx.x];
}

// one block: tile_rows, the exclusive scan of tile_counts in memory order ((group, slot, tile): the triangles'
// order), and the count
__global__ void __launch_bounds__(SCAN_THREADS)
    mesh_scan_kernel(const int* __restrict__ tile_counts, int* __restrict__ tile_rows, int n,
                     int* __restrict__ count_out, int capacity) {
  __shared__ int warp_sums[SCAN_THREADS / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = (n + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int mine = 0;
  for (int i = lo; i < hi; ++i) mine += tile_counts[i];
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    incl += lane >= o ? y : 0;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int ahead = 0, total = 0;
  for (int i = 0; i < SCAN_THREADS / 32; ++i) {
    ahead += i < warp ? warp_sums[i] : 0;
    total += warp_sums[i];
  }
  ahead += incl - mine;
  for (int i = lo; i < hi; ++i) {
    tile_rows[i] = ahead;
    ahead += tile_counts[i];
  }
  if (threadIdx.x == 0) *count_out = min(total, capacity);
}

template <bool MC>
__global__ void __launch_bounds__(MESH_THREADS)
    mesh_rows_kernel(const float* __restrict__ value, const float* __restrict__ weight,
                     const uint8_t* __restrict__ table, const int* __restrict__ tile_counts,
                     const int* __restrict__ tile_rows, const unsigned* __restrict__ round_bits,
                     const int* __restrict__ count, float* __restrict__ vertices, MeshGrid g) {
  using M = Mode<MC>;
  static_assert(M::SLOTS <= 32, "a lane holds a slot's next row");
  __shared__ uint8_t tbl[M::SLOTS * M::CODES * 3];
  __shared__ int warp_counts[2][M::SLOTS][WARPS];  // by round parity: a round's counts are read while the next's
                                                   // are written
  __shared__ float corners[8][MESH_THREADS];       // each thread's cell, indexed by the table's corner ids
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_table<MC>(table, tbl);

  // the rows past the count: zeros, a grid-strided share a block
  const long long end = (long long)g.capacity * 9;
  for (long long i = (long long)*count * 9 + (long long)blockIdx.x * MESH_THREADS + threadIdx.x; i < end;
       i += (long long)gridDim.x * MESH_THREADS)
    vertices[i] = 0.0f;

  const int grp = blockIdx.x / g.tiles, tile = blockIdx.x % g.tiles;
  const int cells = group_cells(g, grp), first = tile * MESH_TILE;
  // lane s < SLOTS holds slot s's next row in the tile (the same in every warp)
  int any = 0, row = 0;
  for (int s = 0; s < M::SLOTS; ++s) any |= tile_counts[(grp * M::SLOTS + s) * g.tiles + tile];
  if (lane < M::SLOTS) row = tile_rows[(grp * M::SLOTS + lane) * g.tiles + tile];
  __syncthreads();  // the table
  if (any == 0) return;  // a tile without triangles writes no row (most of a volume: the surface is thin)

  const unsigned below = (1u << lane) - 1u;
  int parity = 0;
  for (int r = 0; r < MESH_ROUNDS; ++r) {
    const unsigned bits = round_bits[blockIdx.x * MESH_ROUNDS + r];
    if (bits == 0) continue;  // the same for every thread of the block
    const int rel = first + r * MESH_THREADS + threadIdx.x;
    unsigned m = 0;
    Walk w{0, 0, 0};
    if ((bits >> warp & 1u) && rel < cells) {
      w = walk_from(g, grp * g.slab * g.ny * g.nz + rel);
      float F[8];
      if (load_cell(value, weight, g, w, F)) {
        m = cell_slots<MC>(F, tbl);
#pragma unroll
        for (int c = 0; c < 8; ++c) corners[c][threadIdx.x] = F[c];
      }
    }
    // lane s: the warp's triangles of slot s
    int mine = 0;
#pragma unroll
    for (int s = 0; s < M::SLOTS; ++s) {
      const int n = __popc(__ballot_sync(0xffffffffu, m >> s & 1u));
      mine = lane == s ? n : mine;
    }
    if (lane < M::SLOTS) warp_counts[parity][lane][warp] = mine;
    __syncthreads();
    // lane s: the warp's first row of slot s in this round, and the slot's next row after the round
    int first_row = 0;
    if (lane < M::SLOTS) {
      int ahead = 0, total = 0;
      for (int i = 0; i < WARPS; ++i) {
        const int c = warp_counts[parity][lane][i];
        ahead += i < warp ? c : 0;
        total += c;
      }
      first_row = row + ahead;
      row += total;
    }
    parity ^= 1;
    if (__ballot_sync(0xffffffffu, m != 0) == 0) continue;  // the warp holds no triangle this round
    const int ijk[3] = {w.i, w.j, w.k};
    for (int s = 0; s < M::SLOTS; ++s) {
      const unsigned ballot = __ballot_sync(0xffffffffu, m >> s & 1u);
      const int at = __shfl_sync(0xffffffffu, first_row, s) + __popc(ballot & below);
      if (!(m >> s & 1u) || at >= g.capacity) continue;
      int code = 0;
      if (MC) {
#pragma unroll
        for (int c = 0; c < 8; ++c) code |= (corners[c][threadIdx.x] < 0.0f) << c;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) code |= (corners[TETS[s >> 1][q]][threadIdx.x] < 0.0f) << q;
      }
      const uint8_t* e = &tbl[(s * M::CODES + code) * 3];
      float* out = vertices + (long long)at * 9;
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const int a = e[v] & 15, b = e[v] >> 4;
        const float fi = corners[a][threadIdx.x], d = fi - corners[b][threadIdx.x];
        const float frac = fminf(fmaxf(fi / (d == 0.0f ? 1.0f : d), 0.0f), 1.0f);
        const float keep = 1.0f - frac;
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          const float pa = ((float)(ijk[ax] + (a >> ax & 1)) + 0.5f) * g.vs;
          const float pb = ((float)(ijk[ax] + (b >> ax & 1)) + 0.5f) * g.vs;
          out[v * 3 + ax] = pa * keep + pb * frac;
        }
      }
    }
  }
}

template <bool MC>
int launch_mesh(const float* value, const float* weight, const uint8_t* table, int* scratch,
                long long scratch_ints, float* vertices, int* count, int X, int Y, int Z, int capacity, int slab,
                float vs, cudaStream_t s) {
  using M = Mode<MC>;
  if (X < 2 || Y < 2 || Z < 2 || capacity < 1 || slab < 1) return (int)cudaErrorInvalidValue;
  const long long cells = (long long)(X - 1) * (Y - 1) * (Z - 1);
  if ((long long)X * Y * Z >= (1ll << 31) || cells * M::SLOTS >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const int groups = (X - 1 + slab - 1) / slab;
  const long long group_cells = (long long)min(slab, X - 1) * (Y - 1) * (Z - 1);
  const int tiles = (int)((group_cells + MESH_TILE - 1) / MESH_TILE);
  const long long blocks = (long long)groups * tiles;
  if (scratch_ints != blocks * (2 * M::SLOTS + MESH_ROUNDS)) return (int)cudaErrorInvalidValue;
  const MeshGrid g{X, Y, Z, Y - 1, Z - 1, slab, tiles, capacity, vs};
  int* tile_counts = scratch;
  int* tile_rows = tile_counts + blocks * M::SLOTS;
  unsigned* round_bits = (unsigned*)(tile_rows + blocks * M::SLOTS);
  mesh_count_kernel<MC><<<(unsigned)blocks, MESH_THREADS, 0, s>>>(value, weight, table, tile_counts, round_bits, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mesh_scan_kernel<<<1, SCAN_THREADS, 0, s>>>(tile_counts, tile_rows, (int)(blocks * M::SLOTS), count, capacity);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mesh_rows_kernel<MC><<<(unsigned)blocks, MESH_THREADS, 0, s>>>(value, weight, table, tile_counts, tile_rows,
                                                                 round_bits, count, vertices, g);
  return (int)cudaGetLastError();
}

}  // namespace

// value, weight: the (X, Y, Z) planes; table: (SLOTS, CODES, 3) uint8 (ops/extract.py::mesh_table); scratch:
// ops/extract.py::mesh_scratch_ints int32; vertices: (capacity, 3, 3) float32 out; count: one int32 out. mc 0:
// marching tetrahedra over one group (slab is X - 1); mc 1: marching cubes over X-slabs of `slab` cells
extern "C" int xs_extract_mesh(const void* value, const void* weight, const void* table, void* scratch,
                               long long scratch_ints, void* vertices, void* count, int X, int Y, int Z,
                               int capacity, int mc, int slab, float vs, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (mc)
    return launch_mesh<true>((const float*)value, (const float*)weight, (const uint8_t*)table, (int*)scratch,
                             scratch_ints, (float*)vertices, (int*)count, X, Y, Z, capacity, slab, vs, s);
  return launch_mesh<false>((const float*)value, (const float*)weight, (const uint8_t*)table, (int*)scratch,
                            scratch_ints, (float*)vertices, (int*)count, X, Y, Z, capacity, slab, vs, s);
}
