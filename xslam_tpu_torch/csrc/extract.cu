// B13: zero-crossing point extraction with trilinear normals.
//
// xs_extract_points replaces the XLA code of xslam_tpu/ops/extract.py::
//   extract_points (with _edge_crossings; reference ExtractPointCloud.cu:
//   188-362, extractKernel + extractNormalsKernel) on the dense (X, Y, Z)
//   value and weight planes. For each axis a and each voxel in C order, the
//   +a edge crosses where both voxels are weighted and |F| < 1, the voxel is
//   not the last along a, sign(F0) != sign(F1) and F0 != 0; it is placed at
//   frac = clip(F0 / (F0 - F1, or 1 where that is 0), 0, 1) along the edge:
//   ((float)idx + 0.5f + frac) * vs on axis a, ((float)idx + 0.5f) * vs on the
//   others. Points come axis-major, then in C order, the first `capacity`
//   of them; count = min(total, capacity). Each point's normal is the
//   difference of the value lane of ops/raycast.py::trilinear_tsdf_shard at
//   +- half a voxel along each axis (the base cell shifted below the voxel
//   centre, readTsdf's +1e-5 on every tap, NaN out of bounds, the eight
//   products summed left to right), n / max(|n|, 1e-20) where |n| > 0, else
//   0, then torch.nan_to_num. Rows at or past the count are zero points
//   with zero normals (a zero point samples out of bounds, and its normal is
//   0). Plain version: ops/extract.py::extract_points_plain; every rounding
//   is its own (built with -fmad=false; the multiplications by 1 / vs take
//   the float32 reciprocal as PyTorch rounds a host scalar), so the bits are
//   the plain version's.
//
//   The order is fixed, with no atomic cursor (the reference's extractKernel
//   takes one, and its order changes from run to run): three kernels in one
//   launch call. extract_count_kernel, a block a tile of EXTRACT_TILE
//   voxels walked in rounds of EXTRACT_THREADS (a thread's voxel stepped
//   without a division; four rounds' loads in flight, no branch before a
//   load), counts each tile's crossings and, by warp ballots, each chunk's
//   (a warp's 32 voxels of a round), for the three axes at once (a chunk's
//   three counts packed in one int, one store a warp a round).
//   extract_points_kernel sums the counts of the tiles before its own (all
//   three axes' totals before the axis) into its three row offsets; where
//   its tile has crossings (the surface is thin: most tiles have none and
//   stop here), a scan of the tile's chunk counts (kept in shared memory)
//   gives each chunk its first row, and each warp reads again only its
//   chunks with crossings, ranks them by a ballot and writes each crossing's
//   point at its row: no barrier and no read of device memory between its
//   chunks. extract_normals_kernel, a thread a row, computes
//   the normal of each point before the count and zeroes the rows past it:
//   a normal's six trilinears are a chain of dependent loads, which held
//   every round of a block at its barrier while they ran inside the
//   rounds. Integer sums: the same rows however the blocks run. Block 0
//   writes the count; every block zeroes its share of the points past it.
//
//   Bound: bytes. The two planes read once (8 B a voxel, 134 MB at 256^3)
//   and the buffers written once (24 B a row); about 10 operations an edge
//   test and some 300 a point's normal. This design reads the planes once in
//   the count kernel (each voxel's three +a neighbours mostly from L1 and L2)
//   and again only in the chunks with crossings, and a point's 48 taps from
//   the value plane through the cache. (PERF.md records the designs
//   measured before it: every tile walked twice with three integer
//   divisions a voxel, a branch before each round's loads and the normals
//   inside the rounds.)

#include <cuda_runtime.h>

#include "dual.cuh"

namespace {

constexpr int EXTRACT_THREADS = 256;  // voxels of one round of a block, a thread each
constexpr int EXTRACT_ROUNDS = 64;    // rounds of a tile
constexpr int EXTRACT_TILE = EXTRACT_THREADS * EXTRACT_ROUNDS;  // ops/extract.py::EXTRACT_TILE
constexpr int WARPS = EXTRACT_THREADS / 32;
constexpr int CHUNKS = EXTRACT_ROUNDS * WARPS;  // chunks of a tile: a warp's 32 voxels of a round
static_assert(CHUNKS == 2 * EXTRACT_THREADS, "a thread takes two of its tile's chunks in the points kernel's scan");
constexpr float TAP_BIAS = 1e-5f;

struct Grid {
  int X, Y, Z;
};

__device__ __forceinline__ int sign_of(float f) { return (f > 0.0f) - (f < 0.0f); }

// _edge_crossings' test of one +axis edge (F0, W0 at the voxel, F1, W1 at its neighbour; `last`: the voxel is
// the last along the axis), and its frac where it crosses (the division only there)
__device__ __forceinline__ bool edge_crosses(float F0, float W0, float F1, float W1, bool last, float& frac) {
  const bool observed = W0 > 0.0f && W1 > 0.0f && fabsf(F0) < 1.0f && fabsf(F1) < 1.0f;
  const bool cross = observed && !last && sign_of(F0) != sign_of(F1) && F0 != 0.0f;
  if (cross) {
    const float d = F0 - F1;
    frac = fminf(fmaxf(F0 / (d == 0.0f ? 1.0f : d), 0.0f), 1.0f);
  }
  return cross;
}

// A thread's voxel, round after round: its flat index and (i, j, k), stepped by EXTRACT_THREADS voxels a round
// without a division (an integer division is some 20 instructions: three a voxel held the count kernel)
struct Walk {
  int v, i, j, k;
};

__device__ __forceinline__ Walk walk_from(const Grid& g, int v) {
  return {v, v / (g.Y * g.Z), (v / g.Z) % g.Y, v % g.Z};
}

__device__ __forceinline__ void walk_on(const Grid& g, Walk& w) {
  w.v += EXTRACT_THREADS;
  w.k += EXTRACT_THREADS;
  while (w.k >= g.Z) {
    w.k -= g.Z;
    if (++w.j == g.Y) {
      w.j = 0;
      ++w.i;
    }
  }
}

// the three edges of the walk's voxel (of n_voxels; past them, none crosses): which cross, and where. Every load
// is made, whatever the voxel (a neighbour past the last along its axis reads the voxel itself, a voxel past the
// volume the last voxel), so that unrolled rounds have their loads in flight together
__device__ __forceinline__ void voxel_edges(const float* __restrict__ value, const float* __restrict__ weight,
                                            const Grid& g, const Walk& w, int n_voxels, bool cross[3],
                                            float frac[3]) {
  const bool inside = w.v < n_voxels;
  const int v = inside ? w.v : n_voxels - 1;
  const int ijk[3] = {inside ? w.i : g.X - 1, inside ? w.j : g.Y - 1, inside ? w.k : g.Z - 1};
  const int n[3] = {g.X, g.Y, g.Z};
  const int stride[3] = {g.Y * g.Z, g.Z, 1};
  const float F0 = __ldg(value + v), W0 = __ldg(weight + v);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const bool last = ijk[a] == n[a] - 1;
    const int u = last ? v : v + stride[a];
    cross[a] = inside && edge_crosses(F0, W0, __ldg(value + u), __ldg(weight + u), last, frac[a]);
  }
}

// The value lane of ops/raycast.py::trilinear_tsdf_shard at metric (px, py, pz)
__device__ float trilinear_value(const float* __restrict__ value, const Grid& g, float px, float py, float pz,
                                 float vs, float inv_vs) {
  int gx = xs::to_index(floorf(px * inv_vs));
  int gy = xs::to_index(floorf(py * inv_vs));
  int gz = xs::to_index(floorf(pz * inv_vs));
  if (!(gx > 0 && gx < g.X - 1 && gy > 0 && gy < g.Y - 1 && gz > 0 && gz < g.Z - 1)) return xs::quiet_nan();
  // shift the base cell where the point lies below the voxel centre (RayCaster.cu:117-122)
  gx -= px < ((float)gx + 0.5f) * vs;
  gy -= py < ((float)gy + 0.5f) * vs;
  gz -= pz < ((float)gz + 0.5f) * vs;
  const float a0 = px * inv_vs - ((float)gx + 0.5f);
  const float b0 = py * inv_vs - ((float)gy + 0.5f);
  const float c0 = pz * inv_vs - ((float)gz + 0.5f);
  const float a1 = 1.0f - a0, b1 = 1.0f - b0, c1 = 1.0f - c0;
  const float* p = value + ((long long)gx * g.Y + gy) * g.Z + gz;
  const int sx = g.Y * g.Z, sy = g.Z;
  auto tap = [&](int dx, int dy, int dz) { return __ldg(p + dx * sx + dy * sy + dz) + TAP_BIAS; };
  float r = tap(0, 0, 0) * ((a1 * b1) * c1);
  r = r + tap(0, 0, 1) * ((a1 * b1) * c0);
  r = r + tap(0, 1, 0) * ((a1 * b0) * c1);
  r = r + tap(0, 1, 1) * ((a1 * b0) * c0);
  r = r + tap(1, 0, 0) * ((a0 * b1) * c1);
  r = r + tap(1, 0, 1) * ((a0 * b1) * c0);
  r = r + tap(1, 1, 0) * ((a0 * b0) * c1);
  r = r + tap(1, 1, 1) * ((a0 * b0) * c0);
  return r;
}

// extract_points' normal at point p: the six samples' differences, normalised where |n| > 0, nan_to_num
__device__ void point_normal(const float* __restrict__ value, const Grid& g, const float p[3], float vs,
                             float inv_vs, float half, float out[3]) {
  float n[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float q[3] = {p[0], p[1], p[2]};
    q[a] = p[a] + half;
    const float plus = trilinear_value(value, g, q[0], q[1], q[2], vs, inv_vs);
    q[a] = p[a] - half;
    const float minus = trilinear_value(value, g, q[0], q[1], q[2], vs, inv_vs);
    n[a] = plus - minus;
  }
  const float norm = sqrtf((n[0] * n[0] + n[1] * n[1]) + n[2] * n[2]);
  const float d = fmaxf(norm, 1e-20f);
#pragma unroll
  for (int a = 0; a < 3; ++a) out[a] = xs::nan_to_num(norm > 0.0f ? n[a] / d : 0.0f);
}

// The block's exclusive prefix sum of x over its threads in order, and the block's total; every thread calls it
__device__ __forceinline__ int block_exclusive_sum(int x, int* warp_sums, int& total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    incl += lane >= o ? y : 0;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int ahead = 0;
  total = 0;
  for (int w = 0; w < WARPS; ++w) {
    ahead += w < warp ? warp_sums[w] : 0;
    total += warp_sums[w];
  }
  __syncthreads();  // warp_sums is written again by the next call
  return ahead + incl - x;
}

// a chunk's three counts (each at most 32) in one int: axis a's in bits 8a .. 8a + 7
__device__ __forceinline__ int chunk_count(int packed, int a) { return (packed >> (8 * a)) & 0xff; }

// scratch: tile_counts[a * n_tiles + t], the crossings of axis a in tile t; then chunk_counts[c], those of chunk c
// (the 32 voxels of warp w in round r of tile t: c = (t * EXTRACT_ROUNDS + r) * WARPS + w), packed
__global__ void __launch_bounds__(EXTRACT_THREADS)
    extract_count_kernel(const float* __restrict__ value, const float* __restrict__ weight, Grid g,
                         int* __restrict__ tile_counts, int* __restrict__ chunk_counts, int n_tiles) {
  __shared__ int warp_counts[3][WARPS];
  const int n_voxels = g.X * g.Y * g.Z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int counts[3] = {0, 0, 0};
  Walk w = walk_from(g, blockIdx.x * EXTRACT_TILE + threadIdx.x);
#pragma unroll 4
  for (int r = 0; r < EXTRACT_ROUNDS; ++r) {
    bool cross[3];
    float frac[3];
    voxel_edges(value, weight, g, w, n_voxels, cross, frac);
    int packed = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      packed |= __popc(__ballot_sync(0xffffffffu, cross[a])) << (8 * a);
      counts[a] += cross[a];
    }
    if (lane == 0) chunk_counts[(blockIdx.x * EXTRACT_ROUNDS + r) * WARPS + warp] = packed;
    walk_on(g, w);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int c = __reduce_add_sync(0xffffffffu, (unsigned)counts[a]);
    if (lane == 0) warp_counts[a][warp] = c;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    int sum = 0;
    for (int i = 0; i < WARPS; ++i) sum += warp_counts[threadIdx.x][i];
    tile_counts[threadIdx.x * n_tiles + blockIdx.x] = sum;
  }
}

struct ExtractParams {
  Grid g;
  int n_tiles, capacity;
  float vs, inv_vs, half;
};

__global__ void __launch_bounds__(EXTRACT_THREADS)
    extract_points_kernel(const float* __restrict__ value, const float* __restrict__ weight,
                          const int* __restrict__ tile_counts, const int* __restrict__ chunk_counts,
                          float* __restrict__ points, int* __restrict__ count_out, ExtractParams prm) {
  __shared__ int sums[6][WARPS];
  __shared__ int warp_sums[WARPS];
  __shared__ int chunk_rows[3][CHUNKS];  // each chunk's first row, for each axis
  __shared__ int chunk_packed[CHUNKS];   // the tile's chunk counts
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Grid& g = prm.g;

  // every axis's total, and the counts of this axis's tiles before this one
  int before[3] = {0, 0, 0}, total[3] = {0, 0, 0};
  for (int t = threadIdx.x; t < prm.n_tiles; t += EXTRACT_THREADS) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int c = tile_counts[a * prm.n_tiles + t];
      total[a] += c;
      before[a] += t < (int)blockIdx.x ? c : 0;
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int tw = __reduce_add_sync(0xffffffffu, (unsigned)total[a]);
    const int bw = __reduce_add_sync(0xffffffffu, (unsigned)before[a]);
    if (lane == 0) {
      sums[a][warp] = tw;
      sums[3 + a][warp] = bw;
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    total[a] = before[a] = 0;
    for (int w = 0; w < WARPS; ++w) {
      total[a] += sums[a][w];
      before[a] += sums[3 + a][w];
    }
  }
  const int all = total[0] + total[1] + total[2];
  const int count = min(all, prm.capacity);
  if (blockIdx.x == 0 && threadIdx.x == 0) *count_out = count;
  const int row0[3] = {before[0], total[0] + before[1], total[0] + total[1] + before[2]};

  // the rows past the count: zero points, a grid-strided share a block
  for (long long i = (long long)count * 3 + (long long)blockIdx.x * EXTRACT_THREADS + threadIdx.x;
       i < (long long)prm.capacity * 3; i += (long long)gridDim.x * EXTRACT_THREADS)
    points[i] = 0.0f;
  // a tile without crossings writes no row (most of a volume: the surface is thin)
  if (tile_counts[blockIdx.x] == 0 && tile_counts[prm.n_tiles + blockIdx.x] == 0 &&
      tile_counts[2 * prm.n_tiles + blockIdx.x] == 0)
    return;

  // each chunk's first row: the tile's row offset and the counts of the tile's chunks before it, in voxel order
  const int p0 = chunk_counts[blockIdx.x * CHUNKS + 2 * threadIdx.x];
  const int p1 = chunk_counts[blockIdx.x * CHUNKS + 2 * threadIdx.x + 1];
  chunk_packed[2 * threadIdx.x] = p0;
  chunk_packed[2 * threadIdx.x + 1] = p1;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    int tile_total;
    const int ahead = block_exclusive_sum(chunk_count(p0, a) + chunk_count(p1, a), warp_sums, tile_total);
    chunk_rows[a][2 * threadIdx.x] = row0[a] + ahead;
    chunk_rows[a][2 * threadIdx.x + 1] = row0[a] + ahead + chunk_count(p0, a);
  }
  __syncthreads();

  // each warp its chunks with crossings (the others are not read again): its voxels' edges, a ballot, each
  // crossing's point at its chunk's first row and the crossings of the lanes below it
  const unsigned below = (1u << lane) - 1u;
  for (int r = 0; r < EXTRACT_ROUNDS; ++r) {
    const int chunk = r * WARPS + warp;
    if (chunk_packed[chunk] == 0) continue;
    const Walk w = walk_from(g, blockIdx.x * EXTRACT_TILE + r * EXTRACT_THREADS + threadIdx.x);
    bool cross[3];
    float frac[3];
    voxel_edges(value, weight, g, w, g.X * g.Y * g.Z, cross, frac);
    const int ijk[3] = {w.i, w.j, w.k};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const unsigned ballot = __ballot_sync(0xffffffffu, cross[a]);
      const int row = chunk_rows[a][chunk] + __popc(ballot & below);
      if (cross[a] && row < prm.capacity) {
#pragma unroll
        for (int b = 0; b < 3; ++b)
          points[(long long)row * 3 + b] = ((float)ijk[b] + 0.5f + (b == a ? frac[a] : 0.0f)) * prm.vs;
      }
    }
  }
}

// a thread a row: the normal of each point before the count, zeros past it
__global__ void __launch_bounds__(EXTRACT_THREADS)
    extract_normals_kernel(const float* __restrict__ value, const float* __restrict__ points,
                           const int* __restrict__ count, float* __restrict__ normals, ExtractParams prm) {
  const int row = blockIdx.x * EXTRACT_THREADS + threadIdx.x;
  if (row >= prm.capacity) return;
  float nrm[3] = {0.0f, 0.0f, 0.0f};
  if (row < *count) {
    const float p[3] = {points[row * 3ll], points[row * 3ll + 1], points[row * 3ll + 2]};
    point_normal(value, prm.g, p, prm.vs, prm.inv_vs, prm.half, nrm);
  }
#pragma unroll
  for (int b = 0; b < 3; ++b) normals[row * 3ll + b] = nrm[b];
}

}  // namespace

// value, weight: the (X, Y, Z) planes; scratch: n_tiles * (3 + CHUNKS) int32 (n_tiles = ceil(X * Y * Z /
// EXTRACT_TILE)): the tiles' counts, then their chunks' (packed); points, normals: (capacity, 3) float32 out; count:
// one int32 out
extern "C" int xs_extract_points(const void* value, const void* weight, void* scratch, long long scratch_ints,
                                 void* points, void* normals, void* count, int X, int Y, int Z, int capacity,
                                 float vs, float inv_vs, float half, void* stream) {
  const long long n = (long long)X * Y * Z;
  const int n_tiles = (int)((n + EXTRACT_TILE - 1) / EXTRACT_TILE);
  if (X < 1 || Y < 1 || Z < 1 || 3 * n >= (1ll << 31) || capacity < 1 ||
      scratch_ints != (long long)n_tiles * (3 + CHUNKS))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Grid g{X, Y, Z};
  int* tile_counts = (int*)scratch;
  int* chunk_counts = tile_counts + 3 * n_tiles;
  extract_count_kernel<<<n_tiles, EXTRACT_THREADS, 0, s>>>((const float*)value, (const float*)weight, g, tile_counts,
                                                           chunk_counts, n_tiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const ExtractParams prm{g, n_tiles, capacity, vs, inv_vs, half};
  extract_points_kernel<<<n_tiles, EXTRACT_THREADS, 0, s>>>((const float*)value, (const float*)weight, tile_counts,
                                                            chunk_counts, (float*)points, (int*)count, prm);
  const cudaError_t err2 = cudaGetLastError();
  if (err2 != cudaSuccess) return (int)err2;
  extract_normals_kernel<<<(capacity + EXTRACT_THREADS - 1) / EXTRACT_THREADS, EXTRACT_THREADS, 0, s>>>(
      (const float*)value, (const float*)points, (const int*)count, (float*)normals, prm);
  return (int)cudaGetLastError();
}
