// B3: brick fusion on the dense (X, Y, Z) volume, in three kernels.
//
// Replaces the XLA code of xslam_tpu/ops/fusion_brick.py::integrate_brick
// with the coarse classifier (classify_fine and classify_split off) and no
// subcell stage: _depth_mips (:60), _classify_boxes with split=False (:219)
// with _footprint_bounds (:86), and _integrate_rows_core with
// subcell_cap=0 (:636). The TPU needed bricks to cut depth gathers, which
// it issues one scalar at a time; here they cut the voxels whose depth is
// read. The result is dense fusion's, bit for bit: the classes are
// conservative, a FAR voxel gets the update the exact one saturates to, and
// the per-voxel code is K2's own (fusion.cuh).
//
// B3a xs_depth_mips: per tile (min over valid depths, max over valid depths,
//   every pixel valid) at each of the MIP_LEVELS tile sizes, edge tiles padded
//   with +inf / -inf / true, into ONE (rows, 3) table, level after level. A
//   thread walks one pixel column, eight loads in flight, and keeps the
//   column's min, max and validity in registers; lanes are adjacent in x, so
//   a warp loads 128 contiguous bytes of one image row at any tile size.
//   Tiles up to 32 px wide: a warp takes 32 / ts tiles side by side and
//   MIP_ROWS / ts tile rows down; at the end of each tile row its lanes reduce
//   each tile by shuffles (segment_reduce) and the tile's first lane writes
//   the row: no shared memory, no block barrier. Wider tiles: a block takes
//   whole tiles of one tile row, their rows cut into runs of at most MIP_ROWS,
//   a thread a column of a run; the partials go through shared memory and a
//   group of lanes reduces each tile. One owner a row, no atomics. Min, max
//   and AND round nothing: the bits are the plain version's in any order. The
//   largest tiles' blocks start first; the grid is about one wave. Bound: the
//   1.2 MB image once plus the table; each level re-reads the image from L2,
//   and the 22 re-reads are what the kernel waits on.
// B3b xs_classify_bricks: ONE kernel for the classes and the ranks. Per
//   brick: the eight corners' projections (16 IEEE divisions) and the four
//   frustum planes, the exact point-to-box distance interval, the footprint,
//   the smallest covering mip level at or above the one searchsorted picks,
//   four table reads, the lambda interval, the class (0 NONE, 1 FAR, 2
//   ACTIVE, 3 FAR_PARTIAL). The work is a dependent chain of some 600
//   operations a brick and little memory (the 280 KB table, 16 B a brick
//   out): the bound is operations, and what holds a one-thread-a-brick grid
//   (1,024 warps, 8 an SM) is the chain's latency. Here a brick has
//   CORNER_LANES (2) lanes, four corners each, reduced by xor shuffles
//   (min.NaN / max.NaN: one instruction, NaN kept as torch keeps it); the
//   level is scanned upward from searchsorted's, a level a lane a round,
//   stopping at the first round whose ballot covers; i / ts is a
//   multiply-high by a magic number (exact for i < 2^16), not an integer
//   division; the lanes read the window's cells. More lanes repeat the
//   chain's tail on every lane (8 lanes measured slower than 1). Then the
//   ranks, in the same launch: a single-pass scan over tiles of
//   CLASSIFY_TILE bricks, a block a tile taken by an atomic ticket. A tile
//   publishes its counts in a status word tagged with the launch's epoch,
//   one word a 128-byte line (the blocks poll them), then warp 0 sums the
//   counts of every earlier tile, all its loads in flight, reloading those
//   not yet published together: no chain from tile to tile. Warp ballots
//   rank the bricks inside the tile. Integer sums: the same in any order, so
//   the ranks are flat brick order however the blocks run: the ACTIVE list,
//   each ACTIVE brick's rank, the work list (every non-NONE brick), n_active,
//   n_work and overflow = n_active > cap, on the device. The wrapper passes
//   the epoch and the tickets taken before: no launch clears the scratch, no
//   host read. Every operation follows the plain version one rounding at a
//   time (min and max in any order: they round nothing, and no class reads
//   the sign of a zero); a division by |f| is a multiply by its reciprocal
//   (taken in double), as PyTorch's CUDA operator divides by a host scalar,
//   so the classes are the plain version's on the card. A float-to-int
//   convert saturates as ops/sampling.py::to_index does (NaN -> -1, clamped
//   to +-2^30).
// B3c xs_fuse_bricks: in place on the dense planes, or (its row variant, the
//   brick layout) on the (NB, 512) brick rows: only brick_column differs. A warp takes one brick of
//   the work list at a time; the grid is as many warps as the SMs hold at
//   once, about as many as the work bricks of a frame, so a warp usually
//   takes one. Each lane fetches one of its warp's items up front (the id,
//   then the class and rank together, loaded with the flag and the work
//   count), and the warp broadcasts them by shuffles: one chain of loads a
//   warp, not one a brick. The warp stages the brick's three planes in
//   shared memory, twelve 16-byte loads a lane all in flight before any
//   arithmetic; then a lane takes two of the brick's 64 (x, y) columns of 8
//   z voxels, their column sums once (as K2 does), and walks their voxels
//   side by side, storing the updated ones alone. FAR and FAR_PARTIAL: K2's
//   gate, then the update the exact one saturates to, (v w + 1) / (w + 1)
//   and (g w + 0) / (w + 1), with no depth read. ACTIVE with rank < cap:
//   K2's exact update. An ACTIVE brick past the cap stays unfused (the "flag"
//   overflow). With dense_on_overflow the kernel reads the flag and, where it
//   is set, updates every brick of the volume exactly: K2's result from the
//   pre-frame volume, with no host read. The per-voxel arithmetic is
//   fusion.cuh's, so the bits are K2's. Bound: bytes, 24 B a voxel it updates
//   (three planes read and written), plus the depth image; 69 operations a
//   visited voxel to its gate.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "fusion.cuh"
#include "rows.cuh"

namespace {

constexpr int BRICK = 8;
constexpr int MAX_MIP_LEVELS = 22;  // ops/fusion_brick.py::MIP_LEVELS
constexpr int MIP_THREADS = 256;    // threads of a depth_mips block
constexpr int MIP_ROWS = 64;        // most rows one depth_mips thread walks
constexpr int MIP_INFLIGHT = 8;     // loads a depth_mips thread keeps in flight
constexpr int MIP_MIN_BLOCKS = 6;   // depth_mips blocks an SM holds at least: at most 40 registers a thread
constexpr int CLASSIFY_THREADS = 256;  // threads of a classify_bricks block
constexpr int CORNER_LANES = 2;        // lanes that classify one brick, a corner each
constexpr int CORNERS_PER_LANE = 8 / CORNER_LANES;
constexpr int CELL_LANES = CORNER_LANES < 4 ? CORNER_LANES : 4;  // lanes that read the window's 4 cells
constexpr int CELLS_PER_LANE = 4 / CELL_LANES;
constexpr int CLASSIFY_TILE = CLASSIFY_THREADS / CORNER_LANES;  // bricks of a block: ops/fusion_brick.py
constexpr int LEVEL_ROUNDS = (MAX_MIP_LEVELS + CORNER_LANES - 1) / CORNER_LANES;  // levels a lane counts
constexpr unsigned GROUP_BITS = (1u << CORNER_LANES) - 1u;
constexpr int DIVIDE_LIMIT = 1 << 16;  // the classifier divides pixel indices below this by a multiply-high
constexpr int LOOK_BACK_LOADS = 8;  // status words a lane of a classify_bricks look-back loads at once
constexpr int STATUS_STRIDE = 16;   // 8-byte words from one tile's status word to the next: one a 128 B line
constexpr unsigned long long LOOK_BACK_LIMIT_NS = 1000000000ull;  // a classify_bricks wait lasts less
static_assert(8 % CORNER_LANES == 0, "a brick's lanes share its 8 corners");
static_assert(CLASSIFY_THREADS / 32 <= 32, "warp 0 scans a block's ballots, one a lane");
constexpr int FUSE_WARPS = 4;       // warps of a fuse_bricks block, one brick each at a time
constexpr int FUSE_THREADS = 32 * FUSE_WARPS;
constexpr int FUSE_MIN_BLOCKS = 6;  // fuse_bricks blocks an SM holds at least: at most 80 registers a thread
constexpr int COLUMN_STRIDE = BRICK + 1;  // floats between a staged brick's z columns
constexpr int INDEX_LIMIT = 1 << 30;  // ops/sampling.py::_INDEX_LIMIT
enum : int { NONE = 0, FAR = 1, ACTIVE = 2, FAR_PARTIAL = 3 };

// the table's levels: tile size, tiles down, tiles across, first row; and depth_mips' blocks of each level
struct MipLevels {
  int n, rows;
  int ts[MAX_MIP_LEVELS], h[MAX_MIP_LEVELS], w[MAX_MIP_LEVELS], offset[MAX_MIP_LEVELS];
  unsigned magic[MAX_MIP_LEVELS];  // ceil(2^32 / ts): the classifier's division by ts (divide)
  int first_block[MAX_MIP_LEVELS], blocks[MAX_MIP_LEVELS], per_block[MAX_MIP_LEVELS];
};

// ---------------------------------------------------------------- B3a
// How a level's tiles of ts x ts pixels are walked. A tile up to a warp wide belongs to one warp: the warp takes
// `32 / ts` tiles side by side and `MIP_ROWS / ts` tile rows down. A wider tile belongs to a block: its rows are
// cut into `runs` runs of at most MIP_ROWS rows, each walked by its own threads, and a block takes as many such
// tiles side by side as its threads cover.
__host__ __device__ __forceinline__ bool mip_warp_level(int ts) { return ts <= 32 && ts <= MIP_ROWS; }
__host__ __device__ __forceinline__ int mip_runs(int ts) { return (ts + MIP_ROWS - 1) / MIP_ROWS; }

// max, min and AND of (mn, mx, av) over lanes [lane, end) of the warp (end <= 32): the whole segment at its
// first lane
__device__ __forceinline__ void segment_reduce(float& mn, float& mx, int& av, int lane, int end) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float omn = __shfl_down_sync(0xffffffffu, mn, off), omx = __shfl_down_sync(0xffffffffu, mx, off);
    const int oav = __shfl_down_sync(0xffffffffu, av, off);
    if (lane + off < end) {
      mn = fminf(mn, omn);
      mx = fmaxf(mx, omx);
      av &= oav;
    }
  }
}

// lanes that reduce one tile's ts * runs column partials: a power of two, at most 32
__device__ __forceinline__ int mip_group(int cells) {
  int g = 1;
  while (2 * g <= cells && g < 32) g *= 2;
  return g;
}

// A tile row's partial of one pixel column: d past the image is padding and counts for nothing.
__device__ __forceinline__ void mip_take(float d, float& mn, float& mx, int& av) {
  if (d > 0.0f) {
    mn = fminf(mn, d);
    mx = fmaxf(mx, d);
  } else {
    av = 0;
  }
}

__device__ __forceinline__ void mip_store(float* __restrict__ table, int row, float mn, float mx, int av) {
  table[3 * row] = mn;
  table[3 * row + 1] = mx;
  table[3 * row + 2] = av ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(MIP_THREADS, MIP_MIN_BLOCKS)
    depth_mips_kernel(const float* __restrict__ depth, float* __restrict__ table, int H, int W, const MipLevels m) {
  __shared__ float s_mn[MIP_THREADS], s_mx[MIP_THREADS];
  __shared__ unsigned char s_av[MIP_THREADS];
  // the block's level (the largest tiles' blocks come first), picked by selects
  int ts = m.ts[0], tiles_h = m.h[0], tiles_w = m.w[0], first = m.offset[0], first_block = m.first_block[0];
  int per_block = m.per_block[0];
#pragma unroll
  for (int k = 1; k < MAX_MIP_LEVELS; ++k) {
    if (k < m.n && (int)blockIdx.x >= m.first_block[k] && (int)blockIdx.x < m.first_block[k] + m.blocks[k]) {
      ts = m.ts[k];
      tiles_h = m.h[k];
      tiles_w = m.w[k];
      first = m.offset[k];
      first_block = m.first_block[k];
      per_block = m.per_block[k];
    }
  }
  const float inf = __int_as_float(0x7f800000);
  float mn = inf, mx = -inf;
  int av = 1;
  const int bi = (int)blockIdx.x - first_block;

  if (mip_warp_level(ts)) {
    // warp u of the level: tiles [tx0, tx0 + across) of tile rows [ty0, ty0 + stack); lane = tile t, column c
    const int across = 32 / ts, stack = MIP_ROWS / ts, strips = (tiles_w + across - 1) / across;
    const int lane = threadIdx.x & 31, u = bi * (MIP_THREADS / 32) + ((int)threadIdx.x >> 5);
    const int ty0 = (u / strips) * stack, tx0 = (u % strips) * across;
    if (ty0 >= tiles_h) return;  // past the level's last warp
    const int t = lane / ts, c = lane - t * ts, x = (tx0 + t) * ts + c;
    const bool owner = c == 0 && t < across && tx0 + t < tiles_w;
    const bool reads = t < across && tx0 + t < tiles_w && x < W;
    const float* col = depth + x;
    for (int ty = ty0; ty < min(ty0 + stack, tiles_h); ++ty) {  // warp-uniform, as are the rows
      const int yb = min((ty + 1) * ts, H);
      for (int y = ty * ts; y < yb; y += MIP_INFLIGHT) {
        float d[MIP_INFLIGHT];
#pragma unroll
        for (int i = 0; i < MIP_INFLIGHT; ++i) d[i] = reads && y + i < yb ? __ldg(col + (size_t)(y + i) * W) : 1.0f;
#pragma unroll
        for (int i = 0; i < MIP_INFLIGHT; ++i)
          if (reads && y + i < yb) mip_take(d[i], mn, mx, av);
      }
      // the tile row is complete: reduce each tile over its lanes
      segment_reduce(mn, mx, av, lane, (t + 1) * ts);
      if (owner) mip_store(table, first + ty * tiles_w + tx0 + t, mn, mx, av);
      mn = inf;
      mx = -inf;
      av = 1;
    }
    return;
  }

  // a block's tiles: per_block of tile row ty from tile tx0 (fewer at the row's end); thread (run r, column c
  // of the span) walks rows [ya, yb) of pixel column x; past the image: padding
  const int runs = mip_runs(ts), run_rows = (ts + runs - 1) / runs;
  const int blocks_across = (tiles_w + per_block - 1) / per_block;
  const int ty = bi / blocks_across, tx0 = (bi - ty * blocks_across) * per_block;
  const int n_tiles = min(per_block, tiles_w - tx0);
  const int span = per_block * ts;  // threads of one run: the block's pixel columns in x order
  const int r = (int)threadIdx.x / span, c = (int)threadIdx.x - r * span;
  const int x = tx0 * ts + c;
  const int ya = ty * ts + r * run_rows, yb = min(min(ya + run_rows, (ty + 1) * ts), H);
  if (r < runs && c < n_tiles * ts && x < W) {
    const float* col = depth + x;
    for (int y = ya; y < yb; y += MIP_INFLIGHT) {
      float d[MIP_INFLIGHT];
#pragma unroll
      for (int i = 0; i < MIP_INFLIGHT; ++i) d[i] = y + i < yb ? __ldg(col + (size_t)(y + i) * W) : 0.0f;
#pragma unroll
      for (int i = 0; i < MIP_INFLIGHT; ++i)
        if (y + i < yb) mip_take(d[i], mn, mx, av);
    }
  }
  s_mn[threadIdx.x] = mn;
  s_mx[threadIdx.x] = mx;
  s_av[threadIdx.x] = (unsigned char)av;
  __syncthreads();

  // tile t of the block: its ts columns of each run, reduced by the G aligned lanes t * G .. t * G + G - 1
  const int cells = ts * runs, G = mip_group(cells);
  const int t = (int)threadIdx.x / G, j = (int)threadIdx.x - t * G;
  mn = inf;
  mx = -inf;
  av = 1;
  if (t < n_tiles) {
    for (int i = j; i < cells; i += G) {
      const int ri = i / ts, q = ri * span + t * ts + (i - ri * ts);
      mn = fminf(mn, s_mn[q]);
      mx = fmaxf(mx, s_mx[q]);
      av &= s_av[q];
    }
  }
  for (int off = G / 2; off > 0; off >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    av &= __shfl_xor_sync(0xffffffffu, av, off);
  }
  if (j == 0 && t < n_tiles) mip_store(table, first + ty * tiles_w + tx0 + t, mn, mx, av);
}

// ---------------------------------------------------------------- B3b
struct ClassifyParams {
  int nbx, nby, nbz, H, W;
  int tiles;             // tiles of the scan: CLASSIFY_TILE bricks each, the last one cut at the volume's end
  float bm;              // brick edge in metres
  float fx, fy, cx, cy;  // the camera, as float32
  float plane_c[4];      // constant terms of the gate planes: cx - 2.5, (W - 0.5) - cx, cy - 2.5, (H - 0.5) - cy
  float inv_abs_fx, inv_abs_fy;
  float trunc, neg_trunc;
  int cap;
  unsigned ticket_base;      // tickets taken by the earlier launches on the scratch (mod 2^32)
  unsigned long long epoch;  // this launch's number on the scratch, from 1: a status word of another is stale
  MipLevels m;
};

// torch.minimum / torch.maximum: NaN if either is (the canonical NaN: no class reads a payload), one instruction
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float clip(float x, float lo, float hi) { return min_nan(max_nan(x, lo), hi); }

// min_nan / max_nan over the aligned group of `lanes` lanes (a power of two up to 8), by xor shuffles: every
// lane of the group gets the result. Min and max round nothing and propagate NaN in any order; only the sign
// of a zero can follow the order, and no class reads it (each use compares, or adds a nonzero constant).
template <int lanes>
__device__ __forceinline__ float group_min(float x) {
#pragma unroll
  for (int off = 1; off < lanes; off <<= 1) x = min_nan(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
template <int lanes>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 1; off < lanes; off <<= 1) x = max_nan(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// ops/sampling.py::to_index: NaN -> -1, then clamp to +-2^30 and truncate
__device__ __forceinline__ int to_index(float x) {
  if (isnan(x)) return -1;
  return (int)fminf(fmaxf(x, -(float)INDEX_LIMIT), (float)INDEX_LIMIT);
}

// i / ts for 0 <= i < DIVIDE_LIMIT, by a multiply-high with magic = ceil(2^32 / ts) (read_levels): exact there
// for every ts from 2 to 2^16 (tests/test_torch_fusion_brick.py checks the mip sizes exhaustively)
__device__ __forceinline__ int divide(int i, unsigned magic) { return (int)__umulhi((unsigned)i, magic); }

// _classify_boxes' coord_interval: the |c - centre| interval over [c0, c1], times 1 / |f|
__device__ __forceinline__ void coord_interval(float c0, float c1, float centre, float inv_abs_f, float& lo,
                                               float& hi) {
  const float a0 = fabsf(c0 - centre), a1 = fabsf(c1 - centre);
  const bool inside = c0 <= centre && centre <= c1;
  lo = (inside ? 0.0f : min_nan(a0, a1)) * inv_abs_f;
  hi = max_nan(a0, a1) * inv_abs_f;
}

// _classify_boxes' axis_interval: distances from o to the points of [b0, b0 + bm]
__device__ __forceinline__ void axis_interval(float b0, float bm, float o, float& lo, float& hi) {
  lo = fabsf(o - clip(o, b0, b0 + bm));
  hi = max_nan(fabsf(b0 - o), fabsf(b0 + bm - o));
}

// Brick (bx, by, bz)'s class, computed by the CORNER_LANES lanes of its group, j the lane's place in it (all
// 32 lanes of the warp call this together: it ballots); every lane of the group returns the class.
__device__ __forceinline__ int classify_brick(const float* __restrict__ table, const float* __restrict__ pose,
                                              const ClassifyParams& p, int bx, int by, int bz, int j) {
  const float* R = pose;       // value lane of the rotation
  const float* t = pose + 18;  // value lane of the translation
  const float bx0 = (float)bx * p.bm, by0 = (float)by * p.bm, bz0 = (float)bz * p.bm;
  const float fW = (float)p.W, fH = (float)p.H;

  // the lane's corners: projections, camera z and the four gate planes' values; then over the group
  float umin = 0, umax = 0, vmin = 0, vmax = 0, zmin = 0, zmax = 0, plane_max[4] = {0, 0, 0, 0};
#pragma unroll
  for (int c = 0; c < CORNERS_PER_LANE; ++c) {
    const int k = j * CORNERS_PER_LANE + c;
    const float px = bx0 + ((k & 4) ? p.bm : 0.0f);
    const float py = by0 + ((k & 2) ? p.bm : 0.0f);
    const float pz = bz0 + ((k & 1) ? p.bm : 0.0f);
    const float cx_ = ((R[0] * px + R[1] * py) + R[2] * pz) + t[0];
    const float cy_ = ((R[3] * px + R[4] * py) + R[5] * pz) + t[1];
    const float cz_ = ((R[6] * px + R[7] * py) + R[8] * pz) + t[2];
    const float zc = max_nan(cz_, 1e-6f);
    const float u = ((p.fx * cx_) / zc) + p.cx;
    const float v = ((p.fy * cy_) / zc) + p.cy;
    const float val[4] = {
        (p.fx * cx_ + 0.0f * cy_) + p.plane_c[0] * cz_,
        ((-p.fx) * cx_ + 0.0f * cy_) + p.plane_c[1] * cz_,
        (0.0f * cx_ + p.fy * cy_) + p.plane_c[2] * cz_,
        (0.0f * cx_ + (-p.fy) * cy_) + p.plane_c[3] * cz_,
    };
    if (c == 0) {
      umin = umax = u;
      vmin = vmax = v;
      zmin = zmax = cz_;
#pragma unroll
      for (int i = 0; i < 4; ++i) plane_max[i] = val[i];
    } else {
      umin = min_nan(umin, u);
      umax = max_nan(umax, u);
      vmin = min_nan(vmin, v);
      vmax = max_nan(vmax, v);
      zmin = min_nan(zmin, cz_);
      zmax = max_nan(zmax, cz_);
#pragma unroll
      for (int i = 0; i < 4; ++i) plane_max[i] = max_nan(plane_max[i], val[i]);
    }
  }
  umin = group_min<CORNER_LANES>(umin);
  umax = group_max<CORNER_LANES>(umax);
  vmin = group_min<CORNER_LANES>(vmin);
  vmax = group_max<CORNER_LANES>(vmax);
  zmin = group_min<CORNER_LANES>(zmin);
  zmax = group_max<CORNER_LANES>(zmax);
#pragma unroll
  for (int i = 0; i < 4; ++i) plane_max[i] = group_max<CORNER_LANES>(plane_max[i]);
  const bool frustum_out = plane_max[0] < 0.0f || plane_max[1] < 0.0f || plane_max[2] < 0.0f || plane_max[3] < 0.0f;

  // the camera's distance interval to the solid brick (camera origin in volume coordinates: -R^T t)
  const float ox = -((R[0] * t[0] + R[3] * t[1]) + R[6] * t[2]);
  const float oy = -((R[1] * t[0] + R[4] * t[1]) + R[7] * t[2]);
  const float oz = -((R[2] * t[0] + R[5] * t[1]) + R[8] * t[2]);
  float dxl, dxh, dyl, dyh, dzl, dzh;
  axis_interval(bx0, p.bm, ox, dxl, dxh);
  axis_interval(by0, p.bm, oy, dyl, dyh);
  axis_interval(bz0, p.bm, oz, dzl, dzh);
  const float dist_min = max_nan(sqrtf((dxl * dxl + dyl * dyl) + dzl * dzl), 1e-3f);
  const float dist_max = sqrtf((dxh * dxh + dyh * dyh) + dzh * dzh);

  umin = umin - 1.0f;
  umax = umax + 1.0f;
  vmin = vmin - 1.0f;
  vmax = vmax + 1.0f;
  const bool fully_behind = zmax < 0.0f;
  const bool z_safe = zmin > 1e-3f;
  const bool fully_outside = z_safe && (umax < 2.5f || umin > fW - 0.5f || vmax < 2.5f || vmin > fH - 0.5f);
  const bool fully_inside = z_safe && umin >= 2.5f && umax <= fW - 1.5f && vmin >= 2.5f && vmax <= fH - 1.5f;
  const float pr = z_safe ? 0.5f * max_nan(umax - umin, vmax - vmin) : __int_as_float(0x7f800000);
  const float u = 0.5f * (umin + umax), v = 0.5f * (vmin + vmax);

  // The level: the smallest at or above searchsorted(sizes, pr) (left side: the count of tiles smaller than
  // pr, counted by the group's lanes together) whose aligned 2 x 2 window covers the clipped footprint. The
  // group tests CORNER_LANES levels a round upward from there, a level a lane, and stops at the first round
  // whose ballot has a covering level: its lowest. The loop runs while any group of the warp searches.
  const MipLevels& m = p.m;
  const int cu = min(max(to_index(u - pr), 0), p.W - 1);
  const int cv = min(max(to_index(v - pr), 0), p.H - 1);
  const float ucl = clip(umax, 0.0f, fW - 1.0f), vcl = clip(vmax, 0.0f, fH - 1.0f);
  int base = 0;
#pragma unroll
  for (int r = 0; r < LEVEL_ROUNDS; ++r) {
    const int k = r * CORNER_LANES + j;
    base += (k < m.n && (float)m.ts[k] < pr) ? 1 : 0;
  }
#pragma unroll
  for (int off = 1; off < CORNER_LANES; off <<= 1) base += __shfl_xor_sync(0xffffffffu, base, off);
  const int group_first = ((int)threadIdx.x & 31) & ~(CORNER_LANES - 1);
  int level = m.n;
  bool searching = base < m.n;
  for (int k0 = base; __any_sync(0xffffffffu, searching); k0 += CORNER_LANES) {
    const int k = k0 + j;
    bool cover = false;
    if (searching && k < m.n) {
      const int s = m.ts[k];
      cover = ucl < (float)((divide(cu, m.magic[k]) + 2) * s) && vcl < (float)((divide(cv, m.magic[k]) + 2) * s);
    }
    const unsigned bits = (__ballot_sync(0xffffffffu, cover) >> group_first) & GROUP_BITS;
    if (searching && bits != 0u) level = k0 + __ffs((int)bits) - 1;
    searching = searching && bits == 0u && k0 + CORNER_LANES < m.n;
  }
  const bool level_ok = level < m.n;
  const int lv = level_ok ? level : m.n - 1;
  const int mh = m.h[lv], mw = m.w[lv];
  const int cu0 = min(divide(cu, m.magic[lv]), mw - 1), cv0 = min(divide(cv, m.magic[lv]), mh - 1);

  // the window's four cells, CELLS_PER_LANE a lane of the first CELL_LANES (the others repeat them), then
  // reduced over lanes j ^ 1, j ^ 2: with 2 lanes or more the plain version's order, min(min(c0, c1),
  // min(c2, c3)) (min and max are exact in any order); the valid flags are 0 or 1, so their product is exact
  float dmin = 0, dmax = 0, av = 0;
#pragma unroll
  for (int c = 0; c < CELLS_PER_LANE; ++c) {
    const int cell = (j & (CELL_LANES - 1)) * CELLS_PER_LANE + c;
    const int y = min(cv0 + (cell >> 1), mh - 1), x = min(cu0 + (cell & 1), mw - 1);
    const float* row = table + 3 * (size_t)(m.offset[lv] + y * mw + x);
    const float mn = __ldg(row), mx = __ldg(row + 1), ok = __ldg(row + 2);
    dmin = c == 0 ? mn : min_nan(dmin, mn);
    dmax = c == 0 ? mx : max_nan(dmax, mx);
    av = c == 0 ? ok : av * ok;
  }
#pragma unroll
  for (int off = 1; off < CELL_LANES; off <<= 1) {
    dmin = min_nan(dmin, __shfl_xor_sync(0xffffffffu, dmin, off));
    dmax = max_nan(dmax, __shfl_xor_sync(0xffffffffu, dmax, off));
    av = av * __shfl_xor_sync(0xffffffffu, av, off);
  }
  const bool all_valid = av > 0.5f;

  // the ray-length factor lambda over the footprint clipped to the image
  float xl_lo, xl_hi, yl_lo, yl_hi;
  coord_interval(clip(umin, 0.0f, fW - 1.0f), clip(umax, 0.0f, fW - 1.0f), p.cx, p.inv_abs_fx, xl_lo, xl_hi);
  coord_interval(clip(vmin, 0.0f, fH - 1.0f), clip(vmax, 0.0f, fH - 1.0f), p.cy, p.inv_abs_fy, yl_lo, yl_hi);
  const float lam_min = sqrtf((xl_lo * xl_lo + yl_lo * yl_lo) + 1.0f);
  const float lam_max = sqrtf((xl_hi * xl_hi + yl_hi * yl_hi) + 1.0f);

  const bool proj_ok = z_safe && level_ok;
  const bool none_by_band = proj_ok && (dmax * lam_max - dist_min < p.neg_trunc);
  const bool provably_far = proj_ok && all_valid && (dmin * lam_min - dist_max > p.trunc);
  if (fully_behind || fully_outside || frustum_out || none_by_band) return NONE;
  if (provably_far) return fully_inside ? FAR : FAR_PARTIAL;
  return ACTIVE;
}

// A tile's status word in the single-pass scan: the launch's epoch (42 bits) once written, then the tile's
// ACTIVE count and its work count, 11 bits each. Words of earlier launches carry their own epochs: no launch
// has to clear them.
constexpr int STATUS_COUNT_BITS = 11;
static_assert(CLASSIFY_TILE < (1 << STATUS_COUNT_BITS), "a tile's counts fit their bits");
__device__ __forceinline__ unsigned long long tile_status(unsigned long long epoch, int n_active, int n_work) {
  return (epoch << (2 * STATUS_COUNT_BITS)) | ((unsigned long long)n_active << STATUS_COUNT_BITS) |
         (unsigned long long)n_work;
}
__device__ __forceinline__ bool published(unsigned long long s, unsigned long long epoch) {
  return (s >> (2 * STATUS_COUNT_BITS)) == epoch;
}
__device__ __forceinline__ unsigned long long load_status(const unsigned long long* s) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(s));
  return v;
}
__device__ __forceinline__ void store_status(unsigned long long* s, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(s), "l"(v));
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The counts of every brick before tile `tile`, by warp 0 of its block: lane i takes the status words of
// tiles i, i + 32, ... below `tile`, LOOK_BACK_LOADS loads in flight, and reloads those not yet published,
// all together, until every one is. Every tile before `tile` belongs to a block that has started (the
// ticket) and publishes its counts before it waits on anything, so the waits end; one that lasts
// LOOK_BACK_LIMIT_NS means a fault: the launch traps and its wrapper raises. Integer sums: the same in any
// order. Every lane gets the sums.
__device__ __forceinline__ void counts_before(const unsigned long long* status, int tile, int lane,
                                              unsigned long long epoch, int& before_a, int& before_w) {
  constexpr unsigned long long COUNT_MASK = (1ull << STATUS_COUNT_BITS) - 1ull;
  int a = 0, w = 0;
  for (int first = lane; first < tile; first += LOOK_BACK_LOADS * 32) {
    unsigned long long s[LOOK_BACK_LOADS];
    unsigned pending = 0u;
#pragma unroll
    for (int k = 0; k < LOOK_BACK_LOADS; ++k)
      if (first + 32 * k < tile) pending |= 1u << k;
    const unsigned long long since = global_ns();
    for (;;) {
#pragma unroll
      for (int k = 0; k < LOOK_BACK_LOADS; ++k)
        if ((pending >> k) & 1u) s[k] = load_status(status + (size_t)(first + 32 * k) * STATUS_STRIDE);
#pragma unroll
      for (int k = 0; k < LOOK_BACK_LOADS; ++k) {
        if (((pending >> k) & 1u) && published(s[k], epoch)) {
          pending &= ~(1u << k);
          a += (int)((s[k] >> STATUS_COUNT_BITS) & COUNT_MASK);
          w += (int)(s[k] & COUNT_MASK);
        }
      }
      if (pending == 0u) break;
      if (global_ns() - since > LOOK_BACK_LIMIT_NS) __trap();
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    w += __shfl_xor_sync(0xffffffffu, w, off);
  }
  before_a = a;
  before_w = w;
}

// One launch: the classes, then the ranks in flat brick order by a single-pass scan over tiles of
// CLASSIFY_TILE bricks. A block takes its tile by an atomic ticket, publishes the tile's counts and sums the
// counts of the tiles before it (counts_before): no chain from tile to tile. scratch: word 0 holds the ticket
// counter (an unsigned int that runs on from launch to launch), words 1.. the tiles' status words; zeroed
// once per device and stream.
__global__ void __launch_bounds__(CLASSIFY_THREADS)
    classify_bricks_kernel(const float* __restrict__ table, const float* __restrict__ pose, int* __restrict__ cls,
                           unsigned long long* __restrict__ scratch, int* __restrict__ rank,
                           int* __restrict__ active_ids, int* __restrict__ work_ids, int* __restrict__ totals,
                           unsigned char* __restrict__ overflow, const __grid_constant__ ClassifyParams p) {
  constexpr int WARPS = CLASSIFY_THREADS / 32;
  __shared__ unsigned s_active[WARPS], s_work[WARPS];  // each warp's ballot of ACTIVE and of work bricks
  __shared__ int s_before_a[WARPS], s_before_w[WARPS];  // the bricks of the tile before each warp's
  __shared__ int s_prefix[2];  // the counts of every brick before the tile
  __shared__ int s_tile;
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  unsigned long long* status = scratch + 1;
  const int lane = (int)threadIdx.x & 31, warp = (int)threadIdx.x >> 5;
  const int j = lane & (CORNER_LANES - 1);
  const int n = p.nbx * p.nby * p.nbz;

  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(ticket, 1u) - p.ticket_base;
    if (t >= (unsigned)p.tiles) __trap();  // the scratch's counter does not follow its launches
    s_tile = (int)t;
  }
  __syncthreads();
  const int tile = s_tile;

  // brick b: the tile's threadIdx.x / CORNER_LANES-th, in flat order
  const int b = tile * CLASSIFY_TILE + (int)threadIdx.x / CORNER_LANES;
  const int bb = min(b, n - 1);  // past the volume's end the lanes repeat its last brick, for the ballots
  const int bz = bb % p.nbz, by = (bb / p.nbz) % p.nby, bx = bb / (p.nby * p.nbz);
  int c = classify_brick(table, pose, p, bx, by, bz, j);
  if (b >= n) c = NONE;
  const bool leader = j == 0;
  const unsigned active = __ballot_sync(0xffffffffu, leader && c == ACTIVE);
  const unsigned work = __ballot_sync(0xffffffffu, leader && c != NONE);
  if (lane == 0) {
    s_active[warp] = active;
    s_work[warp] = work;
  }
  if (leader && b < n) cls[b] = c;
  __syncthreads();

  if (warp == 0) {
    // the tile's counts, published at once, and the bricks of the tile before each warp's (a scan over the
    // warps' ballots in order)
    int a = lane < WARPS ? __popc(s_active[lane]) : 0, w = lane < WARPS ? __popc(s_work[lane]) : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int ua = __shfl_up_sync(0xffffffffu, a, off), uw = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) {
        a += ua;
        w += uw;
      }
    }
    if (lane == 31) store_status(status + (size_t)tile * STATUS_STRIDE, tile_status(p.epoch, a, w));
    if (lane < WARPS) {
      s_before_a[lane] = a - __popc(s_active[lane]);
      s_before_w[lane] = w - __popc(s_work[lane]);
    }
    int before_a, before_w;
    counts_before(status, tile, lane, p.epoch, before_a, before_w);
    if (lane == 31) {
      s_prefix[0] = before_a;
      s_prefix[1] = before_w;
      if (tile == p.tiles - 1) {
        totals[0] = before_a + a;
        totals[1] = before_w + w;
        *overflow = before_a + a > p.cap ? 1 : 0;
      }
    }
  }
  __syncthreads();

  // the brick's rank and list entries: the bricks before the tile and before its warp, then the leaders below
  // it in the warp's ballot
  if (!leader || b >= n) return;
  const unsigned below = (1u << lane) - 1u;
  const int ra = s_prefix[0] + s_before_a[warp] + __popc(active & below);
  rank[b] = c == ACTIVE ? ra : -1;
  if (c == ACTIVE) active_ids[ra] = b;
  if (c != NONE) work_ids[s_prefix[1] + s_before_w[warp] + __popc(work & below)] = b;
}

// ---------------------------------------------------------------- B3c
// What fuse_bricks does with a brick: nothing (an ACTIVE brick past the cap), the FAR update, the exact one.
enum : int { SKIP = 0, FAR_UPDATE = 1, EXACT_UPDATE = 2 };

// A brick's (x, y) column c (0..63: x offset c / 8, y offset c % 8): its 8 z voxels from z0, a multiple of 8,
// in the dense (X, Y, Z) planes or, with ROWS, in the brick-major (NB, 512) rows (rows.cuh's row_index, so the
// column is 8 consecutive lanes). Either way the run is 32-byte aligned. The one place where a brick and a
// column become addresses.
struct BrickColumn {
  int x, y, z0;
  size_t idx;  // of the column's first voxel
};

template <bool ROWS>
__device__ __forceinline__ BrickColumn brick_column(int b, int c, int nby, int nbz, const xs::FuseParams& p) {
  const int bz = b % nbz, by = (b / nbz) % nby, bx = b / (nby * nbz);
  BrickColumn col;
  col.x = bx * BRICK + (c >> 3);
  col.y = by * BRICK + (c & 7);
  col.z0 = bz * BRICK;
  col.idx = ROWS ? (size_t)xs::row_index(xs::make_rows(p.X / BRICK, nby, nbz), col.x, col.y, col.z0)
                 : ((size_t)col.x * p.Y + col.y) * p.Z + col.z0;
  return col;
}

// The updated voxels of a staged brick back to the planes: 8 lanes a column, 32 contiguous bytes, a column's
// voxels where its bit in `updated` is set.
template <bool ROWS>
__device__ __forceinline__ void write_back(float* __restrict__ value, float* __restrict__ grad,
                                           float* __restrict__ weight, int b, int lane, const float* s_v,
                                           const float* s_g, const float* s_w, const unsigned char* updated, int nby,
                                           int nbz, const xs::FuseParams& p) {
  const int z = lane & (BRICK - 1);
#pragma unroll 4
  for (int c = lane >> 3; c < BRICK * BRICK; c += 32 / BRICK) {
    if (!(updated[c] >> z & 1)) continue;
    const size_t at = brick_column<ROWS>(b, c, nby, nbz, p).idx + z;
    const int s = c * COLUMN_STRIDE + z;
    value[at] = s_v[s];
    grad[at] = s_g[s];
    weight[at] = s_w[s];
  }
}

// A voxel of a staged column whose sample is (tsv, tsg): its running average in shared memory where ok.
// fusion.cuh's arithmetic, so the bits are K2's.
__device__ __forceinline__ void update_voxel(float* s_v, float* s_g, float* s_w, bool ok, float tsv, float tsg,
                                             float max_w) {
  float v = *s_v, g = *s_g, w = *s_w;
  xs::average(v, g, w, tsv, tsg, max_w);
  if (!ok) return;
  *s_v = v;
  *s_g = g;
  *s_w = w;
}

template <bool ROWS>
__global__ void __launch_bounds__(FUSE_THREADS, FUSE_MIN_BLOCKS)
    fuse_bricks_kernel(float* __restrict__ value, float* __restrict__ grad, float* __restrict__ weight,
                       const float* __restrict__ depth, const float* __restrict__ pose, const int* __restrict__ cls,
                       const int* __restrict__ rank, const int* __restrict__ work_ids,
                       const int* __restrict__ totals, const unsigned char* __restrict__ overflow, int cap,
                       int dense_on_overflow, const xs::FuseParams p) {
  // the warp's brick, staged: three planes of 64 columns, COLUMN_STRIDE floats apart (no bank conflicts), and
  // a bit a voxel that says it was updated
  __shared__ float s_planes[FUSE_WARPS][3][BRICK * BRICK * COLUMN_STRIDE];
  __shared__ unsigned char s_updated[FUSE_WARPS][BRICK * BRICK];
  const int nby = p.Y / BRICK, nbz = p.Z / BRICK, n_bricks = (p.X / BRICK) * nby * nbz;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int warp = blockIdx.x * FUSE_WARPS + w, n_warps = gridDim.x * FUSE_WARPS;
  float* s_v = s_planes[w][0];
  float* s_g = s_planes[w][1];
  float* s_w = s_planes[w][2];
  const xs::FusePose dual_pose(pose);
  // the warp's items are warp, warp + n_warps, ...; lane i fetches item i of the next 32 (an id past the work
  // count is loaded with the flag and the count, then not used)
  for (int first = warp; first < n_bricks; first += 32 * n_warps) {
    const int item = first + lane * n_warps;
    const int listed = item < n_bricks ? work_ids[item] : 0;
    const bool dense = dense_on_overflow && *overflow != 0;  // every brick exactly: K2's result
    const int items = dense ? n_bricks : totals[1];
    if (first >= items) return;
    const int b = dense ? item : min(max(listed, 0), n_bricks - 1);
    int mode = dense ? EXACT_UPDATE : SKIP;
    if (!dense && item < items) {
      const int c = cls[b], rk = rank[b];
      mode = (c == FAR || c == FAR_PARTIAL) ? FAR_UPDATE : (c == ACTIVE && rk < cap ? EXACT_UPDATE : SKIP);
    }
    for (int i = 0; i < 32 && first + i * n_warps < items; ++i) {
      const int bi = __shfl_sync(0xffffffffu, b, i), mi = __shfl_sync(0xffffffffu, mode, i);
      if (mi == SKIP) continue;  // past the cap: left unfused this frame, and flagged
      // stage the brick's planes: lane pairs load a column's two 16-byte halves, all twelve loads in flight
      float4 run[4][3];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const size_t at = brick_column<ROWS>(bi, (lane + 32 * q) >> 1, nby, nbz, p).idx + 4 * (lane & 1);
        run[q][0] = *reinterpret_cast<const float4*>(value + at);
        run[q][1] = *reinterpret_cast<const float4*>(grad + at);
        run[q][2] = *reinterpret_cast<const float4*>(weight + at);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int at = ((lane + 32 * q) >> 1) * COLUMN_STRIDE + 4 * (lane & 1);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float* s = s_planes[w][k] + at;
          s[0] = run[q][k].x;
          s[1] = run[q][k].y;
          s[2] = run[q][k].z;
          s[3] = run[q][k].w;
        }
      }
      __syncwarp();
      // the lane's columns lane and lane + 32, their sums once, their voxels at each z side by side without
      // branches (both depth loads in flight), updated in shared memory
      const BrickColumn c0 = brick_column<ROWS>(bi, lane, nby, nbz, p);
      const BrickColumn c1 = brick_column<ROWS>(bi, lane + 32, nby, nbz, p);
      const xs::ColumnSums sums0 = xs::column_sums(dual_pose, xs::voxel_centre(c0.x, p.vs), xs::voxel_centre(c0.y, p.vs));
      const xs::ColumnSums sums1 = xs::column_sums(dual_pose, xs::voxel_centre(c1.x, p.vs), xs::voxel_centre(c1.y, p.vs));
      const int s0 = lane * COLUMN_STRIDE, s1 = (lane + 32) * COLUMN_STRIDE;
      const bool exact = mi == EXACT_UPDATE;
      unsigned up0 = 0, up1 = 0;
      for (int z = 0; z < BRICK; ++z) {
        const float gz = xs::voxel_centre(c0.z0 + z, p.vs);
        const xs::VoxelView o0 = xs::voxel_view(dual_pose, p, sums0, gz), o1 = xs::voxel_view(dual_pose, p, sums1, gz);
        float t0v = xs::BEYOND_V, t0g = xs::BEYOND_G, t1v = xs::BEYOND_V, t1g = xs::BEYOND_G;
        bool ok0 = o0.gated, ok1 = o1.gated;
        if (exact) {
          const float d0 = ok0 ? __ldg(depth + xs::depth_index(o0, p)) : 0.0f;
          const float d1 = ok1 ? __ldg(depth + xs::depth_index(o1, p)) : 0.0f;
          ok0 = xs::sample_at(d0, p, o0, t0v, t0g) && ok0;
          ok1 = xs::sample_at(d1, p, o1, t1v, t1g) && ok1;
        }
        update_voxel(s_v + s0 + z, s_g + s0 + z, s_w + s0 + z, ok0, t0v, t0g, p.max_w);
        update_voxel(s_v + s1 + z, s_g + s1 + z, s_w + s1 + z, ok1, t1v, t1g, p.max_w);
        up0 |= (unsigned)ok0 << z;
        up1 |= (unsigned)ok1 << z;
      }
      s_updated[w][lane] = (unsigned char)up0;
      s_updated[w][lane + 32] = (unsigned char)up1;
      __syncwarp();
      write_back<ROWS>(value, grad, weight, bi, lane, s_v, s_g, s_w, s_updated[w], nby, nbz, p);
      __syncwarp();  // the staged brick is read before the next one overwrites it
    }
  }
}

bool read_levels(const int* levels, int n_levels, int rows, MipLevels& m) {
  if (n_levels < 1 || n_levels > MAX_MIP_LEVELS) return false;
  m.n = n_levels;
  m.rows = rows;
  for (int k = 0; k < MAX_MIP_LEVELS; ++k) {
    const int* l = levels + 4 * (k < n_levels ? k : n_levels - 1);
    m.ts[k] = l[0];
    m.h[k] = l[1];
    m.w[k] = l[2];
    m.offset[k] = l[3];
    m.magic[k] = (unsigned)((0x100000000ull + (unsigned)l[0] - 1u) / (unsigned)l[0]);
    // tiles of 2 px or more (the magic fits 32 bits), ascending (the classifier counts the smaller ones)
    if (k < n_levels && (l[0] < 2 || l[0] * mip_runs(l[0]) > MIP_THREADS || (k > 0 && l[0] <= m.ts[k - 1])))
      return false;
  }
  // depth_mips' blocks, the largest tiles' first: a warp-level tile's blocks hold MIP_THREADS / 32 warps; a
  // wider tile's block takes up to MIP_THREADS / (ts * runs) tiles of a row, as many in each block of the row
  int at = 0;
  for (int k = MAX_MIP_LEVELS - 1; k >= 0; --k) {
    const int ts = m.ts[k];
    if (mip_warp_level(ts)) {
      const int across = 32 / ts, stack = MIP_ROWS / ts;
      const int warps = ((m.h[k] + stack - 1) / stack) * ((m.w[k] + across - 1) / across);
      m.per_block[k] = across;
      m.blocks[k] = (warps + MIP_THREADS / 32 - 1) / (MIP_THREADS / 32);
    } else {
      const int most = MIP_THREADS / (ts * mip_runs(ts));
      const int blocks_across = (m.w[k] + most - 1) / most;
      m.per_block[k] = (m.w[k] + blocks_across - 1) / blocks_across;
      m.blocks[k] = m.h[k] * blocks_across;
    }
    if (k >= n_levels) m.blocks[k] = 0;
    m.first_block[k] = at;
    at += m.blocks[k];
  }
  return true;
}

int mip_blocks(const MipLevels& m) {
  int n = 0;
  for (int k = 0; k < m.n; ++k) n += m.blocks[k];
  return n;
}

}  // namespace

// depth: (H, W) metres; table: (rows, 3); levels: 4 ints a level (tile size, tiles down, tiles across, first row)
extern "C" int xs_depth_mips(const void* depth, void* table, int H, int W, const int* levels, int n_levels, int rows,
                             void* stream) {
  MipLevels m{};
  if (!read_levels(levels, n_levels, rows, m)) return (int)cudaErrorInvalidValue;
  depth_mips_kernel<<<mip_blocks(m), MIP_THREADS, 0, (cudaStream_t)stream>>>((const float*)depth, (float*)table, H, W,
                                                                          m);
  return (int)cudaGetLastError();
}

// table: depth_mips' (rows, 3); pose: the 24 floats of the dual volume->camera pose (value lanes read);
// scratch: scratch_words 8-byte words, zeroed when made, 1 + STATUS_STRIDE a tile of CLASSIFY_TILE bricks at
// least, that belong to one stream at a time; ticket_base: the tickets its earlier launches took (their
// tiles, mod 2^32); epoch: its launches so far, this one included (from 1, below 2^42); cls, rank,
// active_ids, work_ids: one int a brick; totals: n_active, n_work; overflow: one byte. consts: brick edge,
// fx, fy, cx, cy, the four plane constants, 1 / |fx|, 1 / |fy|, trunc, -trunc, each a float32.
extern "C" int xs_classify_bricks(const void* table, const void* pose, void* cls, void* scratch,
                                  long long scratch_words, unsigned ticket_base, unsigned long long epoch,
                                  void* rank, void* active_ids, void* work_ids, void* totals, void* overflow,
                                  int nbx, int nby, int nbz, int H, int W, const int* levels, int n_levels,
                                  int rows, const float* consts, int cap, void* stream) {
  ClassifyParams p{};
  if (!read_levels(levels, n_levels, rows, p.m)) return (int)cudaErrorInvalidValue;
  if (H < 1 || W < 1 || H > DIVIDE_LIMIT || W > DIVIDE_LIMIT) return (int)cudaErrorInvalidValue;
  p.nbx = nbx;
  p.nby = nby;
  p.nbz = nbz;
  p.H = H;
  p.W = W;
  p.bm = consts[0];
  p.fx = consts[1];
  p.fy = consts[2];
  p.cx = consts[3];
  p.cy = consts[4];
  for (int i = 0; i < 4; ++i) p.plane_c[i] = consts[5 + i];
  p.inv_abs_fx = consts[9];
  p.inv_abs_fy = consts[10];
  p.trunc = consts[11];
  p.neg_trunc = consts[12];
  p.cap = cap;
  p.ticket_base = ticket_base;
  p.epoch = epoch;
  if (epoch < 1 || epoch >= (1ull << (64 - 2 * STATUS_COUNT_BITS))) return (int)cudaErrorInvalidValue;
  const long long n = (long long)nbx * nby * nbz;
  if (nbx < 1 || nby < 1 || nbz < 1 || n >= (1ll << 31) - CLASSIFY_TILE) return (int)cudaErrorInvalidValue;
  p.tiles = (int)((n + CLASSIFY_TILE - 1) / CLASSIFY_TILE);
  if (scratch_words < 1 + (long long)p.tiles * STATUS_STRIDE) return (int)cudaErrorInvalidValue;
  classify_bricks_kernel<<<p.tiles, CLASSIFY_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const float*)pose, (int*)cls, (unsigned long long*)scratch, (int*)rank, (int*)active_ids,
      (int*)work_ids, (int*)totals, (unsigned char*)overflow, p);
  return (int)cudaGetLastError();
}

// value, grad, weight: the (X, Y, Z) planes, each extent a multiple of 8, or with rows the (NB, 512) brick rows
// of such a volume; cls, rank, work_ids, totals, overflow: classify_bricks' outputs; dense_on_overflow: 1 to
// update every brick exactly where overflow is set
extern "C" int xs_fuse_bricks(void* value, void* grad, void* weight, const void* depth, const void* pose,
                              const void* cls, const void* rank, const void* work_ids, const void* totals,
                              const void* overflow, int X, int Y, int Z, int H, int W, float vs, float fx, float fy,
                              float cx, float cy, float inv_fx, float inv_fy, float trunc, float inv_trunc,
                              float max_w, int cap, int dense_on_overflow, int rows, void* stream) {
  if (X % BRICK || Y % BRICK || Z % BRICK) return (int)cudaErrorInvalidValue;
  const uintptr_t planes = reinterpret_cast<uintptr_t>(value) | reinterpret_cast<uintptr_t>(grad) |
                           reinterpret_cast<uintptr_t>(weight);
  if (planes % 16) return (int)cudaErrorMisalignedAddress;  // the column runs are loaded 16 bytes at a time
  static int grid[2][64] = {};  // per variant and device: as many blocks as its SMs hold at once
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidValue;
  const int v = rows ? 1 : 0;
  if (grid[v][dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rows)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fuse_bricks_kernel<true>, FUSE_THREADS, 0);
    else
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fuse_bricks_kernel<false>, FUSE_THREADS, 0);
    grid[v][dev] = sms * (per_sm > 0 ? per_sm : 1);
    if (grid[v][dev] <= 0) return (int)cudaErrorInvalidValue;
  }
  const xs::FuseParams p{X, Y, Z, H, W, vs, fx, fy, cx, cy, inv_fx, inv_fy, trunc, inv_trunc, max_w};
  if (rows)
    fuse_bricks_kernel<true><<<grid[v][dev], FUSE_THREADS, 0, (cudaStream_t)stream>>>(
        (float*)value, (float*)grad, (float*)weight, (const float*)depth, (const float*)pose, (const int*)cls,
        (const int*)rank, (const int*)work_ids, (const int*)totals, (const unsigned char*)overflow, cap,
        dense_on_overflow, p);
  else
    fuse_bricks_kernel<false><<<grid[v][dev], FUSE_THREADS, 0, (cudaStream_t)stream>>>(
        (float*)value, (float*)grad, (float*)weight, (const float*)depth, (const float*)pose, (const int*)cls,
        (const int*)rank, (const int*)work_ids, (const int*)totals, (const unsigned char*)overflow, cap,
        dense_on_overflow, p);
  return (int)cudaGetLastError();
}
