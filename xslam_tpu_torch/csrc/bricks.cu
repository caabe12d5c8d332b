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
// B3b xs_classify_bricks: two kernels. classify_bricks_kernel: one thread a
//   brick: the eight corners' projections and the four frustum planes, the
//   exact point-to-box distance interval, the footprint, the smallest
//   covering mip level (scanned from the level searchsorted picks, as the
//   top-down scan of :358-366 keeps the smallest), four table reads, the
//   lambda interval, the class (0 NONE, 1 FAR, 2 ACTIVE, 3 FAR_PARTIAL); each
//   block counts its ACTIVE and its non-NONE bricks. rank_bricks_kernel:
//   each block adds the counts of the blocks before it (integer sums: the
//   same in any order) and scans its own bricks by warp ballots, so the
//   ranks are flat brick order whatever order the blocks run in: the ACTIVE
//   list, each ACTIVE brick's rank, the work list (every non-NONE brick),
//   n_active, n_work and overflow = n_active > cap, on the device. Every
//   operation follows the plain version one rounding at a time; a division by
//   |f| is a multiply by its reciprocal (taken in double), as PyTorch's CUDA
//   operator divides by a host scalar, so the classes are the plain
//   version's on the card. A float-to-int convert saturates as
//   ops/sampling.py::to_index does (NaN -> -1, clamped to +-2^30).
// B3c xs_fuse_bricks: in place on the dense planes. A warp takes one brick of
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

namespace {

constexpr int BRICK = 8;
constexpr int MAX_MIP_LEVELS = 22;  // ops/fusion_brick.py::MIP_LEVELS
constexpr int MIP_THREADS = 256;    // threads of a depth_mips block
constexpr int MIP_ROWS = 64;        // most rows one depth_mips thread walks
constexpr int MIP_INFLIGHT = 8;     // loads a depth_mips thread keeps in flight
constexpr int MIP_MIN_BLOCKS = 6;   // depth_mips blocks an SM holds at least: at most 40 registers a thread
constexpr int CLASSIFY_THREADS = 256;
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
  float bm;              // brick edge in metres
  float fx, fy, cx, cy;  // the camera, as float32
  float plane_c[4];      // constant terms of the gate planes: cx - 2.5, (W - 0.5) - cx, cy - 2.5, (H - 0.5) - cy
  float inv_abs_fx, inv_abs_fy;
  float trunc, neg_trunc;
  MipLevels m;
};

// torch.minimum / torch.maximum: NaN if either is
__device__ __forceinline__ float min_nan(float a, float b) { return isnan(a) ? a : (isnan(b) ? b : fminf(a, b)); }
__device__ __forceinline__ float max_nan(float a, float b) { return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b)); }
__device__ __forceinline__ float clip(float x, float lo, float hi) { return min_nan(max_nan(x, lo), hi); }

// ops/sampling.py::to_index: NaN -> -1, then clamp to +-2^30 and truncate
__device__ __forceinline__ int to_index(float x) {
  if (isnan(x)) return -1;
  return (int)fminf(fmaxf(x, -(float)INDEX_LIMIT), (float)INDEX_LIMIT);
}

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

__device__ __forceinline__ int classify_brick(const float* __restrict__ table, const float* __restrict__ pose,
                              const ClassifyParams& p, int bx, int by, int bz) {
  const float* R = pose;       // value lane of the rotation
  const float* t = pose + 18;  // value lane of the translation
  const float bx0 = (float)bx * p.bm, by0 = (float)by * p.bm, bz0 = (float)bz * p.bm;
  const float fW = (float)p.W, fH = (float)p.H;

  // the eight corners: projections, camera z and the four gate planes' maxima
  float umin = 0, umax = 0, vmin = 0, vmax = 0, zmin = 0, zmax = 0, plane_max[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
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
    if (k == 0) {
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

  // searchsorted(sizes, pr), left side: the levels whose tile is smaller than pr
  const MipLevels& m = p.m;
  int base = 0;
#pragma unroll
  for (int k = 0; k < MAX_MIP_LEVELS; ++k) base += (k < m.n && (float)m.ts[k] < pr) ? 1 : 0;
  const int cu = min(max(to_index(u - pr), 0), p.W - 1);
  const int cv = min(max(to_index(v - pr), 0), p.H - 1);
  // the smallest level from base up whose aligned 2 x 2 window covers the clipped footprint
  const float ucl = clip(umax, 0.0f, fW - 1.0f), vcl = clip(vmax, 0.0f, fH - 1.0f);
  int level = m.n, ts = m.ts[0], mh = m.h[0], mw = m.w[0], first = m.offset[0];
#pragma unroll
  for (int k = MAX_MIP_LEVELS - 1; k >= 0; --k) {
    if (k < m.n && k >= base) {
      const int s = m.ts[k];
      if (ucl < (float)(((cu / s) + 2) * s) && vcl < (float)(((cv / s) + 2) * s)) level = k;
    }
  }
  const bool level_ok = level < m.n;
  const int lv = min(level, m.n - 1);
#pragma unroll
  for (int k = 1; k < MAX_MIP_LEVELS; ++k) {
    if (k == lv) {
      ts = m.ts[k];
      mh = m.h[k];
      mw = m.w[k];
      first = m.offset[k];
    }
  }
  const int cu0 = min(cu / ts, mw - 1), cv0 = min(cv / ts, mh - 1);
  float c_mn[4], c_mx[4], c_av[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int y = min(cv0 + (c >> 1), mh - 1), x = min(cu0 + (c & 1), mw - 1);
    const float* r = table + 3 * (size_t)(first + y * mw + x);
    c_mn[c] = __ldg(r);
    c_mx[c] = __ldg(r + 1);
    c_av[c] = __ldg(r + 2);
  }
  const float dmin = min_nan(min_nan(c_mn[0], c_mn[1]), min_nan(c_mn[2], c_mn[3]));
  const float dmax = max_nan(max_nan(c_mx[0], c_mx[1]), max_nan(c_mx[2], c_mx[3]));
  const bool all_valid = ((c_av[0] * c_av[1]) * c_av[2]) * c_av[3] > 0.5f;

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

__global__ void __launch_bounds__(CLASSIFY_THREADS)
    classify_bricks_kernel(const float* __restrict__ table, const float* __restrict__ pose, int* __restrict__ cls,
                           int* __restrict__ counts, const ClassifyParams p) {
  const int n = p.nbx * p.nby * p.nbz;
  const int b = blockIdx.x * CLASSIFY_THREADS + threadIdx.x;
  int c = NONE;
  if (b < n) {
    const int bz = b % p.nbz, by = (b / p.nbz) % p.nby, bx = b / (p.nby * p.nbz);
    c = classify_brick(table, pose, p, bx, by, bz);
    cls[b] = c;
  }
  const int n_active = __syncthreads_count(c == ACTIVE);
  const int n_work = __syncthreads_count(c != NONE);
  if (threadIdx.x == 0) {
    counts[2 * blockIdx.x] = n_active;
    counts[2 * blockIdx.x + 1] = n_work;
  }
}

// sum of v over the block (every thread gets it); s: 32 ints of shared memory
__device__ __forceinline__ int block_sum(int v, int* s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < CLASSIFY_THREADS / 32; ++w) total += s[w];
  return total;
}

// the block's exclusive prefix of a predicate, in thread order; s: 32 ints of shared memory
__device__ __forceinline__ int block_rank(bool pred, int* s) {
  const unsigned ballot = __ballot_sync(0xffffffffu, pred);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) s[warp] = __popc(ballot);
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += s[w];
  return before + __popc(ballot & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(CLASSIFY_THREADS)
    rank_bricks_kernel(const int* __restrict__ cls, const int* __restrict__ counts, int n, int blocks, int cap,
                       int* __restrict__ rank, int* __restrict__ active_ids, int* __restrict__ work_ids,
                       int* __restrict__ totals, unsigned char* __restrict__ overflow) {
  __shared__ int s[32];
  int before_a = 0, before_w = 0, all_a = 0, all_w = 0;
  for (int j = threadIdx.x; j < blocks; j += CLASSIFY_THREADS) {
    const int a = counts[2 * j], w = counts[2 * j + 1];
    all_a += a;
    all_w += w;
    if (j < (int)blockIdx.x) {
      before_a += a;
      before_w += w;
    }
  }
  before_a = block_sum(before_a, s);
  before_w = block_sum(before_w, s);
  all_a = block_sum(all_a, s);
  all_w = block_sum(all_w, s);

  const int b = blockIdx.x * CLASSIFY_THREADS + threadIdx.x;
  const int c = b < n ? cls[b] : NONE;
  const bool active = c == ACTIVE, work = c != NONE;
  const int ra = before_a + block_rank(active, s);
  const int rw = before_w + block_rank(work, s);
  if (b < n) rank[b] = active ? ra : -1;
  if (active) active_ids[ra] = b;
  if (work) work_ids[rw] = b;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    totals[0] = all_a;
    totals[1] = all_w;
    *overflow = all_a > cap ? 1 : 0;
  }
}

// ---------------------------------------------------------------- B3c
// What fuse_bricks does with a brick: nothing (an ACTIVE brick past the cap), the FAR update, the exact one.
enum : int { SKIP = 0, FAR_UPDATE = 1, EXACT_UPDATE = 2 };

// A brick's (x, y) column c (0..63: x offset c / 8, y offset c % 8) in the dense (X, Y, Z) planes: its 8 z
// voxels from z0, a multiple of 8, so the run is 32-byte aligned. The one place where a brick and a column
// become dense addresses.
struct BrickColumn {
  int x, y, z0;
  size_t idx;  // of the column's first voxel
};

__device__ __forceinline__ BrickColumn brick_column(int b, int c, int nby, int nbz, const xs::FuseParams& p) {
  const int bz = b % nbz, by = (b / nbz) % nby, bx = b / (nby * nbz);
  BrickColumn col;
  col.x = bx * BRICK + (c >> 3);
  col.y = by * BRICK + (c & 7);
  col.z0 = bz * BRICK;
  col.idx = ((size_t)col.x * p.Y + col.y) * p.Z + col.z0;
  return col;
}

// The updated voxels of a staged brick back to the planes: 8 lanes a column, 32 contiguous bytes, a column's
// voxels where its bit in `updated` is set.
__device__ __forceinline__ void write_back(float* __restrict__ value, float* __restrict__ grad,
                                           float* __restrict__ weight, int b, int lane, const float* s_v,
                                           const float* s_g, const float* s_w, const unsigned char* updated, int nby,
                                           int nbz, const xs::FuseParams& p) {
  const int z = lane & (BRICK - 1);
#pragma unroll 4
  for (int c = lane >> 3; c < BRICK * BRICK; c += 32 / BRICK) {
    if (!(updated[c] >> z & 1)) continue;
    const size_t at = brick_column(b, c, nby, nbz, p).idx + z;
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
        const size_t at = brick_column(bi, (lane + 32 * q) >> 1, nby, nbz, p).idx + 4 * (lane & 1);
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
      const BrickColumn c0 = brick_column(bi, lane, nby, nbz, p), c1 = brick_column(bi, lane + 32, nby, nbz, p);
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
      write_back(value, grad, weight, bi, lane, s_v, s_g, s_w, s_updated[w], nby, nbz, p);
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
    if (k < n_levels && (l[0] < 1 || l[0] * mip_runs(l[0]) > MIP_THREADS)) return false;
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
// counts: 2 ints a block of 256 bricks (scratch); cls, rank, active_ids, work_ids: one int a brick; totals:
// n_active, n_work; overflow: one byte. consts: brick edge, fx, fy, cx, cy, the four plane constants,
// 1 / |fx|, 1 / |fy|, trunc, -trunc, each a float32.
extern "C" int xs_classify_bricks(const void* table, const void* pose, void* cls, void* counts, void* rank,
                                  void* active_ids, void* work_ids, void* totals, void* overflow, int nbx, int nby,
                                  int nbz, int H, int W, const int* levels, int n_levels, int rows,
                                  const float* consts, int cap, void* stream) {
  ClassifyParams p{};
  if (!read_levels(levels, n_levels, rows, p.m)) return (int)cudaErrorInvalidValue;
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
  const int n = nbx * nby * nbz;
  const int blocks = (n + CLASSIFY_THREADS - 1) / CLASSIFY_THREADS;
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  classify_bricks_kernel<<<blocks, CLASSIFY_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const float*)pose, (int*)cls, (int*)counts, p);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  rank_bricks_kernel<<<blocks, CLASSIFY_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)cls, (const int*)counts, n, blocks, cap, (int*)rank, (int*)active_ids, (int*)work_ids,
      (int*)totals, (unsigned char*)overflow);
  return (int)cudaGetLastError();
}

// value, grad, weight: the (X, Y, Z) planes, each extent a multiple of 8; cls, rank, work_ids, totals,
// overflow: classify_bricks' outputs; dense_on_overflow: 1 to update every brick exactly where overflow is set
extern "C" int xs_fuse_bricks(void* value, void* grad, void* weight, const void* depth, const void* pose,
                              const void* cls, const void* rank, const void* work_ids, const void* totals,
                              const void* overflow, int X, int Y, int Z, int H, int W, float vs, float fx, float fy,
                              float cx, float cy, float inv_fx, float inv_fy, float trunc, float inv_trunc,
                              float max_w, int cap, int dense_on_overflow, void* stream) {
  if (X % BRICK || Y % BRICK || Z % BRICK) return (int)cudaErrorInvalidValue;
  const uintptr_t planes = reinterpret_cast<uintptr_t>(value) | reinterpret_cast<uintptr_t>(grad) |
                           reinterpret_cast<uintptr_t>(weight);
  if (planes % 16) return (int)cudaErrorMisalignedAddress;  // the column runs are loaded 16 bytes at a time
  static int grid[64] = {};  // per device: as many blocks as its SMs hold at once
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidValue;
  if (grid[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fuse_bricks_kernel, FUSE_THREADS, 0);
    grid[dev] = sms * (per_sm > 0 ? per_sm : 1);
    if (grid[dev] <= 0) return (int)cudaErrorInvalidValue;
  }
  const xs::FuseParams p{X, Y, Z, H, W, vs, fx, fy, cx, cy, inv_fx, inv_fy, trunc, inv_trunc, max_w};
  fuse_bricks_kernel<<<grid[dev], FUSE_THREADS, 0, (cudaStream_t)stream>>>(
      (float*)value, (float*)grad, (float*)weight, (const float*)depth, (const float*)pose, (const int*)cls,
      (const int*)rank, (const int*)work_ids, (const int*)totals, (const unsigned char*)overflow, cap,
      dense_on_overflow, p);
  return (int)cudaGetLastError();
}
