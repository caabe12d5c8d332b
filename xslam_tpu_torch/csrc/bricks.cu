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
//   with +inf / -inf / true, into ONE (rows, 3) table, level after level.
//   A tile takes a power of two of threads, about 32 pixels each (2 threads
//   for 8 x 8, 512 for 128 x 128), walking the tile in row order with eight
//   loads in flight, then shuffles (and a shared-memory step past a warp);
//   so the grid is about one wave and no thread waits on a long chain of
//   loads. Min and max round nothing: the bits are the plain version's by
//   construction. The largest tiles' blocks start first. (One warp a tile,
//   its lanes walking up to 512 pixels one load at a time, was several times
//   slower.) Bound: the 1.2 MB image once (it stays in L2 for the 22
//   levels) plus the table.
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
// B3c xs_fuse_bricks: in place on the dense planes. A block of 512 threads
//   takes one brick at a time from the work list (z fastest: four 32-byte
//   z runs a warp), so the NONE bricks cost nothing; the grid is as many
//   blocks as the SMs hold at once. FAR and FAR_PARTIAL: K2's gate, then the
//   update the exact one saturates to, (v w + 1) / (w + 1) and (g w + 0) /
//   (w + 1), with no depth read. ACTIVE with rank < cap: K2's exact update.
//   An ACTIVE brick past the cap stays unfused (the "flag" overflow). With
//   dense_on_overflow the kernel reads the flag and, where it is set, updates
//   every brick of the volume exactly: K2's result from the pre-frame volume,
//   with no host read. Bound: bytes, 24 B a voxel it updates (three planes
//   read and written), plus the depth image; 69 operations a visited voxel to
//   its gate.

#include <cuda_runtime.h>

#include <cstddef>

#include "fusion.cuh"

namespace {

constexpr int BRICK = 8;
constexpr int MAX_MIP_LEVELS = 22;  // ops/fusion_brick.py::MIP_LEVELS
constexpr int MIP_THREADS = 512;    // threads of a depth_mips block
constexpr int CLASSIFY_THREADS = 256;
constexpr int FUSE_THREADS = BRICK * BRICK * BRICK;
constexpr int INDEX_LIMIT = 1 << 30;  // ops/sampling.py::_INDEX_LIMIT
enum : int { NONE = 0, FAR = 1, ACTIVE = 2, FAR_PARTIAL = 3 };

// the table's levels: tile size, tiles down, tiles across, first row; and depth_mips' blocks of each level
struct MipLevels {
  int n, rows;
  int ts[MAX_MIP_LEVELS], h[MAX_MIP_LEVELS], w[MAX_MIP_LEVELS], offset[MAX_MIP_LEVELS];
  int first_block[MAX_MIP_LEVELS], blocks[MAX_MIP_LEVELS];
};

// ---------------------------------------------------------------- B3a
// threads a tile of ts x ts pixels takes: a power of two up to MIP_THREADS, about 32 pixels a thread (at most
// 63), so a thread has at most eight rounds of eight loads and the grid is about one wave of the card
__host__ __device__ __forceinline__ int mip_tile_threads(int ts) {
  const int want = ts * ts / 32;
  int t = 1;
  while (2 * t <= want && t < MIP_THREADS) t *= 2;
  return t;
}

__global__ void __launch_bounds__(MIP_THREADS)
    depth_mips_kernel(const float* __restrict__ depth, float* __restrict__ table, int H, int W, const MipLevels m) {
  __shared__ float s_mn[MIP_THREADS / 32], s_mx[MIP_THREADS / 32];
  __shared__ int s_av[MIP_THREADS / 32];
  // the block's level (the largest tiles' blocks come first), picked by selects
  int ts = m.ts[0], tiles_w = m.w[0], tiles = m.h[0] * m.w[0], first = m.offset[0], first_block = m.first_block[0];
#pragma unroll
  for (int k = 1; k < MAX_MIP_LEVELS; ++k) {
    if (k < m.n && (int)blockIdx.x >= m.first_block[k] && (int)blockIdx.x < m.first_block[k] + m.blocks[k]) {
      ts = m.ts[k];
      tiles_w = m.w[k];
      tiles = m.h[k] * m.w[k];
      first = m.offset[k];
      first_block = m.first_block[k];
    }
  }
  const int threads = mip_tile_threads(ts);  // the same for the whole block
  const int tile = ((int)blockIdx.x - first_block) * (MIP_THREADS / threads) + (int)threadIdx.x / threads;
  const bool live = tile < tiles;
  const int ty = tile / tiles_w, tx = tile - ty * tiles_w;
  const int y0 = ty * ts, x0 = tx * ts;

  float mn = __int_as_float(0x7f800000), mx = -mn;
  int all_valid = 1;
  // thread q of the tile's takes pixels q, q + threads, ... in row order, eight loads at a time
  const int q = threadIdx.x % threads;
  const int step_y = threads / ts, step_x = threads - step_y * ts;
  int yy = live ? q / ts : ts, xx = q - (q / ts) * ts;
  while (yy < ts) {
    float d[8];
    bool in[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int y = y0 + yy, x = x0 + xx;
      in[k] = yy < ts && y < H && x < W;  // past the image: padding (+inf, -inf, valid)
      d[k] = in[k] ? __ldg(depth + y * W + x) : 0.0f;
      xx += step_x;
      yy += step_y;
      if (xx >= ts) {
        xx -= ts;
        ++yy;
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (!in[k]) continue;
      if (d[k] > 0.0f) {
        mn = fminf(mn, d[k]);
        mx = fmaxf(mx, d[k]);
      } else {
        all_valid = 0;
      }
    }
  }
  // the tile's threads: an aligned run of lanes (threads <= 32), or whole warps
  for (int off = min(threads, 32) / 2; off > 0; off >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    all_valid &= __shfl_xor_sync(0xffffffffu, all_valid, off);
  }
  if (threads > 32) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      s_mn[warp] = mn;
      s_mx[warp] = mx;
      s_av[warp] = all_valid;
    }
    __syncthreads();
    if (q != 0) return;
    for (int w = warp + 1; w < warp + threads / 32; ++w) {
      mn = fminf(mn, s_mn[w]);
      mx = fmaxf(mx, s_mx[w]);
      all_valid &= s_av[w];
    }
  }
  if (q != 0 || !live) return;
  const int row = first + tile;
  table[3 * row] = mn;
  table[3 * row + 1] = mx;
  table[3 * row + 2] = all_valid ? 1.0f : 0.0f;
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
__global__ void __launch_bounds__(FUSE_THREADS)
    fuse_bricks_kernel(float* __restrict__ value, float* __restrict__ grad, float* __restrict__ weight,
                       const float* __restrict__ depth, const float* __restrict__ pose, const int* __restrict__ cls,
                       const int* __restrict__ rank, const int* __restrict__ work_ids,
                       const int* __restrict__ totals, const unsigned char* __restrict__ overflow, int cap,
                       int dense_on_overflow, const xs::FuseParams p) {
  const int nby = p.Y / BRICK, nbz = p.Z / BRICK, n_bricks = (p.X / BRICK) * nby * nbz;
  const bool dense = dense_on_overflow && *overflow != 0;  // every brick exactly: K2's result
  const int items = dense ? n_bricks : totals[1];
  const int lx = threadIdx.x >> 6, ly = (threadIdx.x >> 3) & 7, lz = threadIdx.x & 7;
  const xs::FusePose dual_pose(pose);
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = dense ? item : work_ids[item];
    const int c = cls[b];
    const bool exact = dense || (c == ACTIVE && rank[b] < cap);
    if (!exact && c == ACTIVE) continue;  // past the cap: left unfused this frame, and flagged
    const int bz = b % nbz, by = (b / nbz) % nby, bx = b / (nby * nbz);
    const int x = bx * BRICK + lx, y = by * BRICK + ly, z = bz * BRICK + lz;
    const xs::ColumnSums sums = xs::column_sums(dual_pose, xs::voxel_centre(x, p.vs), xs::voxel_centre(y, p.vs));
    const xs::VoxelView o = xs::voxel_view(dual_pose, p, sums, xs::voxel_centre(z, p.vs));
    if (!o.gated) continue;
    const size_t idx = ((size_t)x * p.Y + y) * p.Z + z;
    if (exact)
      xs::fuse_gated_voxel(value, grad, weight, depth, p, o, idx);
    else
      xs::fuse_far_voxel(value, grad, weight, p, idx);
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
    if (k < n_levels && l[0] < BRICK) return false;  // depth_mips' lane walk needs tiles of 8 pixels or more
  }
  // depth_mips' blocks, the largest tiles' first: a block holds MIP_THREADS / mip_tile_threads(ts) tiles
  int at = 0;
  for (int k = MAX_MIP_LEVELS - 1; k >= 0; --k) {
    const int per_block = MIP_THREADS / mip_tile_threads(m.ts[k]);
    m.first_block[k] = at;
    m.blocks[k] = k < n_levels ? (m.h[k] * m.w[k] + per_block - 1) / per_block : 0;
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
