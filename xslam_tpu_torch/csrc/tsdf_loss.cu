// B12: the relocalization loss with its first and second derivatives.
//
// xs_tsdf_loss replaces the XLA code of xslam_tpu/ops/tsdf_loss.py::
//   tsdf_loss_hessian (reference ComputeLocalTsdfHessianKernel and
//   ComputeLocalTsdfLossKernel, TsdfFusion.cu:204-447), batched over seed
//   pairs as xslam_tpu/models/relocalize.py::loss_grad_hessian batches it with
//   jax.vmap. Inputs: the (X, Y, Z) float32 value plane, the (H, W) depth in
//   metres, and P packed hyper-dual volume->camera poses of 48 floats each:
//   R (3x3, row-major) and t (3) of the v lane, then of e1, e2 and e12
//   (ops/tsdf_loss.py::pack_pose, made by plain PyTorch from se3.exp ->
//   inverse). Each voxel with gt != 0 and |gt| <= 0.95 projects its centre
//   ((float)i + 0.5f + x_offset) * vs under the pose, samples the depth
//   bilinearly (all four taps non-zero, else the nearest tap, rintf), and
//   compares the ray distance with gt * trunc; the mask and the loss
//   error * error are those of the JAX code, operation for operation, in
//   the hyper-dual arithmetic of csfd/double.py (every constant is a lifted
//   {c, 0, ...} that goes through the whole product, its zero lanes
//   included; 1 / x and sqrtf are IEEE-rounded; `c / x` is PyTorch's
//   reciprocal(x) * c; built with -fmad=false), so a voxel's lanes are the
//   plain version's bits (ops/tsdf_loss.py::_field_plain).
//
//   Shared lanes. A pair's e1 and e2 lanes obey the same formulas, and
//   neither reads e12; the v lane reads neither. So a voxel's value lane,
//   its square roots and reciprocals and one first-derivative lane a seed
//   direction are computed once (Lanes::v, Lanes::f), and each pair (j, k)
//   adds only its second-derivative lane (Lanes::s), from f[j] and f[k] in
//   the operation order of the four-lane product (for a product
//   ((a.e12 * b.v + a.e1 * b.e2) + a.e2 * b.e1) + a.v * b.e12 with
//   e1 = f[j], e2 = f[k]). Two pose layouts (Layout<P>): the 21 seed pairs of
//   models/relocalize.py::seeded_poses (direction d's lanes are pair d's e1
//   lanes; pair (j, k)'s v lanes and its e1 and e2 lanes must be those of
//   pair 0 and of pairs j and k bit for bit, which every launch checks: where
//   they are not, REDUCE writes NaN sums and a count of -1 and FIELD NaN lanes
//   and a false mask everywhere), and a single pose
//   (its e1 and e2 lanes are two directions). ops/tsdf_loss.py::
//   _shared_lanes_plain is this arithmetic in plain PyTorch.
//
//   The band. gt's test does not depend on the pose, so xs_tsdf_band lists
//   the voxels that pass it once (flat int32 indices in C order and their
//   count, on the device; two kernels, no atomic cursor: each warp counts
//   its segment of BAND_SEGMENT voxels by ballots and keeps them, then each
//   tile sums the counts of the tiles before its own and each warp with band
//   voxels writes them at its offset, ranked by its ballots). A relocalize call
//   lists its band once and hands it to each of its launches.
//
//   Modes:
//   - REDUCE over the band: sums[0] = the masked sum of loss.v,
//     sums[1 .. G] = the sums of the G first-derivative lanes that are
//     gradient entries (6 with the seed pairs, pose 0's e1 with one pose), then a pair's
//     sum of loss.e12 each; count = the mask's;
//   - VALUE over the band: the v lane alone, in float arithmetic (the v lane
//     of REDUCE: no operation lets a derivative lane reach it), of pose 0:
//     sums[0] and count;
//   - FIELD (xs_tsdf_field), over the whole volume: pair `field_pair`'s four
//     loss lanes (v, f[j], f[k], s) and its mask per voxel (zeros and false
//     where gt fails its test; NaN and false everywhere where the lanes are
//     not shared).
//
// What bounds it on the H100. Listing the band reads the value plane once
// (4 B a voxel, 67 MB at 256^3, 0.020 ms at 3.35 TB/s). A REDUCE launch over
// a band needs some 3,600 float32 operations at each band voxel (the value
// lane once, six first-derivative lanes and one second-derivative lane a
// pair: 1 + 6 + 21 lanes, counted in chip_smoke.py): 0.006 ms at 67 TFLOP/s
// for the ~110,000 band voxels of three fused frames, so operations bound it.
// What the design does about it: the band, so that a launch touches band
// voxels alone (a thread's voxels are band entries, not volume voxels, and
// no warp runs a chain with most lanes masked off), and the shared lanes. A
// thread takes a band voxel and holds its 28-lane jet (1 + 6 + 21 floats) in
// registers: every index into a jet is a constant (the pair loops run over
// compile-time indices), so nothing goes to local memory; 255 registers, no
// spills, two blocks of LOSS_THREADS an SM, and LOSS_BLOCKS is that one wave.
// Splitting a voxel's pairs over 2, 3 or 7 warps (each recomputing the
// shared lanes with a smaller jet) and other grids were slower (PERF.md).
// A voxel's v lane and mask come first in float arithmetic; its jets only
// where the mask holds. Each thread adds its masked terms in DOUBLE to its
// own column of a shared accumulator (one rounding per addition, exact for
// the product of two float32), in band order (thread t of block b takes
// entries b * LOSS_THREADS + t, then + LOSS_BLOCKS * LOSS_THREADS, ...). The
// block adds its columns in order and writes its partials; the block that
// takes the last ticket (one integer atomic) adds the blocks' partials in
// four groups of blocks (group g: blocks g, g + 4, ...), then the groups in
// order, and rounds once to float32. The grid is fixed, so the order of
// every sum depends on the band's length alone: two launches give the same
// bits, and the sums lie within an ulp of the plain version's float64 sums.

#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

#include "dual.cuh"

namespace {

constexpr int MAX_PAIRS = 21;
constexpr int POSE_FLOATS = 48;
constexpr int DIRECTIONS = 6;
constexpr int MAX_SUMS = 1 + DIRECTIONS + MAX_PAIRS;  // loss, six gradient entries, one Hessian entry a pair
constexpr int GROUPS = 4;                               // groups of blocks the last block adds side by side
constexpr int MODE_REDUCE = 0, MODE_VALUE = 1;

constexpr int LOSS_THREADS = 128;  // a band voxel a thread (ops/tsdf_loss.py::LOSS_THREADS)
constexpr int LOSS_BLOCKS = 264;   // the grid of a REDUCE or VALUE launch: two blocks an SM (ops/tsdf_loss.py)
constexpr int FIELD_THREADS = 128;
constexpr int FIELD_MAX_BLOCKS = 528;
constexpr int BAND_THREADS = 256;
constexpr int BAND_WARPS = BAND_THREADS / 32;
constexpr int BAND_SEGMENT = 1024;  // voxels a warp counts and lists (ops/tsdf_loss.py::BAND_SEGMENT)
constexpr int BAND_TILE = BAND_WARPS * BAND_SEGMENT;
constexpr int BAND_UNROLL = 16;  // loads of a warp in flight
static_assert(LOSS_THREADS > MAX_SUMS && LOSS_THREADS >= GROUPS * 32, "a thread a sum, in the block and the groups");
static_assert(BAND_SEGMENT % (32 * BAND_UNROLL) == 0 && BAND_UNROLL <= 32, "a segment is whole rounds of loads");

// ------------------------------------------------------------- layouts
// The seed pairs of models/relocalize.py::_seed_pairs: pair d = (d, d) for d < 6, then (j, k), j < k, row by row.
__host__ __device__ constexpr int seed_j(int p) {
  if (p < DIRECTIONS) return p;
  int r = p - DIRECTIONS, j = 0, n = DIRECTIONS - 1;
  while (r >= n) {
    r -= n;
    ++j;
    --n;
  }
  return j;
}
__host__ __device__ constexpr int seed_k(int p) {
  if (p < DIRECTIONS) return p;
  int r = p - DIRECTIONS, j = 0, n = DIRECTIONS - 1;
  while (r >= n) {
    r -= n;
    ++j;
    --n;
  }
  return j + 1 + r;
}

// Where a layout's lanes lie in the packed poses, and the gradient entries it sums.
template <int P>
struct Layout;
template <>
struct Layout<MAX_PAIRS> {  // the seed pairs: direction d's lanes are pose d's e1 lanes; pair p's e12 lanes its own
  static constexpr int D = DIRECTIONS, PAIRS = MAX_PAIRS, GRADS = DIRECTIONS, POSES = MAX_PAIRS;
  __host__ __device__ static constexpr int j(int p) { return seed_j(p); }
  __host__ __device__ static constexpr int k(int p) { return seed_k(p); }
  __host__ __device__ static constexpr int f_at(int d) { return d * POSE_FLOATS + 12; }
  __host__ __device__ static constexpr int s_at(int p) { return p * POSE_FLOATS + 36; }
};
template <>
struct Layout<1> {  // one pose: its e1 lanes are direction 0, its e2 lanes direction 1
  static constexpr int D = 2, PAIRS = 1, GRADS = 1, POSES = 1;
  __host__ __device__ static constexpr int j(int) { return 0; }
  __host__ __device__ static constexpr int k(int) { return 1; }
  __host__ __device__ static constexpr int f_at(int d) { return 12 + 12 * d; }
  __host__ __device__ static constexpr int s_at(int) { return 36; }
};

// ------------------------------------------------------------- shared lanes
// fn(integral_constant<int, q>) for q = 0 .. N - 1: a pair's directions are constants of q, so that every index
// into a jet is one and the jet stays in registers
template <class Fn, int... Q>
__device__ __forceinline__ void for_each_pair(Fn&& fn, std::integer_sequence<int, Q...>) {
  (fn(std::integral_constant<int, Q>()), ...);
}
template <int N, class Fn>
__device__ __forceinline__ void for_pairs(Fn&& fn) {
  for_each_pair(fn, std::make_integer_sequence<int, N>());
}

// A hyper-dual number of layout L (Layout<P>): the v lane, one first-derivative lane a direction, one
// second-derivative lane a pair. Every index is a constant once the loops unroll, so a jet is registers.
template <class L>
struct Lanes {
  float v;
  float f[L::D];
  float s[L::PAIRS];
};

template <class L>
__device__ __forceinline__ Lanes<L> operator+(const Lanes<L>& a, const Lanes<L>& b) {
  Lanes<L> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int d = 0; d < L::D; ++d) r.f[d] = a.f[d] + b.f[d];
#pragma unroll
  for (int q = 0; q < L::PAIRS; ++q) r.s[q] = a.s[q] + b.s[q];
  return r;
}
template <class L>
__device__ __forceinline__ Lanes<L> operator-(const Lanes<L>& a, const Lanes<L>& b) {
  Lanes<L> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int d = 0; d < L::D; ++d) r.f[d] = a.f[d] - b.f[d];
#pragma unroll
  for (int q = 0; q < L::PAIRS; ++q) r.s[q] = a.s[q] - b.s[q];
  return r;
}
// DCSFD.__mul__: e12 = ((a.e12 * b.v + a.e1 * b.e2) + a.e2 * b.e1) + a.v * b.e12
template <class L>
__device__ __forceinline__ Lanes<L> operator*(const Lanes<L>& a, const Lanes<L>& b) {
  Lanes<L> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int d = 0; d < L::D; ++d) r.f[d] = a.f[d] * b.v + a.v * b.f[d];
  for_pairs<L::PAIRS>([&](auto q) {
    constexpr int Q = decltype(q)::value, j = L::j(Q), k = L::k(Q);
    r.s[Q] = ((a.s[Q] * b.v + a.f[j] * b.f[k]) + a.f[k] * b.f[j]) + a.v * b.s[Q];
  });
  return r;
}
// DCSFD.__truediv__: q = 1 / o.v first; the quotient's own e1 and e2 lanes enter its e12
template <class L>
__device__ __forceinline__ Lanes<L> div(const Lanes<L>& a, const Lanes<L>& o) {
  Lanes<L> r;
  const float q = 1.0f / o.v;
  r.v = a.v * q;
#pragma unroll
  for (int d = 0; d < L::D; ++d) r.f[d] = (a.f[d] - r.v * o.f[d]) * q;
  for_pairs<L::PAIRS>([&](auto p) {
    constexpr int Q = decltype(p)::value, j = L::j(Q), k = L::k(Q);
    r.s[Q] = (((a.s[Q] - r.f[j] * o.f[k]) - r.f[k] * o.f[j]) - r.v * o.s[Q]) * q;
  });
  return r;
}
__device__ __forceinline__ float div(float a, float o) { return a * (1.0f / o); }
// dc.sqrt through _unary: d1 = 0.5 / fv, d2 = -0.25 / (fv * v), each PyTorch's reciprocal(x) * c
template <class L>
__device__ __forceinline__ Lanes<L> hsqrt(const Lanes<L>& x) {
  Lanes<L> r;
  const float fv = sqrtf(x.v);
  const float d1 = (1.0f / fv) * 0.5f;
  const float d2 = (1.0f / (fv * x.v)) * -0.25f;
  r.v = fv;
#pragma unroll
  for (int d = 0; d < L::D; ++d) r.f[d] = d1 * x.f[d];
  for_pairs<L::PAIRS>([&](auto q) {
    constexpr int Q = decltype(q)::value, j = L::j(Q), k = L::k(Q);
    r.s[Q] = d1 * x.s[Q] + (d2 * x.f[j]) * x.f[k];
  });
  return r;
}
__device__ __forceinline__ float hsqrt(float x) { return sqrtf(x); }

// a lifted constant and a pose entry of each number type
template <class T>
struct Num;
template <>
struct Num<float> {
  __device__ __forceinline__ static float lift(float c) { return c; }
  __device__ __forceinline__ static float pose(const float* p, int e) { return p[e]; }
};
template <class L>
struct Num<Lanes<L>> {
  __device__ __forceinline__ static Lanes<L> lift(float c) {
    Lanes<L> r;
    r.v = c;
#pragma unroll
    for (int d = 0; d < L::D; ++d) r.f[d] = 0.0f;
#pragma unroll
    for (int q = 0; q < L::PAIRS; ++q) r.s[q] = 0.0f;
    return r;
  }
  // entry e of R (0..8) and t (9..11): pose 0's v lane, the directions' lanes, the pairs' e12 lanes
  __device__ __forceinline__ static Lanes<L> pose(const float* p, int e) {
    Lanes<L> r;
    r.v = p[e];
#pragma unroll
    for (int d = 0; d < L::D; ++d) r.f[d] = p[L::f_at(d) + e];
#pragma unroll
    for (int q = 0; q < L::PAIRS; ++q) r.s[q] = p[L::s_at(q) + e];
    return r;
  }
};
__device__ __forceinline__ float val(float x) { return x; }
template <class L>
__device__ __forceinline__ float val(const Lanes<L>& x) {
  return x.v;
}

struct Geom {
  int X, Y, Z, H, W, x_offset;
  float vs, fx, fy, cx, cy, trunc, inv_trunc;
};

__device__ __forceinline__ float tap(const float* depth, int y, int x, int H, int W) {
  return (y >= 0 && y < H && x >= 0 && x < W) ? __ldg(&depth[(size_t)y * W + x]) : 0.0f;
}

__device__ __forceinline__ bool in_band(float gt) { return gt != 0.0f && fabsf(gt) <= 0.95f; }

// The chain at one voxel (tsdf_loss.py:83-118): the loss and the mask. The ray's length is taken right after
// the camera point (the same operations; the camera point is dead sooner).
template <class T>
__device__ __forceinline__ T voxel_loss(const float* pose, float gt, int idx, const float* depth, const Geom& g,
                                        bool& mask) {
  using O = Num<T>;
  const int z = idx % g.Z, y = (idx / g.Z) % g.Y, x = idx / (g.Y * g.Z);
  const T lx = O::lift((((float)x + 0.5f) + (float)g.x_offset) * g.vs);
  const T ly = O::lift(((float)y + 0.5f) * g.vs), lz = O::lift(((float)z + 0.5f) * g.vs);
  T cam[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    cam[i] = ((O::pose(pose, 3 * i) * lx + O::pose(pose, 3 * i + 1) * ly) + O::pose(pose, 3 * i + 2) * lz) +
             O::pose(pose, 9 + i);
  const T ray = hsqrt((cam[0] * cam[0] + cam[1] * cam[1]) + cam[2] * cam[2]);
  const T inv_z = div(O::lift(1.0f), cam[2]);
  const bool front = val(inv_z) >= 0.0f;
  const T image_x = (cam[0] * inv_z) * O::lift(g.fx) + O::lift(g.cx);
  const T image_y = (cam[1] * inv_z) * O::lift(g.fy) + O::lift(g.cy);

  // _bilinear_depth_dcsfd (tsdf_loss.py:36-62)
  const int cx = xs::to_index(floorf(val(image_x) - 0.5f));
  const int cy = xs::to_index(floorf(val(image_y) - 0.5f));
  const bool in_bounds = cx > 1 && cy > 1 && cx < g.W - 1 && cy < g.H - 1;
  const float d00 = tap(depth, cy, cx, g.H, g.W);
  const float d10 = tap(depth, cy, cx + 1, g.H, g.W);
  const float d01 = tap(depth, cy + 1, cx, g.H, g.W);
  const float d11 = tap(depth, cy + 1, cx + 1, g.H, g.W);
  const float d_near = tap(depth, xs::to_index(rintf(val(image_y))), xs::to_index(rintf(val(image_x))), g.H, g.W);
  const bool all_valid = d00 != 0.0f && d01 != 0.0f && d10 != 0.0f && d11 != 0.0f;
  const T xl = div(image_x - O::lift(g.cx), O::lift(g.fx));
  const T yl = div(image_y - O::lift(g.cy), O::lift(g.fy));
  const T a = image_x - O::lift((float)cx + 0.5f);
  const T b = image_y - O::lift((float)cy + 0.5f);
  const T one = O::lift(1.0f);
  const T interp = (((O::lift(d00) * (one - a)) * (one - b) + (O::lift(d10) * a) * (one - b)) +
                    (O::lift(d01) * (one - a)) * b) + (O::lift(d11) * a) * b;
  const T dp = all_valid ? interp : O::lift(d_near);
  const bool range_ok = val(dp) >= 0.2f && val(dp) <= 5.0f;

  const T lam2 = (xl * xl + yl * yl) + O::lift(1.0f);
  const T distance = dp * hsqrt(lam2) - ray;
  const T error = (distance - O::lift(gt * g.trunc)) * O::lift(g.inv_trunc);
  const bool err_ok = fabsf(val(error)) <= 1.0f;
  mask = front && in_bounds && range_ok && err_ok;
  return error * error;
}

// the jets at a band voxel where the mask holds, added to the columns of the gradient entries and the pairs'
// second derivatives
template <class L>
__device__ __forceinline__ void add_lanes(const float* pose, float gt, int idx, const float* depth, const Geom& g,
                                          double (*acc)[LOSS_THREADS], int c) {
  bool mask;
  const Lanes<L> loss = voxel_loss<Lanes<L>>(pose, gt, idx, depth, g, mask);
#pragma unroll
  for (int d = 0; d < L::GRADS; ++d) acc[1 + d][c] += (double)loss.f[d];
#pragma unroll
  for (int q = 0; q < L::PAIRS; ++q) acc[1 + L::GRADS + q][c] += (double)loss.s[q];
}

// pair `pair`'s four loss lanes at a voxel that passes gt's test
template <class L>
__device__ __forceinline__ void field_lanes(int pair, const float* pose, float gt, int idx, const float* depth,
                                            const Geom& g, float out[4], bool& mask) {
  const Lanes<L> loss = voxel_loss<Lanes<L>>(pose, gt, idx, depth, g, mask);
  const int j = L::j(pair), k = L::k(pair);
  out[0] = loss.v;
#pragma unroll
  for (int d = 0; d < L::D; ++d) {
    if (d == j) out[1] = loss.f[d];
    if (d == k) out[2] = loss.f[d];
  }
#pragma unroll
  for (int q = 0; q < L::PAIRS; ++q)
    if (q == pair) out[3] = loss.s[q];
}

// The precondition of the shared lanes in layout L: pair p's v lanes are pose 0's and its e1 and e2 lanes are
// directions j(p) and k(p), bit for bit. One block's threads test it together.
template <class L>
__device__ __forceinline__ bool lanes_shared(const float* pose_s) {
  bool bad = false;
  if constexpr (L::POSES > 1) {
    for (int e = threadIdx.x; e < L::POSES * 36; e += blockDim.x) {
      const int p = e / 36, lane = (e % 36) / 12, m = e % 12;
      const int own = p * POSE_FLOATS + 12 * lane + m;
      const int shared = lane == 0 ? m : L::f_at(lane == 1 ? L::j(p) : L::k(p)) + m;
      bad |= __float_as_uint(pose_s[own]) != __float_as_uint(pose_s[shared]);
    }
  }
  return !__syncthreads_or(bad);
}

template <int MODE, int P>
__global__ void __launch_bounds__(LOSS_THREADS)
    tsdf_loss_kernel(const float* __restrict__ value, const float* __restrict__ depth, const float* __restrict__ poses,
                     const int* __restrict__ band, const int* __restrict__ band_count, Geom g, double* partials,
                     unsigned int* ticket, float* __restrict__ sums, int* __restrict__ count_out) {
  using L = Layout<P>;
  __shared__ float pose_s[MAX_PAIRS * POSE_FLOATS];
  __shared__ double acc[MAX_SUMS + 1][LOSS_THREADS];  // a column a thread; the last row counts the voxels
  __shared__ double group_sums[GROUPS][32];
  __shared__ bool is_last;
  const int tid = threadIdx.x;
  constexpr int nq = MODE == MODE_REDUCE ? 1 + L::GRADS + L::PAIRS : 1;  // sums a launch writes

  const int n_pose = (MODE == MODE_REDUCE ? L::POSES : 1) * POSE_FLOATS;
  for (int k = tid; k < n_pose; k += LOSS_THREADS) pose_s[k] = poses[k];
  for (int q = 0; q <= MAX_SUMS; ++q) acc[q][tid] = 0.0;
  __syncthreads();

  const int n = __ldg(band_count);
  for (int i = blockIdx.x * LOSS_THREADS + tid; i < n; i += LOSS_BLOCKS * LOSS_THREADS) {
    const int idx = __ldg(&band[i]);
    const float gt = __ldg(&value[idx]);
    bool mask;
    const float loss = voxel_loss<float>(pose_s, gt, idx, depth, g, mask);
    if (!mask) continue;
    acc[0][tid] += (double)loss;
    acc[MAX_SUMS][tid] += 1.0;
    if constexpr (MODE == MODE_REDUCE) add_lanes<L>(pose_s, gt, idx, depth, g, acc, tid);
  }

  // the block: thread q adds sum q's columns in order (q = nq: the count)
  __syncthreads();
  if (tid <= nq) {
    const int row = tid == nq ? MAX_SUMS : tid;
    double x = 0.0;
    for (int t = 0; t < LOSS_THREADS; ++t) x += acc[row][t];
    __stcg(&partials[(size_t)blockIdx.x * (nq + 1) + tid], x);
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const bool shared_ok = MODE != MODE_REDUCE || lanes_shared<L>(pose_s);

  // the last block: thread (group, q) adds blocks group, group + 4, ... in order, then the groups in order
  if (tid < GROUPS * 32) {
    const int q = tid & 31, group = tid >> 5;
    double x = 0.0;
    if (q <= nq)
      for (int b = group; b < (int)gridDim.x; b += GROUPS) x += __ldcg(&partials[(size_t)b * (nq + 1) + q]);
    group_sums[group][q] = x;
  }
  __syncthreads();
  if (tid <= nq) {
    double x = group_sums[0][tid];
    for (int grp = 1; grp < GROUPS; ++grp) x += group_sums[grp][tid];
    if (tid < nq)
      sums[tid] = shared_ok ? (float)x : __int_as_float(0x7fc00000);
    else
      *count_out = shared_ok ? (int)x : -1;  // exact: far below 2^53
  }
  if (tid == 0) *ticket = 0u;  // ready for the next launch on this stream
}

template <int P>
__global__ void __launch_bounds__(FIELD_THREADS)
    tsdf_field_kernel(const float* __restrict__ value, const float* __restrict__ depth,
                      const float* __restrict__ poses, int field_pair, Geom g, float* __restrict__ field,
                      unsigned char* __restrict__ field_mask) {
  using L = Layout<P>;
  __shared__ float pose_s[MAX_PAIRS * POSE_FLOATS];
  for (int k = threadIdx.x; k < L::POSES * POSE_FLOATS; k += FIELD_THREADS) pose_s[k] = poses[k];
  __syncthreads();
  const bool shared_ok = lanes_shared<L>(pose_s);
  const float fill = shared_ok ? 0.0f : __int_as_float(0x7fc00000);
  const int n = g.X * g.Y * g.Z;
  for (int idx = blockIdx.x * FIELD_THREADS + threadIdx.x; idx < n; idx += gridDim.x * FIELD_THREADS) {
    const float gt = __ldg(&value[idx]);
    float out[4] = {fill, fill, fill, fill};
    bool mask = false;
    if (shared_ok && in_band(gt)) field_lanes<L>(field_pair, pose_s, gt, idx, depth, g, out, mask);
#pragma unroll
    for (int lane = 0; lane < 4; ++lane) field[(size_t)lane * n + idx] = out[lane];
    field_mask[idx] = mask ? 1 : 0;
  }
}

// ------------------------------------------------------------- the band
// Each warp takes a segment of BAND_SEGMENT voxels in flat order, 32 a round; a round's ballot of gt's test is a
// bit a voxel. The count kernel reads the plane once and keeps the ballots (n / 32 words) and the counts of each
// warp's segment and each tile; the list kernel reads only the ballots of segments that hold band voxels.
constexpr int BAND_ROUNDS = BAND_SEGMENT / 32;

__global__ void __launch_bounds__(BAND_THREADS)
    tsdf_band_count_kernel(const float* __restrict__ value, long long n, int* __restrict__ tile_counts,
                           int* __restrict__ warp_counts, unsigned* __restrict__ ballots) {
  __shared__ int s_counts[BAND_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long segment = (long long)blockIdx.x * BAND_WARPS + warp;
  const long long base = segment * BAND_SEGMENT + lane;
  int count = 0;
  for (int r = 0; r < BAND_ROUNDS; r += BAND_UNROLL) {
    float gt[BAND_UNROLL];
#pragma unroll
    for (int u = 0; u < BAND_UNROLL; ++u) {
      const long long at = base + 32 * (r + u);
      gt[u] = at < n ? __ldg(&value[at]) : 0.0f;
    }
    unsigned mine = 0u;  // lane u keeps round r + u's ballot
#pragma unroll
    for (int u = 0; u < BAND_UNROLL; ++u) {
      const unsigned ballot = __ballot_sync(0xffffffffu, in_band(gt[u]));
      count += __popc(ballot);
      if (lane == u) mine = ballot;
    }
    if (lane < BAND_UNROLL) ballots[segment * BAND_ROUNDS + r + lane] = mine;
  }
  if (lane == 0) {
    warp_counts[segment] = count;
    s_counts[warp] = count;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < BAND_WARPS; ++w) total += s_counts[w];
    tile_counts[blockIdx.x] = total;
  }
}

// Each tile sums the counts of the tiles before it; each warp with band voxels lists them at its offset, in
// flat order: its rounds in order, 32 at a time (a lane a round's ballot, their counts scanned), a round's
// voxels ranked by the ballot's lower bits. The last tile writes the count.
__global__ void __launch_bounds__(BAND_THREADS)
    tsdf_band_list_kernel(const int* __restrict__ tile_counts, const int* __restrict__ warp_counts,
                          const unsigned* __restrict__ ballots, int* __restrict__ band, int* __restrict__ band_count) {
  __shared__ int s_before[BAND_WARPS];
  __shared__ int s_offset[BAND_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tile = blockIdx.x;
  int before = 0;
  for (int t = threadIdx.x; t < tile; t += BAND_THREADS) before += __ldg(&tile_counts[t]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) before += __shfl_xor_sync(0xffffffffu, before, off);
  if (lane == 0) s_before[warp] = before;
  __syncthreads();
  if (threadIdx.x == 0) {
    int at = 0;
    for (int w = 0; w < BAND_WARPS; ++w) at += s_before[w];
    for (int w = 0; w < BAND_WARPS; ++w) {
      s_offset[w] = at;
      at += __ldg(&warp_counts[(size_t)tile * BAND_WARPS + w]);
    }
    if (tile == (int)gridDim.x - 1) *band_count = at;
  }
  __syncthreads();
  const long long segment = (long long)tile * BAND_WARPS + warp;
  if (__ldg(&warp_counts[segment]) == 0) return;
  const unsigned below = (1u << lane) - 1u;
  int at = s_offset[warp];
  for (int r0 = 0; r0 < BAND_ROUNDS; r0 += 32) {
    const unsigned mine = r0 + lane < BAND_ROUNDS ? __ldg(&ballots[segment * BAND_ROUNDS + r0 + lane]) : 0u;
    int first = __popc(mine);  // the voxels of the rounds before lane's, by an inclusive scan less its own
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, first, off);
      if (lane >= off) first += up;
    }
    const int total = __shfl_sync(0xffffffffu, first, 31);
    first -= __popc(mine);
    for (int r = 0; r < 32 && r0 + r < BAND_ROUNDS; ++r) {
      const unsigned ballot = __shfl_sync(0xffffffffu, mine, r);
      const int start = __shfl_sync(0xffffffffu, first, r);
      if ((ballot >> lane) & 1u)
        band[at + start + __popc(ballot & below)] = (int)(segment * BAND_SEGMENT + 32 * (r0 + r) + lane);
    }
    at += total;
  }
}

}  // namespace

// The band of an (n)-voxel value plane: band (n int32) gets the flat indices that pass gt's test in C order,
// band_count (one int32) their number. scratch: at least tiles * (1 + BAND_WARPS) + tiles * BAND_WARPS *
// BAND_ROUNDS int32, tiles = ceil(n / BAND_TILE); it belongs to one stream at a time.
extern "C" int xs_tsdf_band(const void* value, long long n, void* scratch, long long scratch_ints, void* band,
                            void* band_count, void* stream) {
  if (n < 1 || n >= (1ll << 31) || value == nullptr || band == nullptr || band_count == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (n + BAND_TILE - 1) / BAND_TILE;
  if (scratch == nullptr || scratch_ints < tiles * (1 + BAND_WARPS + BAND_WARPS * BAND_ROUNDS))
    return (int)cudaErrorInvalidValue;
  int* tile_counts = (int*)scratch;
  int* warp_counts = tile_counts + tiles;
  unsigned* ballots = (unsigned*)(warp_counts + tiles * BAND_WARPS);
  const cudaStream_t s = (cudaStream_t)stream;
  tsdf_band_count_kernel<<<(unsigned)tiles, BAND_THREADS, 0, s>>>((const float*)value, n, tile_counts, warp_counts,
                                                                  ballots);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tsdf_band_list_kernel<<<(unsigned)tiles, BAND_THREADS, 0, s>>>(tile_counts, warp_counts, ballots, (int*)band,
                                                                 (int*)band_count);
  return (int)cudaGetLastError();
}

// mode: 0 REDUCE (P = 21, the seed pairs, or P = 1), 1 VALUE (pose 0) over the band listed by xs_tsdf_band for
// this value plane. partials: room for LOSS_BLOCKS * (nq + 1) doubles, nq = 1 + G + P in REDUCE (G = 6 with
// P = 21, 1 with P = 1) and 1 in VALUE; ticket: one zeroed unsigned int that the kernel leaves zeroed; sums: nq
// floats; count: one int. The scratch belongs to one stream at a time.
extern "C" int xs_tsdf_loss(const void* value, const void* depth, const void* poses, int P, int mode,
                            const void* band, const void* band_count, void* partials, long long partials_doubles,
                            void* ticket, void* sums, void* count, int X, int Y, int Z, int H, int W, int x_offset,
                            float vs, float fx, float fy, float cx, float cy, float trunc, float inv_trunc,
                            void* stream) {
  if (X < 1 || Y < 1 || Z < 1 || H < 1 || W < 1 || band == nullptr || band_count == nullptr ||
      partials == nullptr || ticket == nullptr || sums == nullptr || count == nullptr)
    return (int)cudaErrorInvalidValue;
  if (mode == MODE_REDUCE ? (P != 1 && P != MAX_PAIRS) : (mode != MODE_VALUE || P < 1))
    return (int)cudaErrorInvalidValue;
  const int nq = mode == MODE_VALUE ? 1 : (P == 1 ? 3 : MAX_SUMS);
  if (partials_doubles < (long long)LOSS_BLOCKS * (nq + 1)) return (int)cudaErrorInvalidValue;
  const Geom g{X, Y, Z, H, W, x_offset, vs, fx, fy, cx, cy, trunc, inv_trunc};
  const cudaStream_t s = (cudaStream_t)stream;
#define XS_TSDF_LOSS_LAUNCH(M, L)                                                                                \
  tsdf_loss_kernel<M, L><<<LOSS_BLOCKS, LOSS_THREADS, 0, s>>>(                                                   \
      (const float*)value, (const float*)depth, (const float*)poses, (const int*)band, (const int*)band_count, g, \
      (double*)partials, (unsigned int*)ticket, (float*)sums, (int*)count)
  if (mode == MODE_VALUE)
    XS_TSDF_LOSS_LAUNCH(MODE_VALUE, 1);
  else if (P == MAX_PAIRS)
    XS_TSDF_LOSS_LAUNCH(MODE_REDUCE, MAX_PAIRS);
  else
    XS_TSDF_LOSS_LAUNCH(MODE_REDUCE, 1);
#undef XS_TSDF_LOSS_LAUNCH
  return (int)cudaGetLastError();
}

// FIELD: pair field_pair's (4, X, Y, Z) float32 lanes in field and its (X, Y, Z) mask bytes in field_mask, over
// the whole volume; P = 21 (the seed pairs, whose lanes must be shared: else NaN lanes and a false mask) or P = 1.
extern "C" int xs_tsdf_field(const void* value, const void* depth, const void* poses, int P, int field_pair,
                             void* field, void* field_mask, int X, int Y, int Z, int H, int W, int x_offset, float vs,
                             float fx, float fy, float cx, float cy, float trunc, float inv_trunc, void* stream) {
  if (X < 1 || Y < 1 || Z < 1 || H < 1 || W < 1 || (P != 1 && P != MAX_PAIRS) || field_pair < 0 ||
      field_pair >= P || field == nullptr || field_mask == nullptr || (long long)X * Y * Z >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const Geom g{X, Y, Z, H, W, x_offset, vs, fx, fy, cx, cy, trunc, inv_trunc};
  const long long n = (long long)X * Y * Z;
  const int blocks = (int)(n / FIELD_THREADS + 1 < FIELD_MAX_BLOCKS ? n / FIELD_THREADS + 1 : FIELD_MAX_BLOCKS);
  const cudaStream_t s = (cudaStream_t)stream;
  if (P == MAX_PAIRS)
    tsdf_field_kernel<MAX_PAIRS><<<blocks, FIELD_THREADS, 0, s>>>((const float*)value, (const float*)depth,
                                                              (const float*)poses, field_pair, g, (float*)field,
                                                              (unsigned char*)field_mask);
  else
    tsdf_field_kernel<1><<<blocks, FIELD_THREADS, 0, s>>>((const float*)value, (const float*)depth,
                                                            (const float*)poses, field_pair, g, (float*)field,
                                                            (unsigned char*)field_mask);
  return (int)cudaGetLastError();
}
