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
//   ((float)i + 0.5f + x_offset) * vs under every pose, samples the depth
//   bilinearly (all four taps non-zero, else the nearest tap, rintf), and
//   compares the ray distance with gt * trunc; the mask and the loss
//   error * error are those of the JAX code, operation for operation, in
//   the hyper-dual arithmetic of csfd/double.py (every constant is a lifted
//   {c, 0, 0, 0} that goes through the whole product, its zero lanes
//   included; 1 / x and sqrtf are IEEE-rounded; `c / x` is PyTorch's
//   reciprocal(x) * c; built with -fmad=false), so a voxel's lanes are the
//   plain version's bits (ops/tsdf_loss.py::_field_plain).
//
//   Three modes of one body (a template argument):
//   - REDUCE: P <= 21 pairs; sums[0] = pair 0's masked sum of loss.v,
//     sums[1 .. G] = pairs 0 .. G-1's sums of loss.e1 (G = min(P, 6)),
//     sums[1 + G + p] = pair p's sum of loss.e12; count = pair 0's mask;
//   - VALUE: the v lane alone, in float arithmetic (the same operations as
//     the v lane of REDUCE: no hyper-dual operation lets e1, e2 or e12 reach
//     the value), of pair 0: sums[0] and count;
//   - FIELD: pair `field_pair`'s four loss lanes and its mask per voxel
//     (zeros and false where gt fails its test).
//
// What bounds it on the H100: the value plane is read once (4 B a voxel,
// 67 MB at 256^3, 0.020 ms at 3.35 TB/s). The function needs some 3,600
// float32 operations at a voxel in the band (the value lane once, six
// first-derivative lanes and one second-derivative lane a pair: 1 + 6 + 21
// lanes, counted in chip_smoke.py), 0.006 ms at 67 TFLOP/s for the ~110,000
// such voxels of three fused frames, so the bytes bound it. This kernel runs
// all four lanes of every pair (84 lanes, 7 IEEE divisions a pair).
// What the design does about it: the simple design first. A thread a voxel;
// gt's test (pose-independent) comes first, so most of a zero-initialised
// volume costs one coalesced load; the P poses sit in shared memory; each
// thread adds its masked terms in DOUBLE to its own column of a shared
// accumulator (one rounding per addition, exact for the product of two
// float32). The block adds its threads' columns in thread order and writes
// its partials; the block that takes the last ticket (one integer atomic)
// adds the blocks' partials in four groups of blocks (group g: blocks g,
// g + 4, ...), then the groups in order, and rounds once to float32. The
// grid depends on the volume's size alone (ops/tsdf_loss.py::loss_blocks), so
// the order of every sum does: two launches give the same bits, and the sums
// lie within an ulp of the plain version's float64 sums. Sharing the v lane
// and the six e1 lanes across the pairs (1 + 6 + 21 lanes for 84) is later
// work (ROADMAP).

#include <cuda_runtime.h>

#include "dual.cuh"

namespace {

constexpr int BLOCK = 128;
constexpr int MAX_PAIRS = 21;
constexpr int POSE_FLOATS = 48;
constexpr int MAX_SUMS = 1 + 6 + MAX_PAIRS;  // loss, six gradient entries, one Hessian entry a pair
constexpr int GROUPS = 4;                    // groups of blocks the last block adds side by side
constexpr int MODE_REDUCE = 0, MODE_VALUE = 1, MODE_FIELD = 2;

struct HD {
  float v, e1, e2, e12;
};

__device__ __forceinline__ HD operator+(HD a, HD b) { return {a.v + b.v, a.e1 + b.e1, a.e2 + b.e2, a.e12 + b.e12}; }
__device__ __forceinline__ HD operator-(HD a, HD b) { return {a.v - b.v, a.e1 - b.e1, a.e2 - b.e2, a.e12 - b.e12}; }
__device__ __forceinline__ HD operator*(HD a, HD b) {
  return {a.v * b.v, a.e1 * b.v + a.v * b.e1, a.e2 * b.v + a.v * b.e2,
          ((a.e12 * b.v + a.e1 * b.e2) + a.e2 * b.e1) + a.v * b.e12};
}
// DCSFD.__truediv__: q = 1 / o.v first
__device__ __forceinline__ HD div(HD a, HD o) {
  const float q = 1.0f / o.v;
  const float v = a.v * q;
  const float e1 = (a.e1 - v * o.e1) * q;
  const float e2 = (a.e2 - v * o.e2) * q;
  return {v, e1, e2, (((a.e12 - e1 * o.e2) - e2 * o.e1) - v * o.e12) * q};
}
__device__ __forceinline__ float div(float a, float o) { return a * (1.0f / o); }
// dc.sqrt through _unary: d1 = 0.5 / fv, d2 = -0.25 / (fv * v), each PyTorch's reciprocal(x) * c
__device__ __forceinline__ HD hsqrt(HD x) {
  const float fv = sqrtf(x.v);
  const float d1 = (1.0f / fv) * 0.5f;
  const float d2 = (1.0f / (fv * x.v)) * -0.25f;
  return {fv, d1 * x.e1, d1 * x.e2, d1 * x.e12 + (d2 * x.e1) * x.e2};
}
__device__ __forceinline__ float hsqrt(float x) { return sqrtf(x); }

template <class T> __device__ __forceinline__ T lift(float c);
template <> __device__ __forceinline__ HD lift<HD>(float c) { return {c, 0.0f, 0.0f, 0.0f}; }
template <> __device__ __forceinline__ float lift<float>(float c) { return c; }
__device__ __forceinline__ float val(HD x) { return x.v; }
__device__ __forceinline__ float val(float x) { return x; }

template <class T> __device__ __forceinline__ T pose_lane(const float* p, int k);
template <> __device__ __forceinline__ HD pose_lane<HD>(const float* p, int k) {
  return {p[k], p[12 + k], p[24 + k], p[36 + k]};
}
template <> __device__ __forceinline__ float pose_lane<float>(const float* p, int k) { return p[k]; }

struct Geom {
  int X, Y, Z, H, W, x_offset;
  float vs, fx, fy, cx, cy, trunc, inv_trunc;
};

__device__ __forceinline__ float tap(const float* depth, int y, int x, int H, int W) {
  return (y >= 0 && y < H && x >= 0 && x < W) ? __ldg(&depth[(size_t)y * W + x]) : 0.0f;
}

// One pair's chain at one voxel (tsdf_loss.py:83-118): the loss and the mask.
template <class T>
__device__ __forceinline__ T voxel_loss(const float* pose, float gt, float gx, float gy, float gz,
                                        const float* depth, const Geom& g, bool& mask) {
  const T lx = lift<T>(gx), ly = lift<T>(gy), lz = lift<T>(gz);
  T cam[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    cam[i] = ((pose_lane<T>(pose, 3 * i) * lx + pose_lane<T>(pose, 3 * i + 1) * ly) +
              pose_lane<T>(pose, 3 * i + 2) * lz) + pose_lane<T>(pose, 9 + i);
  const T vcx = cam[0], vcy = cam[1], vcz = cam[2];
  const T inv_z = div(lift<T>(1.0f), vcz);
  const bool front = val(inv_z) >= 0.0f;
  const T image_x = (vcx * inv_z) * lift<T>(g.fx) + lift<T>(g.cx);
  const T image_y = (vcy * inv_z) * lift<T>(g.fy) + lift<T>(g.cy);

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
  const T a = image_x - lift<T>((float)cx + 0.5f);
  const T b = image_y - lift<T>((float)cy + 0.5f);
  const T one = lift<T>(1.0f);
  const T interp = (((lift<T>(d00) * (one - a)) * (one - b) + (lift<T>(d10) * a) * (one - b)) +
                    (lift<T>(d01) * (one - a)) * b) + (lift<T>(d11) * a) * b;
  const T dp = all_valid ? interp : lift<T>(d_near);
  const bool range_ok = val(dp) >= 0.2f && val(dp) <= 5.0f;

  const T xl = div(image_x - lift<T>(g.cx), lift<T>(g.fx));
  const T yl = div(image_y - lift<T>(g.cy), lift<T>(g.fy));
  const T lam2 = (xl * xl + yl * yl) + lift<T>(1.0f);
  const T distance = dp * hsqrt(lam2) - hsqrt((vcx * vcx + vcy * vcy) + vcz * vcz);
  const T error = (distance - lift<T>(gt * g.trunc)) * lift<T>(g.inv_trunc);
  const bool err_ok = fabsf(val(error)) <= 1.0f;
  mask = front && in_bounds && range_ok && err_ok;
  return error * error;
}

template <int MODE>
__global__ void __launch_bounds__(BLOCK)
tsdf_loss_kernel(const float* __restrict__ value, const float* __restrict__ depth, const float* __restrict__ poses,
                 int P, int field_pair, Geom g, double* partials, unsigned int* ticket, float* __restrict__ sums,
                 int* __restrict__ count_out, float* __restrict__ field, unsigned char* __restrict__ field_mask) {
  __shared__ float pose_s[MAX_PAIRS * POSE_FLOATS];
  __shared__ double acc[MAX_SUMS + 1][BLOCK];  // a column a thread; the last row counts the voxels
  __shared__ double group_sums[GROUPS][32];
  __shared__ bool is_last;
  const int tid = threadIdx.x;
  const int G = P < 6 ? P : 6;
  const int nq = MODE == MODE_REDUCE ? 1 + G + P : 1;  // sums a launch writes

  const int n_pose = (MODE == MODE_REDUCE ? P : 1) * POSE_FLOATS;
  const float* pose_src = poses + (MODE == MODE_FIELD ? field_pair * POSE_FLOATS : 0);
  for (int k = tid; k < n_pose; k += BLOCK) pose_s[k] = pose_src[k];
  if (MODE != MODE_FIELD)
    for (int q = 0; q <= MAX_SUMS; ++q) acc[q][tid] = 0.0;
  __syncthreads();

  const long long n = (long long)g.X * g.Y * g.Z;
  const long long stride = (long long)gridDim.x * BLOCK;
  for (long long idx = (long long)blockIdx.x * BLOCK + tid; idx < n; idx += stride) {
    const float gt = __ldg(&value[idx]);
    const bool gt_ok = gt != 0.0f && fabsf(gt) <= 0.95f;
    if constexpr (MODE == MODE_FIELD) {
      HD loss = {0.0f, 0.0f, 0.0f, 0.0f};
      bool mask = false;
      if (gt_ok) {
        const int z = (int)(idx % g.Z), y = (int)((idx / g.Z) % g.Y), x = (int)(idx / ((long long)g.Y * g.Z));
        const float gx = (((float)x + 0.5f) + (float)g.x_offset) * g.vs;
        loss = voxel_loss<HD>(pose_s, gt, gx, ((float)y + 0.5f) * g.vs, ((float)z + 0.5f) * g.vs, depth, g, mask);
      }
      field[idx] = loss.v;
      field[n + idx] = loss.e1;
      field[2 * n + idx] = loss.e2;
      field[3 * n + idx] = loss.e12;
      field_mask[idx] = mask ? 1 : 0;
    } else {
      if (!gt_ok) continue;
      const int z = (int)(idx % g.Z), y = (int)((idx / g.Z) % g.Y), x = (int)(idx / ((long long)g.Y * g.Z));
      const float gx = (((float)x + 0.5f) + (float)g.x_offset) * g.vs;
      const float gy = ((float)y + 0.5f) * g.vs, gz = ((float)z + 0.5f) * g.vs;
      if constexpr (MODE == MODE_VALUE) {
        bool mask;
        const float loss = voxel_loss<float>(pose_s, gt, gx, gy, gz, depth, g, mask);
        if (mask) {
          acc[0][tid] += (double)loss;
          acc[MAX_SUMS][tid] += 1.0;
        }
      } else {
        for (int p = 0; p < P; ++p) {
          bool mask;
          const HD loss = voxel_loss<HD>(pose_s + p * POSE_FLOATS, gt, gx, gy, gz, depth, g, mask);
          if (!mask) continue;
          if (p == 0) {
            acc[0][tid] += (double)loss.v;
            acc[MAX_SUMS][tid] += 1.0;
          }
          if (p < G) acc[1 + p][tid] += (double)loss.e1;
          acc[1 + G + p][tid] += (double)loss.e12;
        }
      }
    }
  }
  if constexpr (MODE == MODE_FIELD) return;

  // the block: thread q adds sum q's columns in thread order (q = nq: the count)
  __syncthreads();
  if (tid <= nq) {
    const int row = tid == nq ? MAX_SUMS : tid;
    double x = 0.0;
    for (int t = 0; t < BLOCK; ++t) x += acc[row][t];
    __stcg(&partials[(size_t)blockIdx.x * (nq + 1) + tid], x);
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the last block: thread (group, q) adds blocks group, group + 4, ... in order, then the groups in order
  {
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
      sums[tid] = (float)x;
    else
      *count_out = (int)x;  // exact: far below 2^53
  }
  if (tid == 0) *ticket = 0u;  // ready for the next launch on this stream
}

}  // namespace

// mode: 0 REDUCE (1 <= P <= 21), 1 VALUE (pair 0), 2 FIELD (pair field_pair). partials: room for
// blocks * (nq + 1) doubles, nq = 1 + min(P, 6) + P in REDUCE and 1 in VALUE; ticket: one zeroed unsigned
// int that the kernel leaves zeroed; sums: nq floats; count: one int. field: (4, X, Y, Z) floats and
// field_mask (X, Y, Z) bytes, FIELD only. The scratch belongs to one stream at a time.
extern "C" int xs_tsdf_loss(const void* value, const void* depth, const void* poses, int P, int mode,
                            int field_pair, void* partials, void* ticket, int blocks, void* sums, void* count,
                            void* field, void* field_mask, int X, int Y, int Z, int H, int W, int x_offset,
                            float vs, float fx, float fy, float cx, float cy, float trunc, float inv_trunc,
                            void* stream) {
  if (P < 1 || P > MAX_PAIRS || blocks < 1 || X < 1 || Y < 1 || Z < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  if (mode == MODE_FIELD ? (field == nullptr || field_mask == nullptr || field_pair < 0 || field_pair >= P)
                         : (partials == nullptr || ticket == nullptr || sums == nullptr || count == nullptr))
    return (int)cudaErrorInvalidValue;
  const Geom g{X, Y, Z, H, W, x_offset, vs, fx, fy, cx, cy, trunc, inv_trunc};
  const cudaStream_t s = (cudaStream_t)stream;
#define XS_TSDF_LOSS_LAUNCH(M)                                                                                   \
  tsdf_loss_kernel<M><<<blocks, BLOCK, 0, s>>>((const float*)value, (const float*)depth, (const float*)poses, P, \
                                              field_pair, g, (double*)partials, (unsigned int*)ticket,         \
                                              (float*)sums, (int*)count, (float*)field,                          \
                                              (unsigned char*)field_mask)
  if (mode == MODE_REDUCE)
    XS_TSDF_LOSS_LAUNCH(MODE_REDUCE);
  else if (mode == MODE_VALUE)
    XS_TSDF_LOSS_LAUNCH(MODE_VALUE);
  else if (mode == MODE_FIELD)
    XS_TSDF_LOSS_LAUNCH(MODE_FIELD);
  else
    return (int)cudaErrorInvalidValue;
#undef XS_TSDF_LOSS_LAUNCH
  return (int)cudaGetLastError();
}
