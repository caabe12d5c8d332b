// K4: one ICP iteration's normal equations, and the cached association.
//
// Replaces the XLA code of xslam_tpu/ops/icp.py::associate + build_system;
// reference ICP.cu:196-281 (search_newton, combinedKernel) and :246-429 (the
// two-stage reduction). Two entry points:
//
// - xs_icp_system: per pixel of the current maps, move the vertex into the
//   world with the dual current pose; find its target in the previous model,
//   either by projecting into the previous camera (value lane; round half to
//   even with rintf; NaN -> index -1) or by reading a cached index map; fetch
//   the model's 12 floats (v.v v.g n.v n.g); apply the gates in the
//   reference's order (current normal not NaN, in image and z >= 0, fetched
//   normal not NaN, dist <= dist_thres, sine < angle_thres); build the dual
//   row [cross(s, n), n | n.(d - s)] (NaN -> 0 and inf -> +-FLT_MAX as
//   nan_to_num); and reduce A = J^T J (21 distinct entries), b = J^T r and the
//   inlier count over all pixels, both lanes: 54 float sums and one integer.
// - xs_icp_associate: the projection alone, written as an int32 (H, W) map of
//   the flat target index, -1 where the pixel is not in the image. Caching the
//   index is equivalent to caching the 12 gathered floats, because a row is
//   valid only where the pixel is in the image.
//
// Bound on the H100: bytes. 72 B per pixel (24 B of current maps, a 48 B row
// of the model, 4 B more where the index is cached) against, per pixel with
// a current normal, 36 operations to move the vertex and 31 to project it;
// 10 for the distance gate of a pixel that fetched a target; 31 for the angle
// gate; and 239 for an inlier's dual row, nan_to_num and 54 sums (162 of them
// in double). Design: one launch per iteration. A thread walks pixels in a
// grid-stride loop (the pixel -> thread assignment is fixed by the shapes)
// and leaves a pixel at the first gate it fails, before the next fetch. The
// per-pixel row is float32 arithmetic in the reference's operation order, one
// rounding at a time (built with -fmad=false), so the gates decide as the
// plain version's do.
//
// The sums are accumulated in DOUBLE: the products of the float32 row entries
// are exact in double, each thread, warp (shuffles) and block (shared
// memory) adds them in double, every block writes its 55 partials, and the
// block that takes the last ticket adds the blocks' partials in a fixed order
// and rounds once to float32. The ticket is an integer atomic; no float
// atomic is used anywhere, and the order of every sum depends only on the
// shapes, so two runs on the same inputs give the same bits. (The reference
// reduces in double too; the JAX package sums 4096-row float32 blocks.)

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int NTRI = 21;         // distinct entries of a symmetric 6x6
constexpr int NQ = 2 * NTRI + 12 + 1;  // A.v, A.g, b.v, b.g, inlier count
constexpr float INDEX_LIMIT = 1073741824.0f;  // 2^30
constexpr float FLT_BIG = 3.402823466e+38f;

struct Geom {
  int n_curr;  // pixels of the current maps
  int Hp, Wp;  // shape of the previous model's maps
  float fx, fy, cx, cy, dist_thres, angle_thres;
};

// pose layout: R_curr.v (row-major 3x3), R_curr.g, t_curr.v, t_curr.g,
// R_prev_inv.v, t_prev.v
constexpr int RC_V = 0, RC_G = 9, TC_V = 18, TC_G = 21, RPI_V = 24, TP_V = 33;

__device__ __forceinline__ int to_index(float rounded) {
  if (isnan(rounded)) return -1;
  return (int)fminf(fmaxf(rounded, -INDEX_LIMIT), INDEX_LIMIT);
}

__device__ __forceinline__ float nan_to_num(float x) {
  if (isnan(x)) return 0.0f;
  if (isinf(x)) return x > 0.0f ? FLT_BIG : -FLT_BIG;
  return x;
}

// s = R_curr * v + t_curr, dual; v is real
__device__ __forceinline__ void world_vertex(const float* __restrict__ pose, const float v[3], float sv[3],
                                             float sg[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* rv = pose + RC_V + 3 * i;
    const float* rg = pose + RC_G + 3 * i;
    sv[i] = ((rv[0] * v[0] + rv[1] * v[1]) + rv[2] * v[2]) + pose[TC_V + i];
    sg[i] = ((rg[0] * v[0] + rg[1] * v[1]) + rg[2] * v[2]) + pose[TC_G + i];
  }
}

// flat index of the model pixel that the world vertex projects to, or -1
__device__ __forceinline__ int project(const float* __restrict__ pose, const float sv[3], const Geom& g) {
  float d[3], cp[3];
  for (int i = 0; i < 3; ++i) d[i] = sv[i] - pose[TP_V + i];
  for (int i = 0; i < 3; ++i) {
    const float* r = pose + RPI_V + 3 * i;
    cp[i] = (r[0] * d[0] + r[1] * d[1]) + r[2] * d[2];
  }
  const float px = (cp[0] * g.fx) / cp[2] + g.cx;
  const float py = (cp[1] * g.fy) / cp[2] + g.cy;
  const int ux = to_index(rintf(px)), uy = to_index(rintf(py));
  const bool in_img = ux >= 0 && uy >= 0 && ux < g.Wp && uy < g.Hp && cp[2] >= 0.0f;
  return in_img ? uy * g.Wp + ux : -1;
}

__global__ void icp_associate_kernel(const float* __restrict__ vcurr, const float* __restrict__ pose,
                                     int* __restrict__ assoc, Geom g) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= g.n_curr) return;
  const float v[3] = {vcurr[p], vcurr[g.n_curr + p], vcurr[2 * g.n_curr + p]};
  float sv[3], sg[3];
  world_vertex(pose, v, sv, sg);
  assoc[p] = project(pose, sv, g);
}

__global__ void __launch_bounds__(BLOCK)
icp_system_kernel(const float* __restrict__ vcurr, const float* __restrict__ ncurr,
                  const float* __restrict__ vprev_v, const float* __restrict__ vprev_g,
                  const float* __restrict__ nprev_v, const float* __restrict__ nprev_g,
                  const int* __restrict__ assoc, const float* __restrict__ pose, double* partials,
                  unsigned int* ticket, float* __restrict__ out, int* __restrict__ inliers, Geom g) {
  double acc[NQ - 1];
#pragma unroll
  for (int q = 0; q < NQ - 1; ++q) acc[q] = 0.0;
  int count = 0;
  const int n_prev = g.Hp * g.Wp;

  for (int p = blockIdx.x * BLOCK + threadIdx.x; p < g.n_curr; p += gridDim.x * BLOCK) {
    const float nc0 = ncurr[p];
    if (isnan(nc0)) continue;
    const float v[3] = {vcurr[p], vcurr[g.n_curr + p], vcurr[2 * g.n_curr + p]};
    float sv[3], sg[3];
    world_vertex(pose, v, sv, sg);
    const int idx = assoc != nullptr ? assoc[p] : project(pose, sv, g);
    if (idx < 0) continue;

    float nv[3], ng[3], dv[3], dg[3];
    nv[0] = nprev_v[idx];
    if (isnan(nv[0])) continue;
    nv[1] = nprev_v[n_prev + idx];
    nv[2] = nprev_v[2 * n_prev + idx];
    for (int i = 0; i < 3; ++i) dv[i] = vprev_v[i * n_prev + idx];

    // e = d - s; dist = |e|
    float ev[3];
    for (int i = 0; i < 3; ++i) ev[i] = dv[i] - sv[i];
    const float dist = sqrtf((ev[0] * ev[0] + ev[1] * ev[1]) + ev[2] * ev[2]);
    if (!(dist <= g.dist_thres)) continue;

    // sine = |cross(R_curr n_curr, n)|
    const float nc[3] = {nc0, ncurr[g.n_curr + p], ncurr[2 * g.n_curr + p]};
    float m[3];
    for (int i = 0; i < 3; ++i) {
      const float* rv = pose + RC_V + 3 * i;
      m[i] = (rv[0] * nc[0] + rv[1] * nc[1]) + rv[2] * nc[2];
    }
    const float c0 = m[1] * nv[2] - m[2] * nv[1];
    const float c1 = m[2] * nv[0] - m[0] * nv[2];
    const float c2 = m[0] * nv[1] - m[1] * nv[0];
    const float sine = sqrtf((c0 * c0 + c1 * c1) + c2 * c2);
    if (!(sine < g.angle_thres)) continue;

    for (int i = 0; i < 3; ++i) {
      ng[i] = nprev_g[i * n_prev + idx];
      dg[i] = vprev_g[i * n_prev + idx];
    }

    // the dual row J = [cross(s, n), n] and residual r = n . (d - s)
    float jv[6], jg[6];
    for (int i = 0; i < 3; ++i) {
      const int a = (i + 1) % 3, b = (i + 2) % 3;
      jv[i] = sv[a] * nv[b] - sv[b] * nv[a];
      jg[i] = (sg[a] * nv[b] + sv[a] * ng[b]) - (sg[b] * nv[a] + sv[b] * ng[a]);
      jv[3 + i] = nv[i];
      jg[3 + i] = ng[i];
    }
    float eg[3];
    for (int i = 0; i < 3; ++i) eg[i] = dg[i] - sg[i];
    float rv = (nv[0] * ev[0] + nv[1] * ev[1]) + nv[2] * ev[2];
    float rg = ((ng[0] * ev[0] + nv[0] * eg[0]) + (ng[1] * ev[1] + nv[1] * eg[1])) + (ng[2] * ev[2] + nv[2] * eg[2]);

    double Jv[6], Jg[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      Jv[i] = (double)nan_to_num(jv[i]);
      Jg[i] = (double)nan_to_num(jg[i]);
    }
    const double Rv = (double)nan_to_num(rv), Rg = (double)nan_to_num(rg);

    int k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j) {
        acc[k] += Jv[i] * Jv[j];
        acc[NTRI + k] += Jg[i] * Jv[j] + Jv[i] * Jg[j];
        ++k;
      }
      acc[2 * NTRI + i] += Jv[i] * Rv;
      acc[2 * NTRI + 6 + i] += Jg[i] * Rv + Jv[i] * Rg;
    }
    ++count;
  }

  // warp: shuffles; block: shared memory, warps added in order
  __shared__ double warp_sums[WARPS][NQ];
  __shared__ double totals[NQ];
  __shared__ bool is_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double cnt = (double)count;  // exact: far below 2^53
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    double x = q < NQ - 1 ? acc[q] : cnt;
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) warp_sums[warp][q] = x;
  }
  __syncthreads();
  if (threadIdx.x < NQ) {
    double x = 0.0;
    for (int w = 0; w < WARPS; ++w) x += warp_sums[w][threadIdx.x];
    partials[(size_t)blockIdx.x * NQ + threadIdx.x] = x;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the last block adds the blocks' partials: lane l takes blocks l, l + 32,
  // ... in order, then the lanes are added by the same shuffle tree
  const volatile double* all = partials;
  for (int q = warp; q < NQ; q += WARPS) {
    double x = 0.0;
    for (int b = lane; b < (int)gridDim.x; b += 32) x += all[(size_t)b * NQ + q];
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) totals[q] = x;
  }
  __syncthreads();

  // out: A.v (6x6), A.g (6x6), b.v (6), b.g (6)
  if (threadIdx.x < 72) {
    const int lane_g = threadIdx.x / 36, e = threadIdx.x % 36;
    const int i = min(e / 6, e % 6), j = max(e / 6, e % 6);
    const int k = i * 6 - i * (i - 1) / 2 + (j - i);  // row-major upper triangle
    out[threadIdx.x] = (float)totals[lane_g * NTRI + k];
  } else if (threadIdx.x < 84) {
    out[threadIdx.x] = (float)totals[2 * NTRI + (threadIdx.x - 72)];
  } else if (threadIdx.x == 84) {
    *inliers = (int)totals[NQ - 1];
    *ticket = 0u;  // ready for the next launch on this stream
  }
}

Geom make_geom(int Hc, int Wc, int Hp, int Wp, float fx, float fy, float cx, float cy, float dist_thres,
               float angle_thres) {
  return Geom{Hc * Wc, Hp, Wp, fx, fy, cx, cy, dist_thres, angle_thres};
}

}  // namespace

// partials: room for max_blocks * 55 doubles; ticket: one zeroed unsigned int
// that the kernel leaves zeroed. Both belong to one stream at a time.
extern "C" int xs_icp_system(const void* vcurr, const void* ncurr, const void* vprev_v, const void* vprev_g,
                             const void* nprev_v, const void* nprev_g, const void* assoc, const void* pose,
                             void* partials, void* ticket, int max_blocks, void* out, void* inliers, int Hc,
                             int Wc, int Hp, int Wp, float fx, float fy, float cx, float cy, float dist_thres,
                             float angle_thres, void* stream) {
  const Geom g = make_geom(Hc, Wc, Hp, Wp, fx, fy, cx, cy, dist_thres, angle_thres);
  int blocks = (g.n_curr + BLOCK - 1) / BLOCK;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  icp_system_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)vcurr, (const float*)ncurr, (const float*)vprev_v, (const float*)vprev_g,
      (const float*)nprev_v, (const float*)nprev_g, (const int*)assoc, (const float*)pose, (double*)partials,
      (unsigned int*)ticket, (float*)out, (int*)inliers, g);
  return (int)cudaGetLastError();
}

extern "C" int xs_icp_associate(const void* vcurr, const void* pose, void* assoc, int Hc, int Wc, int Hp,
                                int Wp, float fx, float fy, float cx, float cy, void* stream) {
  const Geom g = make_geom(Hc, Wc, Hp, Wp, fx, fy, cx, cy, 0.0f, 0.0f);
  icp_associate_kernel<<<(g.n_curr + BLOCK - 1) / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)vcurr, (const float*)pose, (int*)assoc, g);
  return (int)cudaGetLastError();
}
