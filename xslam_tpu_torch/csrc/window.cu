// B4: the anchored window march over the brick rows, with the `reuse` refine
// fused after it. (B4n, the screen normals of its vertex map, is computed in
// K6's launch: maps.cu.)
//
// B4 replaces the XLA code of xslam_tpu/ops/raycast.py::_window_repair
// (return_samples) and ::march_temporal's 2x2 min-pool, and of
// ::refine_from_samples through ops/raycast_bricks.py::trilinear_pair_bricks;
// reference RayCaster.cu:226-304. Plain version:
// xslam_tpu_torch/ops/raycast_bricks.py::window_march on CPU tensors.
//
// Per pixel of the march (every `stride`-th pixel of the model maps, its ray
// made in the kernel from the packed dual pose, rays.cuh):
//   the anchor: the earliest event of its 2x2 neighbourhood one level up,
//   from the coarse hits (min(t_found, t_dead)) or from an anchor map at the
//   march's own size, min-pooled 2x2 with non-finite entries as none (1e9);
//   snapped to the global march grid one step early, k0 = max(floor((t0 -
//   0.2) / step) - 1, 0);
//   `window` steps from there, each reading the nearest voxel + 1e-5 (0 + 1e-5
//   outside the volume); the first +->- crossing with its two samples and
//   the first death (an exit, or a -->+ step), as the lockstep loop records
//   them; a ray stops once both are known or its t passes 5 m, after which no
//   step can change them (here: after the round of steps in which that
//   happens).
// With the refine (stride 1): the secant of the two samples, one dual
// trilinear F at its root (the value and derivative planes, K5's cell rule,
// brick addressing), the gate |F| <= -slope * step, the dual vertex moved to
// the world, NaN value and zero derivative where rejected; and t_found.
// Without it: t_found and t_dead (the refresh's half level).
//
// B14c, the dense window repair (window_dense_kernel), replaces the XLA code
// of xslam_tpu/ops/raycast.py::_window_repair over the dense volume, as
// ::march_hier (:518, with and without weight) and ::march_hier2 (:555) call
// it: anchors from the coarse hits, strides 1 and 2, no refine (the dense
// layout refines with K5). It is B4's march without the refine and the brick
// rows: a thread a ray on 8 x 4 pixel tiles, blocks of WINDOW_THREADS, the
// (X, Y, Z) value plane (rows.cuh::voxel_index<true>), BATCH steps read
// before they are tested, until both events are known. Without the refine
// it takes 32 registers a thread where B4's body takes 48, so an SM holds 64
// warps where it held 40, and that is what held the launch: reading the
// whole window in one round (64 registers) ran 36% slower than B4's body, and
// 2 or 4 lanes a ray lost too (PERF.md holds the sweep). Plain version:
// ops/raycast.py::_window_repair with the dense reader. Bound: the coarse
// hits in, both times out, the distinct voxels its samples read.
//
// B16, the first-event variant (window_march_kernel<false, true>: the brick
// rows, an anchor map), replaces the XLA code of
// xslam_tpu/ops/raycast.py::march_temporal_compact (raycast_temporal_phase1 >
// 0): the same anchors and samples, each ray stopping at its first event (a
// crossing, taken with its two samples, or a death), at the window's end or
// past 5 m. The JAX function's phases and survivor buffer schedule the TPU's
// lockstep and change no ray's events; here a thread marches its ray alone.
// A round's reads are B4's; its tests stop at the first event. With the
// `reuse` refine (f0, f1 at the crossing) or without it (t_found, t_dead for
// K5r). Plain version: xslam_tpu_torch/ops/raycast.py::march_temporal_compact.
//
// Every operation follows the plain version one rounding at a time (built
// with -fmad=false): a division by a host number (p / voxel, (t - 0.2) /
// step, (f1 - f0) / step) is a multiply by its reciprocal taken in double, as
// PyTorch's CUDA operator computes it, and the march times are t_begin + k *
// step in float32, so the outputs are the plain version's bits on the card.
//
// Bound on the H100: not bytes (240 x 320 rays read a few MB, mostly from
// L2) but each ray's chain of dependent loads (the anchors, the window's
// samples, the refine's taps) and the work of a ray (its dual camera ray, the
// secant, the trilinear, the vertex: some hundreds of instructions) spread
// over too few warps. A thread marches a ray; it reads the window's steps in
// rounds of BATCH, every read of a round before any test, and tests them in
// order, so a round's loads are in flight together; the events are the
// serial loop's (each step's test reads its own two samples; the loop keeps
// the earliest step of each kind). A warp is an 8 x 4 pixel tile so that
// neighbouring rays share sectors, a block WINDOW_THREADS threads, 4 warps
// along a row: 600 blocks at 240 x 320 spread over the 132 SMs more evenly
// than 300 of 256. Nothing is staged: the reads are few. (PERF.md records
// the other designs measured on the card: one read a step, 2 or 4 lanes a
// ray sharing the window, other block sizes.)

#include <cuda_runtime.h>

#include <cstdint>

#include "rays.cuh"
#include "rows.cuh"

namespace {

using xs::Dual;
using xs::lift;

constexpr float RAY_MIN = 0.2f;
constexpr float RAY_MAX = 5.0f;
constexpr float INF_T = 1e9f;
constexpr float TAP_BIAS = 1e-5f;  // readTsdf's bias (RayCaster.cu:77)
constexpr int WINDOW_THREADS = 128;  // a block's threads
constexpr int BATCH = 4;                                   // steps a ray reads before it tests them
constexpr int NO_STEP = 0x7fffffff;

struct WindowParams {
  xs::Rows r;
  int H, W;    // the march's pixels
  int ch, cw;  // the coarse hits' size, or the pooled anchor map's halves
  int stride, window;
  float vs, inv_vs, step, inv_step;
  xs::Camera cam;
};

// the earliest event of coarse pixel (i, j): INF_T past the coarse grid (the reference pads its 2x2 minimum so)
__device__ __forceinline__ float coarse_event(const float* __restrict__ anchor, const float* __restrict__ dead,
                                              int i, int j, const WindowParams& p) {
  if (i >= p.ch || j >= p.cw) return INF_T;
  if (dead != nullptr) return fminf(__ldg(anchor + i * p.cw + j), __ldg(dead + i * p.cw + j));
  float m = INF_T;  // min(pooled, INF_T): the pooled map's t_dead is INF_T
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float t = __ldg(anchor + (2 * i + a) * p.W + 2 * j + b);
      m = fminf(m, isfinite(t) ? t : INF_T);
    }
  return m;
}

template <bool DENSE>
__device__ __forceinline__ float read_voxel(const float* __restrict__ value, const xs::Rows& r, const int g[3],
                                            bool inside) {
  return (inside ? __ldg(value + xs::voxel_index<DENSE>(r, g[0], g[1], g[2])) : 0.0f) + TAP_BIAS;
}

// ops/raycast.py::trilinear_tsdf_shard's cell at one point (K5's rule): the base shifted down below the voxel
// centre, the bounds test on the unshifted index, the weights w1 of the base and w0 of its +1 neighbour
struct Cell {
  int b[3];
  bool ok;
  Dual w0[3], w1[3];
};

__device__ __forceinline__ Cell cell_at(const WindowParams& p, const Dual pt[3]) {
  Cell c;
  const int size[3] = {p.r.X, p.r.Y, p.r.Z};
  c.ok = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    int g = xs::to_index(floorf(pt[i].v * p.inv_vs));
    c.ok = c.ok && g > 0 && g < size[i] - 1;
    g -= (pt[i].v < ((float)g + 0.5f) * p.vs) ? 1 : 0;
    c.b[i] = g;
    c.w0[i] = pt[i] * lift(p.inv_vs) - lift((float)g + 0.5f);
    c.w1[i] = lift(1.0f) - c.w0[i];
  }
  return c;
}

// the dual trilinear at a cell inside the volume: eight taps (value + 1e-5, grad) of the brick rows (or the
// dense planes), weighted and added in the plain version's order, the first not added to 0
template <bool DENSE>
__device__ __forceinline__ Dual trilinear(const float* __restrict__ value, const float* __restrict__ grad,
                                          const WindowParams& p, const Cell& c) {
  Dual tap[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const unsigned at = xs::voxel_index<DENSE>(p.r, c.b[0] + (k >> 2), c.b[1] + ((k >> 1) & 1), c.b[2] + (k & 1));
    tap[k] = {__ldg(value + at) + TAP_BIAS, __ldg(grad + at)};
  }
  Dual res = tap[0] * ((c.w1[0] * c.w1[1]) * c.w1[2]);
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    const Dual& wx = (k >> 2) ? c.w0[0] : c.w1[0];
    const Dual& wy = ((k >> 1) & 1) ? c.w0[1] : c.w1[1];
    const Dual& wz = (k & 1) ? c.w0[2] : c.w1[2];
    res = res + tap[k] * ((wx * wy) * wz);
  }
  return res;
}

// one (3,) map entry: nan_to_num'ed numbers where ok, else (NaN, 0)
__device__ __forceinline__ void store3(float* __restrict__ out_v, float* __restrict__ out_g, int HW, int pix,
                                       bool ok, const Dual m[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out_v[i * HW + pix] = ok ? xs::nan_to_num(m[i].v) : xs::quiet_nan();
    out_g[i * HW + pix] = ok ? xs::nan_to_num(m[i].g) : 0.0f;
  }
}

template <bool DENSE, bool FIRST>
__global__ void __launch_bounds__(WINDOW_THREADS)
    window_march_kernel(const float* __restrict__ value, const float* __restrict__ grad,
                        const float* __restrict__ pose, const float* __restrict__ anchor,
                        const float* __restrict__ anchor_dead, float* __restrict__ vmap_v, float* __restrict__ vmap_g,
                        float* __restrict__ t_found_out, float* __restrict__ t_dead_out, const WindowParams p) {
  __shared__ float sp[xs::POSE_FLOATS];
  const int tid = threadIdx.x;
  if (tid < xs::POSE_FLOATS) sp[tid] = pose[tid];
  __syncthreads();
  int x, y;
  xs::tile_pixel<WINDOW_THREADS>(tid, x, y);
  if (x >= p.W || y >= p.H) return;
  const int pix = y * p.W + x;
  const float* c2v = sp + xs::POSE_C2V;

  // the anchor: the earliest event of the 2x2 coarse neighbourhood, on the global grid one step early
  const int i0 = y >> 1, j0 = x >> 1;
  const float t0 = fminf(fminf(coarse_event(anchor, anchor_dead, i0, j0, p), coarse_event(anchor, anchor_dead, i0 + 1, j0, p)),
                         fminf(coarse_event(anchor, anchor_dead, i0, j0 + 1, p),
                               coarse_event(anchor, anchor_dead, i0 + 1, j0 + 1, p)));
  const bool has_anchor = t0 < INF_T;
  const float k0 = fmaxf(floorf(((has_anchor ? t0 : RAY_MIN) - RAY_MIN) * p.inv_step) - 1.0f, 0.0f);
  const float t_begin = RAY_MIN + k0 * p.step;

  Dual dir[3];
  xs::camera_ray(c2v, (float)(x * p.stride), (float)(y * p.stride), p.cam, dir);
  const float s[3] = {c2v[18], c2v[19], c2v[20]};
  const float d[3] = {dir[0].v, dir[1].v, dir[2].v};

  int kc = NO_STEP, kd = NO_STEP;  // the ray's first crossing and first death, by step
  float f0 = 1.0f, f1 = -1.0f;
  if (has_anchor) {
    // step 0's prev: the read at the clamped voxel of t_begin
    int g[3];
    xs::sample_voxel(s, d, t_begin, p.inv_vs, g);
    g[0] = min(max(g[0], 0), p.r.X - 1);
    g[1] = min(max(g[1], 0), p.r.Y - 1);
    g[2] = min(max(g[2], 0), p.r.Z - 1);
    float prev = read_voxel<DENSE>(value, p.r, g, true);
    bool stop = false;  // FIRST: the ray's first event is known
    // the reference's loop condition is on t_curr (RayCaster.cu:236): past 5 m no step is live again
    for (int base = 0; base < p.window && t_begin + (float)base * p.step < RAY_MAX; base += BATCH) {
      float smp[BATCH];
      bool live[BATCH], inside[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {  // every read of the round, before any test
        const int k = base + j;
        const float t_curr = t_begin + (float)k * p.step;
        xs::sample_voxel(s, d, t_curr + p.step, p.inv_vs, g);
        live[j] = k < p.window && t_curr < RAY_MAX;
        inside[j] = xs::in_volume(p.r, g);
        smp[j] = read_voxel<DENSE>(value, p.r, g, live[j] && inside[j]);
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int k = base + j;
        const float tsdf = smp[j];
        if (live[j]) {
          const bool death = !inside[j] || (prev < 0.0f && tsdf > 0.0f);
          const bool crossing = inside[j] && prev > 0.0f && tsdf < 0.0f;
          if (crossing && kc == NO_STEP) {
            kc = k;
            f0 = prev;
            f1 = tsdf;
          }
          if (death && kd == NO_STEP) kd = k;
          if (FIRST && (crossing || death)) {
            stop = true;
            break;
          }
        }
        prev = tsdf;
      }
      if (stop || (kc != NO_STEP && kd != NO_STEP)) break;  // no later step changes either
    }
  }
  // the step's t_curr, as the serial loop recorded it
  const float t_found = kc != NO_STEP ? t_begin + (float)kc * p.step : INF_T;
  const float t_dead = kd != NO_STEP ? t_begin + (float)kd * p.step : INF_T;
  t_found_out[pix] = t_found;
  if (vmap_v == nullptr) {
    t_dead_out[pix] = t_dead;
    return;
  }

  // the reuse refine (ops/raycast.py::refine_from_samples)
  const int HW = p.H * p.W;
  const Dual none[3] = {lift(0.0f), lift(0.0f), lift(0.0f)};
  const bool accept = t_found < fminf(t_dead, INF_T);
  const bool ok0 = accept && f1 < f0;
  if (!ok0) {
    store3(vmap_v, vmap_g, HW, pix, false, none);
    return;
  }
  const float slope = (f1 - f0) * p.inv_step;  // < 0 on a crossing
  const float ts0 = t_found - f0 / slope;
  Dual start[3], pt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    start[i] = {c2v[18 + i], c2v[21 + i]};
    pt[i] = start[i] + dir[i] * lift(ts0);
  }
  const Cell c = cell_at(p, pt);
  const Dual F = c.ok ? trilinear<DENSE>(value, grad, p, c) : Dual{xs::quiet_nan(), 0.0f};
  const bool ok = !isnan(F.v) && fabsf(F.v) <= -slope * p.step;
  if (!ok) {
    store3(vmap_v, vmap_g, HW, pix, false, none);
    return;
  }
  const Dual ts = {ts0 - F.v / slope, -F.g / slope};
  const float* v2w = sp + xs::POSE_V2W;
  Dual vertex[3], vertex_w[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) vertex[i] = start[i] + dir[i] * ts;
  xs::matvec3(v2w, vertex, vertex_w);
#pragma unroll
  for (int i = 0; i < 3; ++i) vertex_w[i] = vertex_w[i] + Dual{v2w[18 + i], v2w[21 + i]};
  store3(vmap_v, vmap_g, HW, pix, true, vertex_w);
}

// B14c's anchor: the earliest event of pixel (x, y)'s 2x2 coarse neighbourhood, and t_begin on the global grid one
// step early; false where the neighbourhood has none
__device__ __forceinline__ bool dense_begin(const float* __restrict__ anchor, const float* __restrict__ dead, int x,
                                            int y, const WindowParams& p, float& t_begin) {
  const int i0 = y >> 1, j0 = x >> 1;
  const float t0 = fminf(fminf(coarse_event(anchor, dead, i0, j0, p), coarse_event(anchor, dead, i0 + 1, j0, p)),
                         fminf(coarse_event(anchor, dead, i0, j0 + 1, p),
                               coarse_event(anchor, dead, i0 + 1, j0 + 1, p)));
  const bool has_anchor = t0 < INF_T;
  const float k0 = fmaxf(floorf(((has_anchor ? t0 : RAY_MIN) - RAY_MIN) * p.inv_step) - 1.0f, 0.0f);
  t_begin = RAY_MIN + k0 * p.step;
  return has_anchor;
}

// the value at the clamped voxel of t_begin: step 0's prev
__device__ __forceinline__ float dense_first(const float* __restrict__ value, const WindowParams& p,
                                             const float s[3], const float d[3], float t_begin) {
  int g[3];
  xs::sample_voxel(s, d, t_begin, p.inv_vs, g);
  g[0] = min(max(g[0], 0), p.r.X - 1);
  g[1] = min(max(g[1], 0), p.r.Y - 1);
  g[2] = min(max(g[2], 0), p.r.Z - 1);
  return read_voxel<true>(value, p.r, g, true);
}

// B14c: a thread a ray; prev, then rounds of BATCH steps, each read before any test and tested in order (see
// the header)
__global__ void __launch_bounds__(WINDOW_THREADS)
    window_dense_kernel(const float* __restrict__ value, const float* __restrict__ pose,
                        const float* __restrict__ anchor, const float* __restrict__ anchor_dead,
                        float* __restrict__ t_found_out, float* __restrict__ t_dead_out, const WindowParams p) {
  __shared__ float c2v[24];
  const int tid = threadIdx.x;
  if (tid < 24) c2v[tid] = pose[xs::POSE_C2V + tid];
  __syncthreads();
  int x, y;
  xs::tile_pixel<WINDOW_THREADS>(tid, x, y);
  if (x >= p.W || y >= p.H) return;
  float t_begin;
  const bool has_anchor = dense_begin(anchor, anchor_dead, x, y, p, t_begin);
  int kc = NO_STEP, kd = NO_STEP;  // the ray's first crossing and first death, by step
  if (has_anchor) {
    Dual dir[3];
    xs::camera_ray(c2v, (float)(x * p.stride), (float)(y * p.stride), p.cam, dir);
    const float s[3] = {c2v[18], c2v[19], c2v[20]};
    const float d[3] = {dir[0].v, dir[1].v, dir[2].v};
    float prev = dense_first(value, p, s, d, t_begin);
    for (int base = 0; base < p.window && t_begin + (float)base * p.step < RAY_MAX; base += BATCH) {
      float smp[BATCH];
      unsigned live = 0u, inside = 0u;
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {  // every read of the round, before any test
        const int k = base + j;
        const float t_curr = t_begin + (float)k * p.step;
        int g[3];
        xs::sample_voxel(s, d, t_curr + p.step, p.inv_vs, g);
        const bool lv = k < p.window && t_curr < RAY_MAX, in = xs::in_volume(p.r, g);
        live |= (unsigned)lv << j;
        inside |= (unsigned)in << j;
        smp[j] = read_voxel<true>(value, p.r, g, lv && in);
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const float tsdf = smp[j];
        if ((live >> j) & 1u) {
          const bool in = (inside >> j) & 1u;
          if (in && prev > 0.0f && tsdf < 0.0f && kc == NO_STEP) kc = base + j;
          if ((!in || (prev < 0.0f && tsdf > 0.0f)) && kd == NO_STEP) kd = base + j;
        }
        prev = tsdf;
      }
      if (kc != NO_STEP && kd != NO_STEP) break;  // no later step changes either
    }
  }
  const int pix = y * p.W + x;
  t_found_out[pix] = kc != NO_STEP ? t_begin + (float)kc * p.step : INF_T;
  t_dead_out[pix] = kd != NO_STEP ? t_begin + (float)kd * p.step : INF_T;
}

}  // namespace

// value, grad: the (NB, 512) brick rows or, with dense, the (X, Y, Z) planes of the same grid; pose: the 48
// packed floats; anchor, anchor_dead: the coarse (ch, cw) hits, or anchor_dead null and anchor the (H, W) map to
// pool (ch = H / 2, cw = W / 2); vmap_v, vmap_g: the (3, H, W) refine outputs, or null for none (then t_dead is
// written); t_found, t_dead: (H, W); dense: the (X, Y, Z) planes (B14c: coarse hits, no refine); first_event:
// B16 (rows, an anchor map)
extern "C" int xs_window_march(const void* value, const void* grad, const void* pose, const void* anchor,
                               const void* anchor_dead, void* vmap_v, void* vmap_g, void* t_found, void* t_dead,
                               int nbx, int nby, int nbz, int H, int W, int ch, int cw, int stride, int window,
                               float vs, float inv_vs, float step, float inv_step, float cx, float cy, float inv_fx,
                               float inv_fy, int dense, int first_event, void* stream) {
  const long long voxels = (long long)nbx * nby * nbz * xs::BRICK_LANES;
  if (voxels >= (1ll << 31) || H < 1 || W < 1 || stride < 1 || window < 0) return (int)cudaErrorInvalidValue;
  if ((vmap_v == nullptr) != (vmap_g == nullptr) || (vmap_v == nullptr && t_dead == nullptr))
    return (int)cudaErrorInvalidValue;
  if (2 * ch < H || 2 * cw < W) return (int)cudaErrorInvalidValue;
  // B16 takes an anchor map on the brick rows; B14c coarse hits, no refine
  if (first_event && (dense || anchor_dead != nullptr)) return (int)cudaErrorInvalidValue;
  if (dense && (anchor_dead == nullptr || vmap_v != nullptr)) return (int)cudaErrorInvalidValue;
  const WindowParams p{xs::make_rows(nbx, nby, nbz), H, W, ch, cw, stride, window, vs, inv_vs, step, inv_step,
                       xs::Camera{cx, cy, inv_fx, inv_fy}};
  const dim3 grid = xs::tile_grid<WINDOW_THREADS>(H, W);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* v = (const float*)value;
  const float* gr = (const float*)grad;
  const float* po = (const float*)pose;
  const float* an = (const float*)anchor;
  const float* ad = (const float*)anchor_dead;
  if (dense)
    window_dense_kernel<<<xs::tile_grid<WINDOW_THREADS>(H, W), WINDOW_THREADS, 0, s>>>(v, po, an, ad, (float*)t_found,
                                                                                    (float*)t_dead, p);
  else if (first_event)
    window_march_kernel<false, true><<<grid, WINDOW_THREADS, 0, s>>>(
        v, gr, po, an, ad, (float*)vmap_v, (float*)vmap_g, (float*)t_found, (float*)t_dead, p);
  else
    window_march_kernel<false, false><<<grid, WINDOW_THREADS, 0, s>>>(
        v, gr, po, an, ad, (float*)vmap_v, (float*)vmap_g, (float*)t_found, (float*)t_dead, p);
  return (int)cudaGetLastError();
}
