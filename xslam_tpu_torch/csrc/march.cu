// K3: fixed-step ray march over the TSDF value plane.
//
// Replaces the XLA code of xslam_tpu/ops/raycast.py::march (single volume,
// default ShardSpec) and of ::_camera_rays before it; reference
// RayCaster.cu:200-247. Per ray: start at 0.2 m, n_steps = int((5.0 - 0.2) /
// (0.8 trunc)) + 1 steps of 0.8 trunc; each step reads the nearest voxel of
// the value plane + 1e-5 (the reference's read bias, kept) and records the
// march time t_curr of the step's START sample for the first +->- crossing
// (t_found) and the first death (t_dead: a volume exit, or a -->+ step). 1e9
// where no event.
//
// Bound on the H100: instruction throughput. The bytes are few (the distinct
// voxels the rays touch, 96 bytes of pose in and 8 bytes out per ray) and the
// reads of one ray are not a dependent chain (the sample point of step k is
// start + dir * (0.2 + (k + 1) * step), a function of k alone; only the early
// exit depends on what was read). Measured: with three IEEE divisions, three
// floors and three saturating conversions a sample, more loads in flight (U
// steps at a time, or several rays a thread) and a compact pixel tile a warp
// changed nothing or made it slower, while every instruction taken out of the
// sample made it faster. What the design does:
//
// - floor(p / vs) without the division: q = p * (1 / vs) has the quotient's
//   floor unless an integer lies within 1e-6 |q| of it; only then (one sample
//   in a thousand) the kernel divides (floor_div). The conversion that rounds
//   down gives the index at once; the bounds test is one unsigned compare a
//   coordinate; rays with a NaN or an infinity are set aside before the loop,
//   so the loop needs no to_index.
// - The exact crossing and death tests run only after a sample outside the
//   volume or a change of sign between two samples (two integer operations);
//   the step counter is a float, and a step's t_curr is the step before's
//   t_next, the same expression, so neither is recomputed or converted.
// - The ray is computed in the kernel from the packed dual pose and the
//   intrinsics (rays.cuh), so no direction planes are written or read.
// - The loop takes U steps at a time: U sample addresses, U loads started
//   together, then the tests in step order, stopping after the first step at
//   which both events are known. Loads past that step are bounds-checked,
//   read-only and ignored, so the outputs are those of the one-step loop bit
//   for bit. Once the sample was cheap this gave a few percent at U = 4.
// - A warp owns an 8 x 4 pixel tile, not a 32 x 1 strip (rays.cuh), so its 32
//   samples of one step fall into a compact patch of the volume (a few
//   percent here; a fifth of K5's time, which shares the mapping).
// U = 4 and the tile were the fastest of U = 1, 2, 4, 8 in both mappings.
//
// A ray stops once both events are recorded: no later step can change either,
// so the outputs equal the lockstep march's. The march times and sample
// points are computed one rounding at a time in the reference's order (built
// with -fmad=false), and the voxel chosen at a floor boundary is the one the
// true division p / voxel chooses, as in the reference.
//
// xs_march_fixed_chain is the earlier design (one thread a ray over a flat
// pixel index, direction planes read from memory, three divisions and
// to_index a sample, one load in flight), kept as a test-only entry: the
// smoke run holds the new kernel's outputs against its bits and times both in
// one call.

#include <cuda_runtime.h>

#include "rays.cuh"

namespace {

constexpr float RAY_MIN = 0.2f;
constexpr float INF_T = 1e9f;
constexpr int U = 4;  // march steps taken together

struct Volume {
  const float* value;
  int X, Y, Z;
  float vs;
};

// nearest voxel of `start + dir * t`, and whether it lies in the volume, with
// three IEEE divisions and three to_index: the earlier design's sample
__device__ __forceinline__ bool sample_voxel(const Volume& vol, const float s[3], const float d[3], float t,
                                             long long& offset) {
  const int gx = xs::to_index(floorf((s[0] + d[0] * t) / vol.vs));
  const int gy = xs::to_index(floorf((s[1] + d[1] * t) / vol.vs));
  const int gz = xs::to_index(floorf((s[2] + d[2] * t) / vol.vs));
  offset = ((long long)gx * vol.Y + gy) * vol.Z + gz;
  return gx >= 0 && gx < vol.X && gy >= 0 && gy < vol.Y && gz >= 0 && gz < vol.Z;
}

// floor(p / vs) as an int: the IEEE division's floor, mostly without
// dividing. q = p * (1 / vs) lies within 2e-7 |q| of the rounded quotient, so
// where no integer lies within 1e-6 |q| of q both have the same floor; else
// (about one sample in a thousand), or where q is too small for a relative
// bound, divide. The conversion rounds down and saturates: +-inf and anything
// beyond int32 land outside every volume, as to_index's +-2^30 do. p is not
// NaN here (the kernel sets rays with a NaN aside).
__device__ __forceinline__ int floor_div(float p, float vs, float inv_vs) {
  const float q = p * inv_vs;
  if (fabsf(q - rintf(q)) <= fmaf(fabsf(q), 1e-6f, 1e-30f)) return __float2int_rd(p / vs);
  return __float2int_rd(q);
}

// the same voxel and flag as sample_voxel, for a ray without NaN
__device__ __forceinline__ bool sample_voxel_fast(const Volume& vol, float inv_vs, const float s[3],
                                                  const float d[3], float t, unsigned& offset) {
  const int gx = floor_div(s[0] + d[0] * t, vol.vs, inv_vs);
  const int gy = floor_div(s[1] + d[1] * t, vol.vs, inv_vs);
  const int gz = floor_div(s[2] + d[2] * t, vol.vs, inv_vs);
  // unsigned: a voxel outside may wrap, and is not read; the wrapper keeps the volume under 2^31 voxels
  offset = ((unsigned)gx * (unsigned)vol.Y + (unsigned)gy) * (unsigned)vol.Z + (unsigned)gz;
  return (unsigned)gx < (unsigned)vol.X && (unsigned)gy < (unsigned)vol.Y && (unsigned)gz < (unsigned)vol.Z;
}

// the value at the first sample (0.2 m), clamped into the volume
__device__ __forceinline__ float first_sample(const Volume& vol, const float s[3], const float d[3]) {
  int gx = xs::to_index(floorf((s[0] + d[0] * RAY_MIN) / vol.vs));
  int gy = xs::to_index(floorf((s[1] + d[1] * RAY_MIN) / vol.vs));
  int gz = xs::to_index(floorf((s[2] + d[2] * RAY_MIN) / vol.vs));
  gx = min(max(gx, 0), vol.X - 1);
  gy = min(max(gy, 0), vol.Y - 1);
  gz = min(max(gz, 0), vol.Z - 1);
  return __ldg(vol.value + ((long long)gx * vol.Y + gy) * vol.Z + gz) + 1e-5f;
}

__global__ void __launch_bounds__(xs::BLOCK_W* xs::BLOCK_H)
    march_kernel(Volume vol, const float* __restrict__ pose, float* __restrict__ t_found_out,
                 float* __restrict__ t_dead_out, int H, int W, int n_steps, float step, xs::Camera cam) {
  __shared__ float c2v[24];
  const int tid = threadIdx.x;
  if (tid < 24) c2v[tid] = pose[xs::POSE_C2V + tid];
  __syncthreads();
  int x, y;
  xs::block_pixel(tid, x, y);
  if (x >= W || y >= H) return;

  xs::Dual dir[3];
  xs::camera_ray(c2v, (float)x, (float)y, cam, dir);
  const float s[3] = {c2v[18], c2v[19], c2v[20]};
  const float d[3] = {dir[0].v, dir[1].v, dir[2].v};
  float t_found = INF_T, t_dead = INF_T;

  if (!(isfinite(s[0]) && isfinite(s[1]) && isfinite(s[2]) && isfinite(d[0]) && isfinite(d[1]) &&
        isfinite(d[2]))) {
    // every sample of such a ray is NaN or infinite, so outside: it dies at the first step
    t_found_out[y * W + x] = INF_T;
    t_dead_out[y * W + x] = RAY_MIN + 0.0f * step;
    return;
  }

  const float inv_vs = 1.0f / vol.vs;
  float prev = first_sample(vol, s, d);
  // the step number as a float (exact; no conversion in the loop), and the
  // march time of the sample before the next one: step k's t_curr is step
  // k - 1's t_next, the same expression
  float kf = 0.0f, t_last = RAY_MIN + 0.0f * step;
  bool done = false;
  for (int k0 = 0; k0 < n_steps && !done; k0 += U) {
    float tsdf[U], t_at[U + 1];
    bool inside[U];
    t_at[0] = t_last;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      kf = kf + 1.0f;
      const float t_next = RAY_MIN + kf * step;
      t_at[j + 1] = t_next;
      unsigned offset;
      inside[j] = sample_voxel_fast(vol, inv_vs, s, d, t_next, offset);
      tsdf[j] = (inside[j] ? __ldg(vol.value + offset) : 0.0f) + 1e-5f;
    }
    t_last = t_at[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      // an event needs a sample outside, or a change of sign: the exact tests run only then
      const bool maybe = !inside[j] || (__float_as_int(prev) ^ __float_as_int(tsdf[j])) < 0;
      if (maybe && !done && k0 + j < n_steps) {
        const float t_curr = t_at[j];
        const bool death = !inside[j] || (prev < 0.0f && tsdf[j] > 0.0f);
        const bool crossing = inside[j] && prev > 0.0f && tsdf[j] < 0.0f;
        if (crossing && t_curr < t_found) t_found = t_curr;
        if (death && t_curr < t_dead) t_dead = t_curr;
        done = t_found < INF_T && t_dead < INF_T;
      }
      prev = tsdf[j];
    }
  }
  t_found_out[y * W + x] = t_found;
  t_dead_out[y * W + x] = t_dead;
}

// the earlier design: see the header
__global__ void march_chain_kernel(const float* __restrict__ value, const float* __restrict__ start,
                                   const float* __restrict__ dirs, float* __restrict__ t_found_out,
                                   float* __restrict__ t_dead_out, int X, int Y, int Z, int HW, int n_steps,
                                   float vs, float step) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= HW) return;
  const Volume vol{value, X, Y, Z, vs};
  const float s[3] = {start[0], start[1], start[2]};
  const float d[3] = {dirs[pix], dirs[HW + pix], dirs[2 * HW + pix]};
  float prev = first_sample(vol, s, d);
  float t_found = INF_T, t_dead = INF_T;
  for (int k = 0; k < n_steps; ++k) {
    long long offset;
    const float t_next = RAY_MIN + (float)(k + 1) * step;
    const bool inside = sample_voxel(vol, s, d, t_next, offset);
    const float tsdf = (inside ? __ldg(value + offset) : 0.0f) + 1e-5f;
    const float t_curr = RAY_MIN + (float)k * step;
    const bool death = !inside || (prev < 0.0f && tsdf > 0.0f);
    const bool crossing = inside && prev > 0.0f && tsdf < 0.0f;
    if (crossing && t_curr < t_found) t_found = t_curr;
    if (death && t_curr < t_dead) t_dead = t_curr;
    prev = tsdf;
    if (t_found < INF_T && t_dead < INF_T) break;
  }
  t_found_out[pix] = t_found;
  t_dead_out[pix] = t_dead;
}

}  // namespace

extern "C" int xs_march_fixed(const void* value, const void* pose, void* t_found, void* t_dead, int X, int Y,
                              int Z, int H, int W, int n_steps, float vs, float step, float cx, float cy,
                              float inv_fx, float inv_fy, void* stream) {
  if ((long long)X * Y * Z >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const Volume vol{(const float*)value, X, Y, Z, vs};
  const xs::Camera cam{cx, cy, inv_fx, inv_fy};
  const dim3 grid((W + xs::BLOCK_W - 1) / xs::BLOCK_W, (H + xs::BLOCK_H - 1) / xs::BLOCK_H);
  march_kernel<<<grid, xs::BLOCK_W * xs::BLOCK_H, 0, (cudaStream_t)stream>>>(
      vol, (const float*)pose, (float*)t_found, (float*)t_dead, H, W, n_steps, step, cam);
  return (int)cudaGetLastError();
}

extern "C" int xs_march_fixed_chain(const void* value, const void* start, const void* dirs, void* t_found,
                                    void* t_dead, int X, int Y, int Z, int H, int W, int n_steps, float vs,
                                    float step, void* stream) {
  const int HW = H * W;
  const int block = 256;
  march_chain_kernel<<<(HW + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      (const float*)value, (const float*)start, (const float*)dirs, (float*)t_found, (float*)t_dead, X, Y, Z, HW,
      n_steps, vs, step);
  return (int)cudaGetLastError();
}
