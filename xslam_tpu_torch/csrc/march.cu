// K3: fixed-step ray march over the TSDF value plane.
//
// Replaces the XLA code of xslam_tpu/ops/raycast.py::march (single volume,
// default ShardSpec); reference RayCaster.cu:226-247. Per ray: start at
// 0.2 m, n_steps = int((5.0 - 0.2) / (0.8 trunc)) + 1 steps of 0.8 trunc;
// each step reads the nearest voxel of the value plane + 1e-5 (the
// reference's read bias, kept) and records the march time t_curr of the
// step's START sample for the first +->- crossing (t_found) and the first
// death (t_dead: a volume exit, or a -->+ step). 1e9 where no event.
//
// Bound on the H100: latency. Each ray's reads are a dependent chain of
// scattered 4-byte gathers (few bytes in all: the distinct voxels the rays
// touch, plus 12 bytes in and 8 out per ray). Design: one thread per pixel
// with the step loop inside, reading `value` through the read-only cache
// (__ldg); neighbouring pixels march neighbouring rays, so a warp's gathers
// share cache lines. A ray stops once both events are recorded: no later
// step can change either, so the outputs equal the lockstep march's. The
// march times and sample points are computed one rounding at a time in the
// reference's order (built with -fmad=false), and p / voxel is a true
// division, so the voxel chosen at a floor boundary is the reference's.
// A floored coordinate becomes an index as the plain version's to_index
// makes it (NaN -> -1, clamped to +-2^30), since a bare cast of NaN or of an
// out-of-range float to int is undefined in C++.

#include <cuda_runtime.h>

namespace {

constexpr float RAY_MIN = 0.2f;
constexpr float INF_T = 1e9f;
constexpr float INDEX_LIMIT = 1073741824.0f;  // 2^30

__device__ __forceinline__ int to_index(float floored) {
  if (isnan(floored)) return -1;
  return (int)fminf(fmaxf(floored, -INDEX_LIMIT), INDEX_LIMIT);
}

__global__ void march_kernel(const float* __restrict__ value, const float* __restrict__ start,
                             const float* __restrict__ dirs, float* __restrict__ t_found_out,
                             float* __restrict__ t_dead_out, int X, int Y, int Z, int HW, int n_steps,
                             float vs, float step) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= HW) return;
  const float sx = start[0], sy = start[1], sz = start[2];
  const float dx = dirs[pix], dy = dirs[HW + pix], dz = dirs[2 * HW + pix];

  // first sample at 0.2 m, clamped into the volume
  int gx = to_index(floorf((sx + dx * RAY_MIN) / vs));
  int gy = to_index(floorf((sy + dy * RAY_MIN) / vs));
  int gz = to_index(floorf((sz + dz * RAY_MIN) / vs));
  gx = min(max(gx, 0), X - 1);
  gy = min(max(gy, 0), Y - 1);
  gz = min(max(gz, 0), Z - 1);
  float prev = __ldg(value + ((long long)gx * Y + gy) * Z + gz) + 1e-5f;

  float t_found = INF_T, t_dead = INF_T;
  for (int k = 0; k < n_steps; ++k) {
    const float t_next = RAY_MIN + (float)(k + 1) * step;
    gx = to_index(floorf((sx + dx * t_next) / vs));
    gy = to_index(floorf((sy + dy * t_next) / vs));
    gz = to_index(floorf((sz + dz * t_next) / vs));
    const bool inside = gx >= 0 && gx < X && gy >= 0 && gy < Y && gz >= 0 && gz < Z;
    const float tsdf = (inside ? __ldg(value + ((long long)gx * Y + gy) * Z + gz) : 0.0f) + 1e-5f;
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

extern "C" int xs_march_fixed(const void* value, const void* start, const void* dirs, void* t_found,
                              void* t_dead, int X, int Y, int Z, int H, int W, int n_steps, float vs,
                              float step, void* stream) {
  const int HW = H * W;
  const int block = 256;
  march_kernel<<<(HW + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      (const float*)value, (const float*)start, (const float*)dirs, (float*)t_found, (float*)t_dead, X, Y,
      Z, HW, n_steps, vs, step);
  return (int)cudaGetLastError();
}
