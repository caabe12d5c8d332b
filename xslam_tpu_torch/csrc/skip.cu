// B5: empty-space skipping on the brick rows, for the temporal march's
// refresh frames. B5a, the skip field; B5b, the skip march.
//
// B5a xs_skip_field replaces the XLA code of xslam_tpu/ops/bricks.py::
//   event_brick_mask + distance_grid (brick_distance_rows): each brick's L-inf
//   distance, capped at DIST_CAP, to the once-dilated mask of bricks holding
//   an observed negative voxel (value < 0, weight > 0). jnp.roll wraps across
//   the volume's faces, and so does this: the distance along an axis is the
//   circular one. The dilated mask's distance at b is max(C(b) - 1, 0), C(b)
//   the L-inf distance to the nearest event brick, capped at DIST_CAP: one
//   dilation, then DIST_CAP - 1 more, each one cell. Two kernels in one
//   launch call: the mask (a warp a brick, the two planes' 4 KB read 16 bytes
//   a lane, a ballot), then the distance (a thread a brick over a tile of
//   8 x 8 x 4 bricks, the mask around it staged in shared memory with its
//   DIST_CAP halo, wrapped, and every brick of the 11^3 cube about it read).
//   Plain version: ops/bricks.py::brick_distance_rows. Bound: bytes, the two
//   planes once (134 MB at 256^3).
// B19e xs_event_mask and xs_skip_distance are B5a's two kernels launched
//   apart, for the sharded engine's brick layout: the mask of a rank's slab
//   of rows (plain version: ops/bricks.py::event_brick_mask), then, after the
//   ranks gather the slabs' masks, the distances over the whole grid (plain
//   version: ops/bricks.py::distance_from_event_mask). The slabs are whole
//   bx planes of bricks, so the gathered mask is the whole volume's.
// B5b xs_march_skip replaces the XLA code of xslam_tpu/ops/raycast.py::
//   march_skip over ops/bricks.py::skip_rows (reference RayCaster.cu:
//   226-247 with its early-out). Every `stride`-th pixel of the model maps,
//   the ray made in the kernel (rays.cuh): from 0.2 m, the sample of step k
//   at 0.2 + (k + 1) step reads, where its voxel's brick lies at distance
//   >= 2, the packed rows' JUMP_BASE + dist (+ 1e-5, which leaves it an
//   exact integer: the float32 step at 1000 is 6.1e-5) and jumps max(1,
//   floor((dist - 1) * steps_per_cell)) steps with a positive sentinel as
//   the previous sample; elsewhere the voxel's value + 1e-5 and the fixed
//   march's tests. It stops at its events or the range's end. It reads
//   B5a's distance instead of a 64 MB packed copy of the value rows, so the
//   distance is read once a sample and the value only in the bricks near a
//   surface; the numbers it compares are the packed rows' bit for bit.
//   Plain version: ops/raycast.py::march_skip_plain over ops/bricks.py::
//   pack_rows. Bound: not bytes or operations (60 x 80 rays) but each ray's
//   chain of dependent loads: the next sample's place depends on this one's
//   distance. A warp a ray (LANES lanes) cuts the chain: its lanes read the
//   next LANES steps' samples at once and replay the serial rule over them
//   by ballots and shuffles (march_skip_kernel), so the orbit's longest ray
//   takes 3 rounds for its 61 samples; 1,200 blocks of 4 rays spread over
//   the 132 SMs where a thread a ray made 24 blocks. (PERF.md records the
//   designs measured: a thread a ray in blocks of 256, 64, 32; 4, 8, 16 lanes
//   a ray; the ray set up by every lane or by lane 0.)
// The ray form (march_skip_ray_kernel) is the serial rule itself, a thread a
//   ray, for launches of many rays: at 76,800 or 307,200 rays a warp a ray
//   makes a block of every 4 rays, reads 32 steps a round where a ray takes 35
//   samples on average, and pays three ballots and up to three shuffles a
//   replayed step, while a thread a ray fills the card's ~270,000 resident
//   threads on its own. Its warps own 8 x 4 pixel tiles (rays.cuh::
//   tile_pixel), so a warp's 32 samples of one step fall into few bricks, and
//   each thread makes its own ray. The caller picks the form
//   (ops/raycast.py::skip_ray_form, by the number of rays); both give the
//   serial rule's bits.
//
// B14a and B14b, their dense variants (DENSE: the volume's (X, Y, Z) planes,
// voxel (x * Y + y) * Z + z; rows.cuh::voxel_index<true>), replace the XLA
// code of xslam_tpu/ops/raycast.py::brick_distance_field + skip_volume and
// of ::march_skip over the dense volume (the `skip` march, and `hier_skip`'s
// coarse pass at stride 2, ::march_hier with weight). B14a's mask: a warp a
// brick as above, lane pairs reading a z run of 8 voxels 16 bytes each; the
// distance kernel is the same. The output is the same (NB,) int32 distance,
// in the same brick order: plain version ops/raycast.py::brick_distance_field
// (ops/bricks.py::distance_grid of the dense event mask). B14b reads the
// value plane at the voxel and the distance at its brick; a cell at distance
// >= 2 reads JUMP_BASE + dist + 1e-5, as skip_volume's packed copy + 1e-5
// does, which it does not write (67 MB at 256^3). Plain version: ops/
// raycast.py::march_skip_plain over skip_volume. Bound: as B5a (both planes
// once) and B5b (each ray's chain of dependent loads).
//
// Divisions by a host number are multiplies by the reciprocal taken in
// double, as PyTorch's CUDA operator computes them (built with -fmad=false),
// so the events are the plain version's bits on the card.

#include <cuda_runtime.h>

#include <cstdint>

#include "rays.cuh"
#include "rows.cuh"

namespace {

using xs::Dual;

constexpr float RAY_MIN = 0.2f;
constexpr float INF_T = 1e9f;
constexpr float TAP_BIAS = 1e-5f;
constexpr float JUMP_BASE = 1000.0f;  // ops/bricks.py::JUMP_BASE
constexpr int DIST_CAP = 5;           // ops/bricks.py::DIST_CAP
constexpr int LANES = 32;             // B5b: lanes a ray
constexpr int MARCH_THREADS = 128;    // B5b: a block's threads, 4 rays
// the ray form's block, a ray a thread (a 32 x 4 pixel tile): the fastest of 64, 128 and 256 (PERF.md, B14b)
constexpr int RAY_THREADS = 128;
constexpr int MASK_WARPS = 8;         // bricks of an event_mask block, a warp each
constexpr int TX = 8, TY = 8, TZ = 4;  // bricks of a skip_distance block, a thread each
constexpr int HX = TX + 2 * DIST_CAP, HY = TY + 2 * DIST_CAP, HZ = TZ + 2 * DIST_CAP;

// float4 i (0..127) of brick b: in the rows 16 contiguous bytes of its row; in the dense planes (DENSE) half
// i & 1 of the z run of column i >> 1 (x offset (i >> 1) >> 3, y offset (i >> 1) & 7)
template <bool DENSE>
__device__ __forceinline__ size_t brick_float4(const xs::Rows& r, int b, int i) {
  if (!DENSE) return (size_t)b * xs::BRICK_LANES + 4 * i;
  const int bz = b % r.nbz, by = (b / r.nbz) % r.nby, bx = b / (r.nby * r.nbz), c = i >> 1;
  return ((size_t)(bx * xs::BRICK_EDGE + (c >> 3)) * r.Y + by * xs::BRICK_EDGE + (c & 7)) * r.Z +
         bz * xs::BRICK_EDGE + 4 * (i & 1);
}

template <bool DENSE>
__global__ void __launch_bounds__(32 * MASK_WARPS)
    event_mask_kernel(const float* __restrict__ value, const float* __restrict__ weight,
                      unsigned char* __restrict__ mask, const xs::Rows r, int n) {
  const int b = blockIdx.x * MASK_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (b >= n) return;
  float4 v[4], w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const size_t at = brick_float4<DENSE>(r, b, lane + 32 * q);
    v[q] = __ldg(reinterpret_cast<const float4*>(value + at));
    w[q] = __ldg(reinterpret_cast<const float4*>(weight + at));
  }
  bool any = false;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    any = any || (v[q].x < 0.0f && w[q].x > 0.0f) || (v[q].y < 0.0f && w[q].y > 0.0f) ||
          (v[q].z < 0.0f && w[q].z > 0.0f) || (v[q].w < 0.0f && w[q].w > 0.0f);
  const unsigned hit = __ballot_sync(0xffffffffu, any);
  if (lane == 0) mask[b] = hit != 0u;
}

__device__ __forceinline__ int wrap(int i, int n) { return ((i % n) + n) % n; }

// the same code for both layouts (the mask is in brick order either way); DENSE only names the instantiation, so a
// profile tells B14a's launches from B5a's
template <bool DENSE>
__global__ void __launch_bounds__(TX* TY* TZ)
    skip_distance_kernel(const unsigned char* __restrict__ mask, int* __restrict__ dist, int nbx, int nby, int nbz) {
  __shared__ unsigned char s[HX * HY * HZ];
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY, z0 = blockIdx.z * TZ;
  for (int i = threadIdx.x; i < HX * HY * HZ; i += blockDim.x) {
    const int lz = i % HZ, ly = (i / HZ) % HY, lx = i / (HZ * HY);
    const int gx = wrap(x0 - DIST_CAP + lx, nbx), gy = wrap(y0 - DIST_CAP + ly, nby), gz = wrap(z0 - DIST_CAP + lz, nbz);
    s[i] = mask[(gx * nby + gy) * nbz + gz];
  }
  __syncthreads();
  const int tz = threadIdx.x % TZ, ty = (threadIdx.x / TZ) % TY, tx = threadIdx.x / (TZ * TY);
  const int bx = x0 + tx, by = y0 + ty, bz = z0 + tz;
  if (bx >= nbx || by >= nby || bz >= nbz) return;
  int nearest = DIST_CAP + 1;  // the L-inf distance to the nearest event brick, DIST_CAP + 1 past the cube
  for (int dx = -DIST_CAP; dx <= DIST_CAP; ++dx)
    for (int dy = -DIST_CAP; dy <= DIST_CAP; ++dy) {
      const unsigned char* row = s + ((tx + DIST_CAP + dx) * HY + ty + DIST_CAP + dy) * HZ + tz + DIST_CAP;
      const int dxy = max(abs(dx), abs(dy));
#pragma unroll
      for (int dz = -DIST_CAP; dz <= DIST_CAP; ++dz)
        if (row[dz]) nearest = min(nearest, max(dxy, abs(dz)));
    }
  dist[(bx * nby + by) * nbz + bz] = min(max(nearest - 1, 0), DIST_CAP);
}

struct SkipParams {
  xs::Rows r;
  int H, W, stride, n_steps;
  float vs, inv_vs, step, steps_per_cell;
  xs::Camera cam;
};

// the packed rows' (or with DENSE the packed planes') sample at voxel g: JUMP_BASE + dist in a brick at
// distance >= 2, the value elsewhere; 0 outside the volume; + 1e-5
template <bool DENSE>
__device__ __forceinline__ float packed_sample(const float* __restrict__ value, const int* __restrict__ dist,
                                               const SkipParams& p, const int g[3], bool inside) {
  if (!inside) return 0.0f + TAP_BIAS;
  const unsigned at = xs::voxel_index<DENSE>(p.r, g[0], g[1], g[2]);
  const int d = __ldg(dist + (DENSE ? xs::brick_of(p.r, g[0], g[1], g[2]) : at >> 9));
  return (d >= 2 ? JUMP_BASE + (float)d : __ldg(value + at)) + TAP_BIAS;
}

// the sample of step k (at 0.2 + (k + 1) step) and whether its voxel lies inside the volume
template <bool DENSE>
__device__ __forceinline__ float step_sample(const float* __restrict__ value, const int* __restrict__ dist,
                                             const SkipParams& p, const float s[3], const float d[3], int k,
                                             bool& inside) {
  int g[3];
  xs::sample_voxel(s, d, RAY_MIN + ((float)k + 1.0f) * p.step, p.inv_vs, g);
  inside = xs::in_volume(p.r, g);
  return packed_sample<DENSE>(value, dist, p, g, inside);
}

// the steps a jump from sample c takes: max(1, floor((dist - 1) * steps_per_cell))
__device__ __forceinline__ int jump_steps(float c, const SkipParams& p) {
  return max(1, xs::to_index(floorf(((c - JUMP_BASE) - 1.0f) * p.steps_per_cell)));
}

// the value lane of the ray of pixel (x, y) of the march
__device__ __forceinline__ void ray_direction(const float* c2v, int x, int y, const SkipParams& p, float d[3]) {
  Dual dir[3];
  xs::camera_ray(c2v, (float)(x * p.stride), (float)(y * p.stride), p.cam, dir);
#pragma unroll
  for (int i = 0; i < 3; ++i) d[i] = dir[i].v;
}

// the first sample: its voxel clamped into the volume, capped at 1.0 (packed cells read as free space)
template <bool DENSE>
__device__ __forceinline__ float first_sample(const float* __restrict__ value, const int* __restrict__ dist,
                                              const SkipParams& p, const float s[3], const float d[3]) {
  int g[3];
  xs::sample_voxel(s, d, RAY_MIN, p.inv_vs, g);
  g[0] = min(max(g[0], 0), p.r.X - 1);
  g[1] = min(max(g[1], 0), p.r.Y - 1);
  g[2] = min(max(g[2], 0), p.r.Z - 1);
  return fminf(packed_sample<DENSE>(value, dist, p, g, true), 1.0f);
}

// LANES lanes a ray (a warp), MARCH_THREADS / LANES rays a block, the rays in image order; the block's first warp
// makes its rays' directions, a lane a ray, into shared memory. A round: lane j reads step k0 + j's sample (the
// distance, then the value where the distance is below 2), every read before any test; then the serial rule is
// replayed over the round from position `cur` (0 at a round's start) with the carried `prev`: the lanes from cur
// to the first jumping lane J at or after it are the steps the serial loop visits next in order (prev of a later
// one is its left neighbour's sample), so each tests its own step at once, and the first that ends the ray (a
// crossing, a death, the n_steps stop) is taken by a ballot; else the loop goes on at J's landing (prev 1.0):
// inside the round, the replay goes on from there; past it, the next round starts at that step; with no jumping
// lane it starts at k0 + LANES with prev the last lane's sample. Each step's test reads the numbers the serial
// loop's reads, so the events are its bits.
template <bool DENSE>
__global__ void __launch_bounds__(MARCH_THREADS)
    march_skip_kernel(const float* __restrict__ value, const int* __restrict__ dist, const float* __restrict__ pose,
                      float* __restrict__ t_found_out, float* __restrict__ t_dead_out, const SkipParams p) {
  constexpr int RAYS = MARCH_THREADS / LANES;
  constexpr unsigned LANE_BITS = 0xffffffffu >> (32 - LANES);
  static_assert(LANES >= 2 && LANES <= 32 && (LANES & (LANES - 1)) == 0 && RAYS <= 32 && MARCH_THREADS % 32 == 0,
                "lanes a ray: a power of two up to a warp; the first warp sets up the block's rays");
  __shared__ float c2v[24];
  __shared__ float dirs[RAYS][3];
  const int tid = threadIdx.x, j = tid & (LANES - 1), slot = tid / LANES;
  if (tid < 24) c2v[tid] = pose[xs::POSE_C2V + tid];
  __syncthreads();
  const int n_rays = p.H * p.W, first = blockIdx.x * RAYS, ray = first + slot;
  if (tid < RAYS && first + tid < n_rays) ray_direction(c2v, (first + tid) % p.W, (first + tid) / p.W, p, dirs[tid]);
  __syncthreads();
  if (ray >= n_rays) return;  // the ray's lanes leave together
  const unsigned shift = (tid & 31) & ~(LANES - 1), group = LANE_BITS << shift;  // the ray's lanes in the warp
  const float s[3] = {c2v[18], c2v[19], c2v[20]};
  const float d[3] = {dirs[slot][0], dirs[slot][1], dirs[slot][2]};
  float prev = first_sample<DENSE>(value, dist, p, s, d);
  float t_found = INF_T, t_dead = INF_T;
  for (int k0 = 0;;) {
    const int k = k0 + j;
    bool inside;
    const float c = step_sample<DENSE>(value, dist, p, s, d, k, inside);
    const bool can_jump = inside && c >= JUMP_BASE - 0.5f;
    const int jump = can_jump ? jump_steps(c, p) : 1;
    const float left = __shfl_up_sync(group, c, 1, LANES);  // lane j - 1's sample
    const bool stop = k + 1 >= p.n_steps;
    const unsigned jumpers = (__ballot_sync(group, can_jump) >> shift) & LANE_BITS;
    int cur = 0, next = LANES, event = 0;  // event: 1 a crossing, 2 a death, 3 the stop, at step k0 + next
    for (;;) {
      const float pv = j == cur ? prev : left;
      const bool death = !can_jump && (!inside || (pv < 0.0f && c > 0.0f));
      const bool crossing = !can_jump && inside && pv > 0.0f && c < 0.0f;
      const unsigned after = jumpers & (LANE_BITS << cur);  // cur < LANES
      const int J = after ? __ffs(after) - 1 : LANES;
      const bool visited = j >= cur && j <= J;
      const unsigned ends = (__ballot_sync(group, visited && (crossing || death || stop)) >> shift) & LANE_BITS;
      if (ends) {
        next = __ffs(ends) - 1;
        event = __shfl_sync(group, crossing ? 1 : (death ? 2 : 3), next, LANES);
        break;
      }
      if (J == LANES) {
        prev = __shfl_sync(group, c, LANES - 1, LANES);
        break;
      }
      next = J + __shfl_sync(group, jump, J, LANES);
      prev = 1.0f;
      if (next >= LANES) break;
      cur = next;
    }
    if (event != 0) {
      const float t_curr = RAY_MIN + (float)(k0 + next) * p.step;
      if (event == 1) t_found = t_curr;
      if (event == 2) t_dead = t_curr;
      break;
    }
    k0 += next;
  }
  if (j == 0) {
    t_found_out[ray] = t_found;
    t_dead_out[ray] = t_dead;
  }
}

// The ray form: a thread a ray, the serial rule of ops/raycast.py::march_skip_plain step by step: a crossing, a
// death or the n_steps stop ends the ray; a jumping step moves to its landing with prev 1.0.
template <bool DENSE>
__global__ void __launch_bounds__(RAY_THREADS)
    march_skip_ray_kernel(const float* __restrict__ value, const int* __restrict__ dist,
                          const float* __restrict__ pose, float* __restrict__ t_found_out,
                          float* __restrict__ t_dead_out, const SkipParams p) {
  __shared__ float c2v[24];
  if (threadIdx.x < 24) c2v[threadIdx.x] = pose[xs::POSE_C2V + threadIdx.x];
  __syncthreads();
  int x, y;
  xs::tile_pixel<RAY_THREADS>(threadIdx.x, x, y);
  if (x >= p.W || y >= p.H) return;
  float d[3];
  ray_direction(c2v, x, y, p, d);
  const float s[3] = {c2v[18], c2v[19], c2v[20]};
  float prev = first_sample<DENSE>(value, dist, p, s, d);
  float t_found = INF_T, t_dead = INF_T;
  for (int k = 0;;) {
    bool inside;
    const float c = step_sample<DENSE>(value, dist, p, s, d, k, inside);
    const bool can_jump = inside && c >= JUMP_BASE - 0.5f;
    if (!can_jump) {
      const float t_curr = RAY_MIN + (float)k * p.step;
      if (inside && prev > 0.0f && c < 0.0f) {
        t_found = t_curr;
        break;
      }
      if (!inside || (prev < 0.0f && c > 0.0f)) {
        t_dead = t_curr;
        break;
      }
    }
    if (k + 1 >= p.n_steps) break;
    k += can_jump ? jump_steps(c, p) : 1;
    prev = can_jump ? 1.0f : c;
  }
  t_found_out[y * p.W + x] = t_found;
  t_dead_out[y * p.W + x] = t_dead;
}

cudaError_t launch_event_mask(const void* value, const void* weight, void* mask, const xs::Rows& r, long long n,
                              int dense, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + MASK_WARPS - 1) / MASK_WARPS);
  if (dense)
    event_mask_kernel<true><<<blocks, 32 * MASK_WARPS, 0, s>>>((const float*)value, (const float*)weight,
                                                               (unsigned char*)mask, r, (int)n);
  else
    event_mask_kernel<false><<<blocks, 32 * MASK_WARPS, 0, s>>>((const float*)value, (const float*)weight,
                                                                (unsigned char*)mask, r, (int)n);
  return cudaGetLastError();
}

cudaError_t launch_skip_distance(const void* mask, void* dist, int nbx, int nby, int nbz, int dense,
                                 cudaStream_t s) {
  const dim3 grid((nbx + TX - 1) / TX, (nby + TY - 1) / TY, (nbz + TZ - 1) / TZ);
  if (dense)
    skip_distance_kernel<true><<<grid, TX * TY * TZ, 0, s>>>((const unsigned char*)mask, (int*)dist, nbx, nby, nbz);
  else
    skip_distance_kernel<false><<<grid, TX * TY * TZ, 0, s>>>((const unsigned char*)mask, (int*)dist, nbx, nby, nbz);
  return cudaGetLastError();
}

bool misaligned(const void* a, const void* b) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 != 0;
}

}  // namespace

// value, weight: the (NB, 512) brick rows or, with dense, the (X, Y, Z) planes of the same grid, 16-byte aligned;
// mask: NB bytes of scratch; dist: NB int32 out
extern "C" int xs_skip_field(const void* value, const void* weight, void* mask, void* dist, int nbx, int nby, int nbz,
                             int dense, void* stream) {
  const long long n = (long long)nbx * nby * nbz;
  if (nbx < 1 || nby < 1 || nbz < 1 || n * xs::BRICK_LANES >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (misaligned(value, weight)) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = launch_event_mask(value, weight, mask, xs::make_rows(nbx, nby, nbz), n, dense, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_skip_distance(mask, dist, nbx, nby, nbz, dense, s);
}

// B19e, B5a's two kernels apart for the sharded engine (xslam_tpu/parallel/sharded.py:313-318): the event mask of
// a slab's n brick rows (value, weight: (n, 512), 16-byte aligned; mask: n bytes out), which the ranks gather ...
extern "C" int xs_event_mask(const void* value, const void* weight, void* mask, int n, void* stream) {
  if (n < 1 || (long long)n * xs::BRICK_LANES >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (misaligned(value, weight)) return (int)cudaErrorMisalignedAddress;
  return (int)launch_event_mask(value, weight, mask, xs::make_rows(n, 1, 1), n, 0, (cudaStream_t)stream);
}

// ... and the distances over the gathered mask of the whole (nbx, nby, nbz) grid, wrapped at its faces (mask: NB
// bytes; dist: NB int32 out): together B5a's distances bit for bit
extern "C" int xs_skip_distance(const void* mask, void* dist, int nbx, int nby, int nbz, void* stream) {
  if (nbx < 1 || nby < 1 || nbz < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_skip_distance(mask, dist, nbx, nby, nbz, 0, (cudaStream_t)stream);
}

// value: the (NB, 512) value rows or, with dense, the (X, Y, Z) value plane; dist: skip_field's (NB,) distances;
// pose: the 48 packed floats; t_found, t_dead: (H, W), the march's every stride-th pixel of the camera; form: 0 a
// warp a ray, 1 a thread a ray
extern "C" int xs_march_skip(const void* value, const void* dist, const void* pose, void* t_found, void* t_dead,
                             int nbx, int nby, int nbz, int H, int W, int stride, int n_steps, float vs, float inv_vs,
                             float step, float steps_per_cell, float cx, float cy, float inv_fx, float inv_fy,
                             int dense, int form, void* stream) {
  const long long voxels = (long long)nbx * nby * nbz * xs::BRICK_LANES;
  if (voxels >= (1ll << 31) || H < 1 || W < 1 || stride < 1 || n_steps < 1 || form < 0 || form > 1)
    return (int)cudaErrorInvalidValue;
  const SkipParams p{xs::make_rows(nbx, nby, nbz), H, W, stride, n_steps, vs, inv_vs, step, steps_per_cell,
                     xs::Camera{cx, cy, inv_fx, inv_fy}};
  const cudaStream_t s = (cudaStream_t)stream;
  if (form == 1) {
    const dim3 grid = xs::tile_grid<RAY_THREADS>(H, W);
    if (dense)
      march_skip_ray_kernel<true><<<grid, RAY_THREADS, 0, s>>>((const float*)value, (const int*)dist,
                                                               (const float*)pose, (float*)t_found, (float*)t_dead, p);
    else
      march_skip_ray_kernel<false><<<grid, RAY_THREADS, 0, s>>>((const float*)value, (const int*)dist,
                                                                (const float*)pose, (float*)t_found, (float*)t_dead,
                                                                p);
    return (int)cudaGetLastError();
  }
  constexpr int RAYS = MARCH_THREADS / LANES;
  const unsigned blocks = (unsigned)((H * W + RAYS - 1) / RAYS);
  if (dense)
    march_skip_kernel<true><<<blocks, MARCH_THREADS, 0, s>>>((const float*)value, (const int*)dist,
                                                             (const float*)pose, (float*)t_found, (float*)t_dead, p);
  else
    march_skip_kernel<false><<<blocks, MARCH_THREADS, 0, s>>>((const float*)value, (const int*)dist,
                                                              (const float*)pose, (float*)t_found, (float*)t_dead, p);
  return (int)cudaGetLastError();
}
