// K3: fixed-step ray march over the TSDF value plane.
//
// Replaces the XLA code of xslam_tpu/ops/raycast.py::march (single volume,
// default ShardSpec) and of ::_camera_rays before it; reference
// RayCaster.cu:200-247. Per ray: start at 0.2 m, n_steps = int((5.0 - 0.2) /
// (0.8 trunc)) + 1 steps of 0.8 trunc; each step reads the nearest voxel of
// the value plane + 1e-5 (the reference's read bias, kept) and records the
// march time t_curr of the step's START sample for the first +->- crossing
// (t_found) and the first death (t_dead: a volume exit, or a -->+ step). 1e9
// where no event. With `stride` s > 1 (ops/raycast.py's hierarchical marches)
// it marches the rays of every s-th pixel of the camera in each axis, the
// JAX package's ray_dir[:, ::s, ::s] (xslam_tpu/ops/raycast.py:546-550,
// :570-573): the output is (ceil(H / s), ceil(W / s)) and output pixel (x, y)
// is the ray of camera pixel (s x, s y), made as at stride 1, so it has the
// full march's bits there.
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
// B19b, the march over a slab of the sharded engine (parallel/sharded.py; xslam_tpu/ops/raycast.py::march with
// a ShardSpec): march_shard_kernel reads the value plane of a slab with its halo, whose local x 0 is global
// x x_base; a sample at global voxel g reads local row g - x_base (0 + 1e-5 outside the slab, as gather3d
// fills), is inside where g lies in the x_total-row volume, and records a crossing or a -->+ death only where
// g lies in the slab's core rows [core_start, core_end); an exit from the volume is every slab's death. The
// ranks' events then meet in a min (xslam_tpu/parallel/sharded.py:132-133). march_kernel, the whole
// volume, is the code above unchanged (one body, march_body<SHARD, SLAB_STEPS>, for both).
//
// B19b marches only the steps its slab can own (march_shard_kernel<true>). Each voxel coordinate of a ray's
// samples is a monotone function of the step k (t = 0.2 + (k + 1) step rises with k, s + d t moves one way as
// IEEE rounding is monotone, floor_div is the IEEE quotient's floor), so along a ray three sets of steps are
// each an interval: those inside the whole volume (I), those owned, inside the volume and in the core rows (C),
// and each coordinate's own range. An event other than an exit from the volume lies in C; an exit is the first
// step outside I. So the kernel finds where C starts by a bisection over k a coordinate (a few floor_divs a
// probe, no loads), marches from there (one step early for prev: the read the full loop had there, a halo
// value or 0 + 1e-5) until both events are known or a sample leaves C, and takes the exit death apart: step 0
// where the camera starts outside the volume, else, where no death was met and the march left C inside the
// volume (or C is empty), the first step whose coordinate leaves the volume from there, again by bisection. The
// events are the full loop's: its first crossing and its first death, the minimum of a death met in C and the
// exit. The earlier design, which marches from step 0 until both events are known (every step of a ray whose
// surface lies in another slab), is march_shard_kernel<false>, kept as a test-only entry (xs_march_fixed's shard
// 2): the smoke run holds the two to each other bit for bit and times both in one call. At one rank the slab is
// the whole volume and every step is owned: there the kernel runs K3's body (march_kernel's), the same events,
// where the slab-step body runs 2% slower than the full loop (the slab's sample and the steps' bookkeeping).
//
// K3 at a stride (the hierarchical marches' coarse pass: 76,800 rays at stride 2, 19,200 at stride 4 of a
// 480x640 camera) marches too few rays for a thread a ray to fill the card: 300 / 75 blocks of 256 on 132 SMs,
// each block waiting for its slowest ray. There march_group_kernel<G> gives a ray a group of G lanes (G a power of
// two up to 32, chosen by the wrapper from the number of rays: ops/kernels.py::march_lanes). A round takes G steps,
// lane j step k0 + j, and the serial rule is replayed over them: step k's prev is lane j - 1's sample
// (__shfl_up_sync), lane 0's the last lane's of the round before (the first sample, for step 0); the first
// crossing and the first death are the lowest lanes whose exact tests fire (ballots), and the group's tests stop
// after the round in which both are known. Each step's test reads the numbers K3's loop reads at that step, and
// the march times are the same expressions of k, so the events are K3's bits. Rays lie in image order,
// GROUP_THREADS / G a block; a warp's groups step together until its slowest ray is done (shuffles and ballots
// over the whole warp: with a group's own mask the groups drifted apart and ran one after another, 2 lanes a ray
// 4x slower than one). Blocks of 128 and a step a lane a round were the fastest of 128, 256 threads and 1, 2, 4
// steps a lane read before the tests (the sweep in PERF.md): the G lanes already hold G steps in flight. At G =
// 1 (stride 1 always) the launch is march_kernel, K3's body.
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
constexpr int GROUP_THREADS = 128;  // threads a block of march_group_kernel

struct Volume {
  const float* value;
  int X, Y, Z;
  float vs;
};

// B19b: a slab's place in the whole volume (xslam_tpu/ops/raycast.py::ShardSpec, resolved)
struct Slab {
  int x_base, x_total, core_start, core_end;
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

// the value at the first sample (0.2 m), clamped into the volume (with SHARD into the whole volume, then read
// from the slab: 0 + 1e-5 outside it)
template <bool SHARD>
__device__ __forceinline__ float first_sample(const Volume& vol, const Slab& slab, const float s[3],
                                              const float d[3]) {
  int gx = xs::to_index(floorf((s[0] + d[0] * RAY_MIN) / vol.vs));
  int gy = xs::to_index(floorf((s[1] + d[1] * RAY_MIN) / vol.vs));
  int gz = xs::to_index(floorf((s[2] + d[2] * RAY_MIN) / vol.vs));
  gx = min(max(gx, 0), (SHARD ? slab.x_total : vol.X) - 1);
  gy = min(max(gy, 0), vol.Y - 1);
  gz = min(max(gz, 0), vol.Z - 1);
  if (SHARD) {
    gx -= slab.x_base;
    if ((unsigned)gx >= (unsigned)vol.X) return 0.0f + 1e-5f;
  }
  return __ldg(vol.value + ((long long)gx * vol.Y + gy) * vol.Z + gz) + 1e-5f;
}

// B19b: a sample's voxel g on a slab: `inside` the whole volume, `own` (in the core rows), and the value read
// from local row g - x_base (0 outside the slab) + 1e-5; with IN_C `own` is whether g lies in C: inside the
// volume and in the core rows
template <bool IN_C>
__device__ __forceinline__ float slab_sample(const Volume& vol, const Slab& slab, float inv_vs, const float s[3],
                                             const float d[3], float t, bool& inside, bool& own) {
  const int gx = floor_div(s[0] + d[0] * t, vol.vs, inv_vs);
  const int gy = floor_div(s[1] + d[1] * t, vol.vs, inv_vs);
  const int gz = floor_div(s[2] + d[2] * t, vol.vs, inv_vs);
  const bool in_yz = (unsigned)gy < (unsigned)vol.Y && (unsigned)gz < (unsigned)vol.Z;
  inside = (unsigned)gx < (unsigned)slab.x_total && in_yz;
  if (IN_C) {
    // C's rows [c_lo, c_lo + c_w): one unsigned compare, as inside's (hoisted out of the loop)
    const int c_lo = max(slab.core_start, 0);
    const unsigned c_w = (unsigned)max(min(slab.core_end, slab.x_total) - c_lo, 0);
    own = (unsigned)gx - (unsigned)c_lo < c_w && in_yz;
  } else {
    own = gx >= slab.core_start && gx < slab.core_end;
  }
  const int lx = gx - slab.x_base;
  const bool readable = (unsigned)lx < (unsigned)vol.X && in_yz;
  const unsigned offset = ((unsigned)lx * (unsigned)vol.Y + (unsigned)gy) * (unsigned)vol.Z + (unsigned)gz;
  return (readable ? __ldg(vol.value + offset) : 0.0f) + 1e-5f;
}

// B19b: the voxel coordinate along axis i of step k's sample, as slab_sample computes it
__device__ __forceinline__ int step_coord(const Volume& vol, float inv_vs, const float s[3], const float d[3],
                                          float step, int i, int k) {
  return floor_div(s[i] + d[i] * (RAY_MIN + (float)(k + 1) * step), vol.vs, inv_vs);
}

// B19b: the first step in [lo, hi) at which axis i's coordinate has reached `bound` (up, as it rises with k where
// d[i] > 0: coordinate >= bound; else coordinate < bound), hi where none: a bisection, the predicate monotone in k
__device__ int first_step(const Volume& vol, float inv_vs, const float s[3], const float d[3], float step, int i,
                          bool up, int bound, int lo, int hi) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int g = step_coord(vol, inv_vs, s, d, step, i, mid);
    if (up ? g >= bound : g < bound)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// B19b: the first step of C (owned, inside the volume), n_steps where C is empty. Each axis's range [lo, hi) of
// C's coordinates is an interval of steps, which starts at step 0 where step 0's coordinate g0 lies in it; C,
// their intersection, starts at the latest of their starts if it is not empty, and the sample there tells
// whether it is
__device__ int owned_start(const Volume& vol, const Slab& slab, float inv_vs, const float s[3], const float d[3],
                           float step, const int g0[3], int n_steps) {
  const int lo[3] = {max(slab.core_start, 0), 0, 0};
  const int hi[3] = {min(slab.core_end, slab.x_total), vol.Y, vol.Z};
  int k0 = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const bool up = d[i] > 0.0f;
    if (g0[i] < lo[i] || g0[i] >= hi[i])
      k0 = max(k0, first_step(vol, inv_vs, s, d, step, i, up, up ? lo[i] : hi[i], 0, n_steps));
  }
  if (k0 >= n_steps) return n_steps;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int g = step_coord(vol, inv_vs, s, d, step, i, k0);
    if (g < lo[i] || g >= hi[i]) return n_steps;
  }
  return k0;
}

// B19b: the first step in [from, n_steps) whose sample lies outside the whole volume, for a ray whose steps
// 0 .. from lie inside (each coordinate leaves its range across the bound it moves toward), n_steps where none.
// An axis still in range at the last step is not searched
__device__ int exit_step(const Volume& vol, const Slab& slab, float inv_vs, const float s[3], const float d[3],
                         float step, int from, int n_steps) {
  const int hi[3] = {slab.x_total, vol.Y, vol.Z};
  int e = n_steps;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const bool up = d[i] > 0.0f;
    const int bound = up ? hi[i] : 0, last = step_coord(vol, inv_vs, s, d, step, i, n_steps - 1);
    if (up ? last >= bound : last < bound)
      e = min(e, first_step(vol, inv_vs, s, d, step, i, up, bound, from, n_steps - 1));
  }
  return e;
}

template <bool SHARD, bool SLAB_STEPS>
__device__ __forceinline__ void march_body(const Volume& vol, const float* __restrict__ pose,
                                           float* __restrict__ t_found_out, float* __restrict__ t_dead_out, int H,
                                           int W, int stride, int n_steps, float step, const xs::Camera& cam,
                                           const Slab& slab) {
  static_assert(SHARD || !SLAB_STEPS, "the steps a slab owns: a slab's march");
  __shared__ float c2v[24];
  const int tid = threadIdx.x;
  if (tid < 24) c2v[tid] = pose[xs::POSE_C2V + tid];
  __syncthreads();
  int x, y;
  xs::block_pixel(tid, x, y);
  if (x >= W || y >= H) return;

  xs::Dual dir[3];
  xs::camera_ray(c2v, (float)(x * stride), (float)(y * stride), cam, dir);
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
  int k_first = 0;  // the first step marched
  bool inside_at_0 = true;
  if (SLAB_STEPS) {
    int g[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) g[i] = step_coord(vol, inv_vs, s, d, step, i, 0);
    inside_at_0 = (unsigned)g[0] < (unsigned)slab.x_total && (unsigned)g[1] < (unsigned)vol.Y &&
                  (unsigned)g[2] < (unsigned)vol.Z;
    if (!inside_at_0) t_dead = RAY_MIN + 0.0f * step;  // the camera starts outside: a death at step 0
    const bool owned_at_0 = inside_at_0 && g[0] >= slab.core_start && g[0] < slab.core_end;
    k_first = owned_at_0 ? 0 : owned_start(vol, slab, inv_vs, s, d, step, g, n_steps);
  }
  // where the exit from the volume is still to be found, the step to look from: 0 for a ray that owns no step,
  // else the step at which the march leaves C inside the volume (one whose march leaves C outside dies there,
  // and one that marches to n_steps in C exits past it)
  int exit_from = k_first >= n_steps ? 0 : -1;
  float prev = 0.0f;
  if (k_first == 0) {
    prev = first_sample<SHARD>(vol, slab, s, d);
  } else if (k_first < n_steps) {
    bool inside_prev, own_prev;  // step k_first - 1's read, at the march time of step k_first
    prev = slab_sample<false>(vol, slab, inv_vs, s, d, RAY_MIN + (float)k_first * step, inside_prev, own_prev);
  }
  // the step number as a float (exact; no conversion in the loop), and the
  // march time of the sample before the next one: step k's t_curr is step
  // k - 1's t_next, the same expression
  float kf = (float)k_first, t_last = RAY_MIN + kf * step;
  bool done = false;
  for (int k0 = k_first; k0 < n_steps && !done; k0 += U) {
    float tsdf[U], t_at[U + 1];
    bool inside[U], own[U];
    t_at[0] = t_last;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      kf = kf + 1.0f;
      const float t_next = RAY_MIN + kf * step;
      t_at[j + 1] = t_next;
      if (SHARD) {
        tsdf[j] = slab_sample<SLAB_STEPS>(vol, slab, inv_vs, s, d, t_next, inside[j], own[j]);
      } else {
        unsigned offset;
        inside[j] = sample_voxel_fast(vol, inv_vs, s, d, t_next, offset);
        own[j] = true;
        tsdf[j] = (inside[j] ? __ldg(vol.value + offset) : 0.0f) + 1e-5f;
      }
    }
    t_last = t_at[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      // an event needs a sample outside, or a change of sign: the exact tests run only then (with SLAB_STEPS,
      // where own is C's membership, a sample outside C, which ends the march)
      const bool maybe =
          (SLAB_STEPS ? !own[j] : !inside[j]) || (__float_as_int(prev) ^ __float_as_int(tsdf[j])) < 0;
      if (maybe && !done && k0 + j < n_steps) {
        const float t_curr = t_at[j];
        const bool death = !inside[j] || (own[j] && prev < 0.0f && tsdf[j] > 0.0f);
        const bool crossing = own[j] && inside[j] && prev > 0.0f && tsdf[j] < 0.0f;
        if (crossing && t_curr < t_found) t_found = t_curr;
        if (death && t_curr < t_dead) t_dead = t_curr;
        const bool leaves = SLAB_STEPS && !own[j];
        if (leaves && inside[j]) exit_from = k0 + j;
        done = (t_found < INF_T && t_dead < INF_T) || leaves;
      }
      prev = tsdf[j];
    }
  }
  if (SLAB_STEPS && t_dead >= INF_T && exit_from >= 0) {
    // no death met (so the camera starts inside): the ray's exit from the volume, if within n_steps
    const int e = exit_step(vol, slab, inv_vs, s, d, step, exit_from, n_steps);
    if (e < n_steps) t_dead = RAY_MIN + (float)e * step;
  }
  t_found_out[y * W + x] = t_found;
  t_dead_out[y * W + x] = t_dead;
}

__global__ void __launch_bounds__(xs::BLOCK_W* xs::BLOCK_H)
    march_kernel(Volume vol, const float* __restrict__ pose, float* __restrict__ t_found_out,
                 float* __restrict__ t_dead_out, int H, int W, int stride, int n_steps, float step, xs::Camera cam) {
  march_body<false, false>(vol, pose, t_found_out, t_dead_out, H, W, stride, n_steps, step, cam, Slab{});
}

// K3 at a stride, a group of G lanes a ray (see the header)
template <int G>
__global__ void __launch_bounds__(GROUP_THREADS)
    march_group_kernel(Volume vol, const float* __restrict__ pose, float* __restrict__ t_found_out,
                       float* __restrict__ t_dead_out, int H, int W, int stride, int n_steps, float step,
                       xs::Camera cam) {
  static_assert(G >= 2 && G <= 32 && (G & (G - 1)) == 0 && GROUP_THREADS % 32 == 0, "lanes a ray: 2 to 32");
  constexpr unsigned FULL = 0xffffffffu, LANE_BITS = FULL >> (32 - G);
  __shared__ float c2v[24];
  const int tid = threadIdx.x, j = tid & (G - 1);
  if (tid < 24) c2v[tid] = pose[xs::POSE_C2V + tid];
  __syncthreads();
  // the shuffles and ballots take the whole warp (see the header): a lane past the last ray or of a finished ray
  // takes part without effect
  const int ray = blockIdx.x * (GROUP_THREADS / G) + tid / G;
  const bool real = ray < H * W;
  const unsigned shift = (tid & 31) & ~(G - 1);  // the ray's lanes in the warp's ballots
  const int x = real ? ray % W : 0, y = real ? ray / W : 0;
  xs::Dual dir[3];
  xs::camera_ray(c2v, (float)(x * stride), (float)(y * stride), cam, dir);
  const float s[3] = {c2v[18], c2v[19], c2v[20]};
  const float d[3] = {dir[0].v, dir[1].v, dir[2].v};
  const bool finite =
      isfinite(s[0]) && isfinite(s[1]) && isfinite(s[2]) && isfinite(d[0]) && isfinite(d[1]) && isfinite(d[2]);
  if (real && !finite && j == 0) {  // every sample outside: a death at the first step
    t_found_out[ray] = INF_T;
    t_dead_out[ray] = RAY_MIN + 0.0f * step;
  }
  bool done = !real || !finite;  // the same in every lane of the group
  if (__all_sync(FULL, done)) return;
  const float inv_vs = 1.0f / vol.vs;
  float prev = done ? 0.0f : first_sample<false>(vol, Slab{}, s, d);  // lane 0's prev at the next round
  float t_found = INF_T, t_dead = INF_T;
  for (int k0 = 0; k0 < n_steps && __any_sync(FULL, !done); k0 += G) {
    const int k = k0 + j;
    unsigned offset;
    const bool inside = !done && sample_voxel_fast(vol, inv_vs, s, d, RAY_MIN + (float)(k + 1) * step, offset);
    const float tsdf = (inside ? __ldg(vol.value + offset) : 0.0f) + 1e-5f;
    const float left = __shfl_up_sync(FULL, tsdf, 1, G);  // lane j - 1's sample: step k - 1's
    const float pv = j == 0 ? prev : left;
    const bool live = !done && k < n_steps;
    const bool death = live && (!inside || (pv < 0.0f && tsdf > 0.0f));
    const bool crossing = live && inside && pv > 0.0f && tsdf < 0.0f;
    const unsigned deaths = (__ballot_sync(FULL, death) >> shift) & LANE_BITS;
    const unsigned crossings = (__ballot_sync(FULL, crossing) >> shift) & LANE_BITS;
    if (crossings && t_found >= INF_T) t_found = RAY_MIN + (float)(k0 + __ffs(crossings) - 1) * step;
    if (deaths && t_dead >= INF_T) t_dead = RAY_MIN + (float)(k0 + __ffs(deaths) - 1) * step;
    prev = __shfl_sync(FULL, tsdf, G - 1, G);
    done = done || (t_found < INF_T && t_dead < INF_T);
  }
  if (real && finite && j == 0) {
    t_found_out[ray] = t_found;
    t_dead_out[ray] = t_dead;
  }
}

// B19b: the march over a slab (see the header); SLAB_STEPS false is the earlier design, a test-only entry. A slab
// that is the whole volume (one rank: no halo, every row owned) owns every step, and its march is the whole
// volume's, K3's body, whose sample is cheaper: the same reads, tests and bits
template <bool SLAB_STEPS>
__global__ void __launch_bounds__(xs::BLOCK_W* xs::BLOCK_H)
    march_shard_kernel(Volume vol, const float* __restrict__ pose, float* __restrict__ t_found_out,
                       float* __restrict__ t_dead_out, int H, int W, int stride, int n_steps, float step,
                       xs::Camera cam, Slab slab) {
  if (SLAB_STEPS && slab.x_base == 0 && vol.X == slab.x_total && slab.core_start <= 0 &&
      slab.core_end >= slab.x_total)
    march_body<false, false>(vol, pose, t_found_out, t_dead_out, H, W, stride, n_steps, step, cam, Slab{});
  else
    march_body<true, SLAB_STEPS>(vol, pose, t_found_out, t_dead_out, H, W, stride, n_steps, step, cam, slab);
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
  float prev = first_sample<false>(vol, Slab{}, s, d);
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

// the group march's launch at G lanes a ray
template <int G>
void launch_group(const Volume& vol, const float* pose, float* t_found, float* t_dead, int H, int W, int stride,
                  int n_steps, float step, const xs::Camera& cam, cudaStream_t stream) {
  constexpr int rays = GROUP_THREADS / G;
  march_group_kernel<G><<<(H * W + rays - 1) / rays, GROUP_THREADS, 0, stream>>>(vol, pose, t_found, t_dead, H, W,
                                                                                 stride, n_steps, step, cam);
}

}  // namespace

// H, W: the output's size, the camera's every stride-th pixel in each axis. shard: 0 for the whole (X, Y, Z)
// volume, 1 for a slab of it (B19b: x_base, x_total, core_start, core_end as xslam_tpu/ops/raycast.py::ShardSpec
// resolves them; X the slab's rows with its halo), 2 for a slab by the earlier design (a test-only
// entry: the binding's march_fixed_shard_full). lanes: a ray's lanes over the whole volume, 1 (K3's body) or a
// power of two up to 32 (march_group_kernel)
extern "C" int xs_march_fixed(const void* value, const void* pose, void* t_found, void* t_dead, int X, int Y,
                              int Z, int H, int W, int stride, int n_steps, float vs, float step, float cx, float cy,
                              float inv_fx, float inv_fy, int shard, int x_base, int x_total, int core_start,
                              int core_end, int lanes, void* stream) {
  if ((long long)X * Y * Z >= (1ll << 31) || stride < 1) return (int)cudaErrorInvalidValue;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || (lanes > 1 && shard)) return (int)cudaErrorInvalidValue;
  if (shard && (x_total < 1 || (long long)x_total * Y * Z >= (1ll << 31))) return (int)cudaErrorInvalidValue;
  const Volume vol{(const float*)value, X, Y, Z, vs};
  const xs::Camera cam{cx, cy, inv_fx, inv_fy};
  const Slab slab{x_base, x_total, core_start, core_end};
  const dim3 grid((W + xs::BLOCK_W - 1) / xs::BLOCK_W, (H + xs::BLOCK_H - 1) / xs::BLOCK_H);
  if (shard == 2)
    march_shard_kernel<false><<<grid, xs::BLOCK_W * xs::BLOCK_H, 0, (cudaStream_t)stream>>>(
        vol, (const float*)pose, (float*)t_found, (float*)t_dead, H, W, stride, n_steps, step, cam, slab);
  else if (shard)
    march_shard_kernel<true><<<grid, xs::BLOCK_W * xs::BLOCK_H, 0, (cudaStream_t)stream>>>(
        vol, (const float*)pose, (float*)t_found, (float*)t_dead, H, W, stride, n_steps, step, cam, slab);
  else if (lanes == 1)
    march_kernel<<<grid, xs::BLOCK_W * xs::BLOCK_H, 0, (cudaStream_t)stream>>>(
        vol, (const float*)pose, (float*)t_found, (float*)t_dead, H, W, stride, n_steps, step, cam);
  else {
    void (*run)(const Volume&, const float*, float*, float*, int, int, int, int, float, const xs::Camera&,
                cudaStream_t) = lanes == 2 ? &launch_group<2> : lanes == 4 ? &launch_group<4>
                               : lanes == 8 ? &launch_group<8> : lanes == 16 ? &launch_group<16> : &launch_group<32>;
    run(vol, (const float*)pose, (float*)t_found, (float*)t_dead, H, W, stride, n_steps, step, cam,
        (cudaStream_t)stream);
  }
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
