// K5: dual secant refinement of the march's hits, TSDF central-difference
// normals and the maps' NaN sentinels, one launch for the whole image.
//
// Replaces the XLA code of xslam_tpu/ops/raycast.py::refine (`secant2`,
// normals_mode="tsdf", scalar taps through trilinear_tsdf_shard) and
// ::finalize_maps; reference RayCaster.cu:90-160 (interpolateTrilinearly),
// :250-300 (the secant step, the vertex, the normal). Plain version:
// xslam_tpu_torch/ops/raycast.py::refine + finalize_maps.
//
// Per pixel, from t_found and t_dead of K3, both planes of the volume, the
// ray (rays.cuh) and the dual volume->world pose:
//   accept = t_found < min(t_dead, 1e9);
//   Ft, Ftdt: dual trilinear TSDF at t and t + step; the gates (neither NaN,
//   Ft >= 0, Ftdt <= 0, Ftdt != Ft); Ts = t - step * Ft / (Ftdt - Ft), dual;
//   vertex = start + dir * Ts in volume coordinates, rotated and moved to the
//   world; the interior margin of the normal (voxel index in (1, size - 2));
//   six more dual trilinears at +- half a voxel, n = differences, |n|^2 > 0,
//   dual normalisation, rotation to the world.
// Outputs: vmap.v/.g, nmap.v/.g, each (3, H, W): NaN in .v and 0 in .g where
// the pixel has no vertex (no normal), nan_to_num'ed numbers elsewhere.
//
// Kept from the plain version, quirk by quirk: the taps' +1e-5 bias; the base
// cell shifted down where the point lies below the voxel centre; the cell
// from floor(p * (1 / voxel)) in the trilinear and from floor(vertex / voxel)
// in the margin (a division by a host scalar, which PyTorch's CUDA operator
// rounds as a multiply by the reciprocal taken in double and rounded to
// float32: the same factor; the CPU divides truly there); to_index; every dual formula of csfd/single.py in its order
// (dual.cuh), the constants lifted to {c, 0} as there.
//
// Bound on the H100: latency and sectors of scattered gathers. An accepted
// pixel reads 8 trilinears x 8 taps x 2 planes = 128 floats, whose cells
// overlap heavily (the two secant samples are 0.8 trunc apart, the six normal
// samples half a voxel around the vertex), so the distinct bytes are few; the
// arithmetic is some 8 x 100 operations. What the design does: one thread a
// pixel in K3's 8 x 4 warp tiles, so neighbouring pixels' cells share
// sectors; a pixel that is not accepted, or fails a gate, writes its
// sentinels and leaves before any further gather (the plain version runs all
// 128 gathers for all pixels); the 16 loads of one trilinear are independent
// and started together.

#include <cuda_runtime.h>

#include "rays.cuh"

namespace {

using xs::Dual;
using xs::lift;

constexpr float INF_T = 1e9f;

struct Volume {
  const float* value;
  const float* grad;
  int X, Y, Z;
  float vs;         // float32 voxel size
  float inv_vs;     // float32 of (1 / voxel size in double)
  float half_vs;    // float32 of (voxel size * 0.5)
};

// ops/raycast.py::trilinear_tsdf_shard at one point
__device__ __forceinline__ Dual trilinear(const Volume& vol, const Dual p[3]) {
  int g[3];
  const int size[3] = {vol.X, vol.Y, vol.Z};
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g[i] = xs::to_index(floorf(p[i].v * vol.inv_vs));
    ok = ok && g[i] > 0 && g[i] < size[i] - 1;
  }
  if (!ok) return {xs::quiet_nan(), 0.0f};
  Dual w0[3], w1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g[i] -= (p[i].v < ((float)g[i] + 0.5f) * vol.vs) ? 1 : 0;
    w0[i] = p[i] * lift(vol.inv_vs) - lift((float)g[i] + 0.5f);
    w1[i] = lift(1.0f) - w0[i];
  }
  // ok: the shifted base cell and its +1 neighbours lie inside the volume
  const long long base = ((long long)g[0] * vol.Y + g[1]) * vol.Z + g[2];
  const long long sx = (long long)vol.Y * vol.Z, sy = vol.Z;
  Dual tap[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const long long off = base + (c >> 2) * sx + ((c >> 1) & 1) * sy + (c & 1);
    tap[c] = {__ldg(vol.value + off) + 1e-5f, __ldg(vol.grad + off)};
  }
  const Dual* a[2] = {w1, w0};  // a[0]: weight of the base cell, a[1]: of its +1 neighbour
  Dual res = tap[0] * ((a[0][0] * a[0][1]) * a[0][2]);
#pragma unroll
  for (int c = 1; c < 8; ++c) res = res + tap[c] * ((a[c >> 2][0] * a[(c >> 1) & 1][1]) * a[c & 1][2]);
  return res;
}

__device__ __forceinline__ void point_at(const Dual start[3], const Dual dir[3], Dual t, Dual p[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) p[i] = start[i] + dir[i] * t;
}

__device__ __forceinline__ void store3(float* __restrict__ out_v, float* __restrict__ out_g, int HW, int pix,
                                       bool ok, const Dual m[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out_v[i * HW + pix] = ok ? xs::nan_to_num(m[i].v) : xs::quiet_nan();
    out_g[i * HW + pix] = ok ? xs::nan_to_num(m[i].g) : 0.0f;
  }
}

__global__ void __launch_bounds__(xs::BLOCK_W* xs::BLOCK_H)
    refine_kernel(Volume vol, const float* __restrict__ pose, const float* __restrict__ t_found,
                  const float* __restrict__ t_dead, float* __restrict__ vmap_v, float* __restrict__ vmap_g,
                  float* __restrict__ nmap_v, float* __restrict__ nmap_g, int H, int W, float step, xs::Camera cam) {
  __shared__ float sp[xs::POSE_FLOATS];
  const int tid = threadIdx.x;
  if (tid < xs::POSE_FLOATS) sp[tid] = pose[tid];
  __syncthreads();
  int x, y;
  xs::block_pixel(tid, x, y);
  if (x >= W || y >= H) return;
  const int HW = H * W, pix = y * W + x;
  const Dual none[3] = {lift(0.0f), lift(0.0f), lift(0.0f)};

  const float hit_t = t_found[pix];
  const bool accept = hit_t < fminf(t_dead[pix], INF_T);
  if (!accept) {
    store3(vmap_v, vmap_g, HW, pix, false, none);
    store3(nmap_v, nmap_g, HW, pix, false, none);
    return;
  }

  const float* c2v = sp + xs::POSE_C2V;
  const float* v2w = sp + xs::POSE_V2W;
  Dual dir[3], start[3], p[3];
  xs::camera_ray(c2v, (float)x, (float)y, cam, dir);
#pragma unroll
  for (int i = 0; i < 3; ++i) start[i] = {c2v[18 + i], c2v[21 + i]};

  const Dual t = lift(hit_t);
  point_at(start, dir, t, p);
  const Dual ft = trilinear(vol, p);
  point_at(start, dir, t + lift(step), p);
  const Dual ftdt = trilinear(vol, p);
  const bool ok = !isnan(ft.v) && !isnan(ftdt.v) && ft.v >= 0.0f && ftdt.v <= 0.0f && ftdt.v != ft.v;
  if (!ok) {
    store3(vmap_v, vmap_g, HW, pix, false, none);
    store3(nmap_v, nmap_g, HW, pix, false, none);
    return;
  }
  const Dual ts = t - (ft / (ftdt - ft)) * lift(step);

  Dual vertex[3], vertex_w[3];
  point_at(start, dir, ts, vertex);
  xs::matvec3(v2w, vertex, vertex_w);
#pragma unroll
  for (int i = 0; i < 3; ++i) vertex_w[i] = vertex_w[i] + Dual{v2w[18 + i], v2w[21 + i]};
  store3(vmap_v, vmap_g, HW, pix, true, vertex_w);

  // central-difference normal, inside the reference's margin (RayCaster.cu:270-271)
  const int size[3] = {vol.X, vol.Y, vol.Z};
  bool n_ok = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int gv = xs::to_index(floorf(vertex[i].v * vol.inv_vs));
    n_ok = n_ok && gv > 1 && gv < size[i] - 2;
  }
  Dual n[3] = {lift(0.0f), lift(0.0f), lift(0.0f)}, n_w[3];
  if (n_ok) {
#pragma unroll
    for (int axis = 0; axis < 3; ++axis) {
      Dual q[3] = {vertex[0], vertex[1], vertex[2]};
      q[axis] = vertex[axis] + lift(vol.half_vs);
      const Dual plus = trilinear(vol, q);
      q[axis] = vertex[axis] + lift(-vol.half_vs);
      n[axis] = plus - trilinear(vol, q);
    }
    const Dual nsq = xs::dot3(n, n);
    n_ok = nsq.v > 0.0f && !isnan(nsq.v);
  }
  if (n_ok) {
    Dual unit[3];
    xs::normalized3(n, unit);
    xs::matvec3(v2w, unit, n_w);
  }
  store3(nmap_v, nmap_g, HW, pix, n_ok, n_ok ? n_w : none);
}

}  // namespace

extern "C" int xs_raycast_refine(const void* value, const void* grad, const void* pose, const void* t_found,
                                 const void* t_dead, void* vmap_v, void* vmap_g, void* nmap_v, void* nmap_g, int X,
                                 int Y, int Z, int H, int W, float vs, float inv_vs, float half_vs, float step,
                                 float cx, float cy, float inv_fx, float inv_fy, void* stream) {
  const Volume vol{(const float*)value, (const float*)grad, X, Y, Z, vs, inv_vs, half_vs};
  const xs::Camera cam{cx, cy, inv_fx, inv_fy};
  const dim3 grid((W + xs::BLOCK_W - 1) / xs::BLOCK_W, (H + xs::BLOCK_H - 1) / xs::BLOCK_H);
  refine_kernel<<<grid, xs::BLOCK_W * xs::BLOCK_H, 0, (cudaStream_t)stream>>>(
      vol, (const float*)pose, (const float*)t_found, (const float*)t_dead, (float*)vmap_v, (float*)vmap_g,
      (float*)nmap_v, (float*)nmap_g, H, W, step, cam);
  return (int)cudaGetLastError();
}
