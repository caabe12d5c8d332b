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
// float32: the same factor; the CPU divides truly there); to_index; every dual
// formula of csfd/single.py in its order (dual.cuh), the constants lifted to
// {c, 0} as there; each trilinear's eight products added in the plain
// version's order, the first not added to 0 (which would turn -0 into +0).
//
// Bound on the H100: the instructions a pixel issues and the latency of its
// dependent gathers, not bytes (the accepted pixels' taps overlap, so the
// distinct voxels are few). The design cuts both:
// - The six normal samples read 20 voxels, not 48. With g = floor(v / voxel)
//   and h = 1 where the vertex lies in the upper half of its cell, the
//   trilinear base of the sample at v -+ half a voxel is, in exact
//   arithmetic, g - 1 (minus) or g (plus) on the shifted axis and g - 1 + h
//   (the vertex's own base) on the others. The union is the vertex's 2x2x2
//   block plus, for each axis, the 2x2 face on the side that block does not
//   reach: 16 + 3 x 8 = 40 loads instead of 96. On the two axes it does not
//   shift, a sample's coordinates are the vertex's, and so is its cell and
//   its weights there (the same operations on the same numbers): only the
//   shifted axis's cell is computed. Where rounding puts that cell elsewhere
//   than the rule says (a vertex within a few ulps of a cell edge), or its
//   bounds test fails, the sample reads its own taps: the same tap values
//   reach the same weights in the same order either way, so the bits cannot
//   change. `direct`, where given, counts those samples.
// - The two secant samples' 32 loads are issued before either sum.
// - A pixel that is not accepted, or fails a gate, writes its sentinels and
//   leaves before any further gather.
// - 32-bit voxel offsets (the wrapper refuses volumes of 2^31 voxels).
// - Blocks of two warps, 8 x 8 pixels, each warp an 8 x 4 tile, so
//   neighbouring rays' cells share sectors and 240 x 320 is 1,200 blocks,
//   not 300: every SM gets work.
// What bounds it then (measured on the H100, PERF.md): the instructions it
// issues, above all the arithmetic of the eight dual trilinears. Cutting the
// loads by 44% bought 7%, the unshifted axes' cells (8% of the instructions)
// 10%. It takes 96 registers a thread (20 warps an SM): capping them to 80
// or fewer for more warps spills, and issuing the normal stage's 40 loads
// together takes 126; neither was faster.

#include <cuda_runtime.h>

#include "rays.cuh"

namespace {

using xs::Dual;
using xs::lift;

constexpr float INF_T = 1e9f;
constexpr int BLOCK_W = 8, BLOCK_H = 8, BLOCK_THREADS = BLOCK_W * BLOCK_H;  // two warps of 8 x 4 pixels

struct Volume {
  const float* value;
  const float* grad;
  int X, Y, Z;
  float vs;         // float32 voxel size
  float inv_vs;     // float32 of (1 / voxel size in double)
  float half_vs;    // float32 of (voxel size * 0.5)
};

// ops/raycast.py::trilinear_tsdf_shard's cell at one point: the base (shifted
// down below the voxel centre), the bounds test on the unshifted index, the
// weights of the base (w1) and of its +1 neighbour (w0) on each axis
struct Cell {
  int b[3];
  bool ok;
  Dual w0[3], w1[3];
};

// one axis of the cell at coordinate p (axis size n)
__device__ __forceinline__ void axis_cell(const Volume& vol, Dual p, int n, Cell& c, int i) {
  int g = xs::to_index(floorf(p.v * vol.inv_vs));
  c.ok = c.ok && g > 0 && g < n - 1;
  g -= (p.v < ((float)g + 0.5f) * vol.vs) ? 1 : 0;
  c.b[i] = g;
  c.w0[i] = p * lift(vol.inv_vs) - lift((float)g + 0.5f);
  c.w1[i] = lift(1.0f) - c.w0[i];
}

__device__ __forceinline__ Cell cell_at(const Volume& vol, const Dual p[3]) {
  Cell c;
  const int size[3] = {vol.X, vol.Y, vol.Z};
  c.ok = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) axis_cell(vol, p[i], size[i], c, i);
  return c;
}

// offset of a cell (unsigned: no overflow where the cell is out of bounds and
// the offset unused)
__device__ __forceinline__ unsigned offset_of(const Volume& vol, int x, int y, int z) {
  return ((unsigned)x * (unsigned)vol.Y + (unsigned)y) * (unsigned)vol.Z + (unsigned)z;
}

// offset of corner k (x = k >> 2, y = (k >> 1) & 1, z = k & 1) from its cell's base
__device__ __forceinline__ unsigned corner(const Volume& vol, int k) {
  return (unsigned)(k >> 2) * (unsigned)vol.Y * (unsigned)vol.Z + (unsigned)((k >> 1) & 1) * (unsigned)vol.Z +
         (unsigned)(k & 1);
}

__device__ __forceinline__ Dual tap_at(const Volume& vol, unsigned off) {
  return {__ldg(vol.value + off) + 1e-5f, __ldg(vol.grad + off)};
}

// the eight taps weighted and added in the plain version's order; (NaN, 0)
// out of bounds
__device__ __forceinline__ Dual combine(const Cell& c, const Dual tap[8]) {
  Dual res = tap[0] * ((c.w1[0] * c.w1[1]) * c.w1[2]);
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    const Dual& wx = (k >> 2) ? c.w0[0] : c.w1[0];
    const Dual& wy = ((k >> 1) & 1) ? c.w0[1] : c.w1[1];
    const Dual& wz = (k & 1) ? c.w0[2] : c.w1[2];
    res = res + tap[k] * ((wx * wy) * wz);
  }
  return c.ok ? res : Dual{xs::quiet_nan(), 0.0f};
}

// the loads of one cell's eight taps (from voxel 0 where out of bounds: read, then discarded by combine)
__device__ __forceinline__ void load_taps(const Volume& vol, const Cell& c, Dual tap[8]) {
  const unsigned base = c.ok ? offset_of(vol, c.b[0], c.b[1], c.b[2]) : 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) tap[k] = tap_at(vol, base + corner(vol, k));
}

// corner index k of the tap at offset e along axis A and j (the other two
// axes' offsets, the lower axis first) across it
template <int A>
__device__ __forceinline__ constexpr int corner_index(int e, int j) {
  return A == 0 ? e * 4 + j : A == 1 ? (j >> 1) * 4 + e * 2 + (j & 1) : (j >> 1) * 4 + (j & 1) * 2 + e;
}

// the difference of the trilinears at vertex + half and vertex - half along
// axis A, from the vertex's block `ctr` (base cv) and the face across axis A
template <int A>
__device__ __forceinline__ Dual axis_difference(const Volume& vol, const Dual vertex[3], const int gv[3],
                                                const Cell& vc, const Dual ctr[8], unsigned* direct) {
  constexpr int O1 = A == 0 ? 1 : 0, O2 = A == 2 ? 1 : 2;  // the other axes
  const int* cv = vc.b;
  const bool upper = cv[A] == gv[A];                      // h = 1
  // the face at g + 1 (h = 0) or g - 1 (h = 1) on axis A
  int fb[3] = {cv[0], cv[1], cv[2]};
  fb[A] = upper ? gv[A] - 1 : gv[A] + 1;
  const unsigned fbase = offset_of(vol, fb[0], fb[1], fb[2]);
  const unsigned step1 = O1 == 0 ? (unsigned)vol.Y * (unsigned)vol.Z : (unsigned)vol.Z;
  const unsigned step2 = O2 == 2 ? 1u : (unsigned)vol.Z;
  Dual line[3][4];  // the voxels at g - 1, g, g + 1 on axis A; j across it
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const Dual face = tap_at(vol, fbase + (unsigned)(j >> 1) * step1 + (unsigned)(j & 1) * step2);
    const Dual& lo = ctr[corner_index<A>(0, j)];
    const Dual& hi = ctr[corner_index<A>(1, j)];
    line[0][j] = upper ? face : lo;
    line[1][j] = upper ? lo : hi;
    line[2][j] = upper ? hi : face;
  }

  Dual res[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {  // s = 0: vertex + half (base g), s = 1: vertex - half (base g - 1)
    // the sample's cell: on the other two axes its coordinates are the vertex's, so is its cell there (the
    // same operations on the same numbers); on axis A its own
    Cell c = vc;
    const int size[3] = {vol.X, vol.Y, vol.Z};
    axis_cell(vol, vertex[A] + lift(s == 0 ? vol.half_vs : -vol.half_vs), size[A], c, A);
    const bool staged = c.ok && c.b[A] == gv[A] - s;
    Dual tap[8];
    if (staged) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int e = A == 0 ? k >> 2 : A == 1 ? (k >> 1) & 1 : k & 1;
        const int j = A == 0 ? k & 3 : A == 1 ? ((k >> 2) << 1) | (k & 1) : k >> 1;
        tap[k] = line[e + 1 - s][j];
      }
    } else {
      load_taps(vol, c, tap);
      if (direct != nullptr) atomicAdd(direct, 1u);
    }
    res[s] = combine(c, tap);
  }
  return res[0] - res[1];
}

// the pixel of thread `tid`: warp w of a block owns the 8 x 4 tile at rows 4 w
__device__ __forceinline__ void tile_pixel(int tid, int& x, int& y) {
  const int warp = tid >> 5, lane = tid & 31;
  x = blockIdx.x * BLOCK_W + (lane & 7);
  y = blockIdx.y * BLOCK_H + warp * 4 + (lane >> 3);
}

__device__ __forceinline__ void point_at(const Dual start[3], const Dual dir[3], Dual t, Dual p[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) p[i] = start[i] + dir[i] * t;
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

__global__ void __launch_bounds__(BLOCK_THREADS)
    refine_kernel(Volume vol, const float* __restrict__ pose, const float* __restrict__ t_found,
                  const float* __restrict__ t_dead, float* __restrict__ vmap_v, float* __restrict__ vmap_g,
                  float* __restrict__ nmap_v, float* __restrict__ nmap_g, int H, int W, float step, xs::Camera cam,
                  unsigned* direct) {
  static_assert(BLOCK_THREADS >= xs::POSE_FLOATS, "a block loads the pose, one float a thread");
  __shared__ float sp[xs::POSE_FLOATS];
  const int tid = threadIdx.x;
  if (tid < xs::POSE_FLOATS) sp[tid] = pose[tid];
  __syncthreads();
  int x, y;
  tile_pixel(tid, x, y);
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
  Dual dir[3], start[3], p0[3], p1[3];
  xs::camera_ray(c2v, (float)x, (float)y, cam, dir);
#pragma unroll
  for (int i = 0; i < 3; ++i) start[i] = {c2v[18 + i], c2v[21 + i]};

  // the secant samples: both cells, then all 32 loads, then the sums
  const Dual t = lift(hit_t);
  point_at(start, dir, t, p0);
  point_at(start, dir, t + lift(step), p1);
  const Cell c0 = cell_at(vol, p0), c1 = cell_at(vol, p1);
  Dual tap0[8], tap1[8];
  load_taps(vol, c0, tap0);
  load_taps(vol, c1, tap1);
  const Dual ft = combine(c0, tap0);
  const Dual ftdt = combine(c1, tap1);
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
  int gv[3];
  bool n_ok = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    gv[i] = xs::to_index(floorf(vertex[i].v * vol.inv_vs));
    n_ok = n_ok && gv[i] > 1 && gv[i] < size[i] - 2;
  }
  Dual n_w[3] = {lift(0.0f), lift(0.0f), lift(0.0f)};
  if (n_ok) {
    // the vertex's own cell: base g - 1 + h on each axis; inside the margin all 20 voxels lie in the volume
    const Cell cv = cell_at(vol, vertex);
    Dual ctr[8];
    load_taps(vol, cv, ctr);
    Dual n[3];
    n[0] = axis_difference<0>(vol, vertex, gv, cv, ctr, direct);
    n[1] = axis_difference<1>(vol, vertex, gv, cv, ctr, direct);
    n[2] = axis_difference<2>(vol, vertex, gv, cv, ctr, direct);
    const Dual nsq = xs::dot3(n, n);
    n_ok = nsq.v > 0.0f && !isnan(nsq.v);
    if (n_ok) {
      Dual unit[3];
      xs::normalized3(n, unit);
      xs::matvec3(v2w, unit, n_w);
    }
  }
  store3(nmap_v, nmap_g, HW, pix, n_ok, n_w);
}

}  // namespace

// direct: a counter of the normal samples read outside the shared block, or null
extern "C" int xs_raycast_refine(const void* value, const void* grad, const void* pose, const void* t_found,
                                 const void* t_dead, void* vmap_v, void* vmap_g, void* nmap_v, void* nmap_g,
                                 void* direct, int X, int Y, int Z, int H, int W, float vs, float inv_vs,
                                 float half_vs, float step, float cx, float cy, float inv_fx, float inv_fy,
                                 void* stream) {
  const Volume vol{(const float*)value, (const float*)grad, X, Y, Z, vs, inv_vs, half_vs};
  const xs::Camera cam{cx, cy, inv_fx, inv_fy};
  const dim3 grid((W + BLOCK_W - 1) / BLOCK_W, (H + BLOCK_H - 1) / BLOCK_H);
  refine_kernel<<<grid, BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
      vol, (const float*)pose, (const float*)t_found, (const float*)t_dead, (float*)vmap_v, (float*)vmap_g,
      (float*)nmap_v, (float*)nmap_g, H, W, step, cam, (unsigned*)direct);
  return (int)cudaGetLastError();
}
