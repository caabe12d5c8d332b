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
//
// K5r, its variant over the brick rows (refine_rows_kernel: the (NB, 512)
// rows of ops/bricks.py, rows.cuh's addressing), replaces the XLA code of
// xslam_tpu/ops/raycast.py::refine with trilin_fn =
// xslam_tpu/ops/raycast_bricks.py::trilinear_pair_bricks (the brick layout's
// `secant2` refine) and ::finalize_maps. Plain version: refine through
// xslam_tpu_torch/ops/raycast_bricks.py::trilinear_pair_bricks, then
// finalize_maps. The pair taps are the dense taps' bits on the volume's dense
// twin and every cell is the same, so K5r gives K5's bits on that twin: only
// the voxels' addresses differ. A brick row's neighbours along an axis are
// not a fixed stride apart, so a tap cannot be a corner offset from its
// cell's base; but row_index is a sum of one term an axis (row_term), so a
// cell's 8 taps take 6 terms and 8 sums, and the normal stage's 12 face taps
// take the vertex cell's terms and one more term an axis: 9 terms for the 20
// voxels, where each tap computed its own row_index (two multiplies, the
// shifts and masks) before. What held it was its registers, not the
// addressing (measured on the H100, PERF.md): at the compiler's 128 a thread
// an SM holds 8 blocks of 64, so 240 x 320's 1,200 blocks take 1.14 waves;
// its own launch bound (ROWS_MIN_BLOCKS) caps it at 96 (4 bytes spilled) and
// the grid takes one wave. The cap alone bought 12% at 240 x 320, the terms
// alone nothing there and 3% at 480 x 640, both together 13% and 4%. K5
// keeps its own bound: the compiler gives it 96 registers unasked.

// B19c, K5's shard mode (refine_shard_kernel, refine_body<SLAB>), the refine of one slab of the sharded engine
// (parallel/sharded.py), following xslam_tpu/ops/raycast.py::refine with a ShardSpec as
// xslam_tpu/parallel/sharded.py:129-139 calls it: the value and grad planes of a slab with its halo, whose local
// x 0 is global x x_base; every tap at global voxel x reads local row x - x_base (0 + 1e-5 and 0 outside the slab,
// as gather3d fills), and the cells' bounds tests and the normal's margin take the x_total-row volume. It reads
// the ranks' minimum t_found and t_dead and its own t_found: a pixel is refined where the minimum is accepted
// (t_min < min(t_dead_min, 1e9)) and this rank owns it (its t_found is the minimum), at t_min. It writes
// nan_to_num'ed numbers where the vertex (the normal) is valid and zeros elsewhere, with the two masks as 1 or 0:
// planes the ranks sum, as the JAX stage psums them. Then refine_finalize_kernel, K5's finalize
// (xslam_tpu/ops/raycast.py::finalize_maps), puts the NaN sentinels into the sums where no rank's mask was set.
// On one rank the maps are K5's bit for bit: the same taps' values reach the same arithmetic.

#include <cuda_runtime.h>

#include "rays.cuh"
#include "rows.cuh"

namespace {

using xs::Dual;
using xs::lift;

constexpr float INF_T = 1e9f;
enum : int { L_DENSE = 0, L_ROWS = 1, L_SLAB = 2 };  // the volume's layout: (X, Y, Z) planes, brick rows, a slab's
constexpr int BLOCK_W = 8, BLOCK_H = 8, BLOCK_THREADS = BLOCK_W * BLOCK_H;  // two warps of 8 x 4 pixels
// K5r's blocks an SM holds at least: its register cap (96), so that 240 x 320's 1,200 blocks take one wave
constexpr int ROWS_MIN_BLOCKS = 10;

struct Volume {
  const float* value;
  const float* grad;
  int X, Y, Z;
  float vs;         // float32 voxel size
  float inv_vs;     // float32 of (1 / voxel size in double)
  float half_vs;    // float32 of (voxel size * 0.5)
  xs::Rows r;       // the brick grid (K5r's rows; unused by the dense planes)
  int x_base, x_total;  // SLAB: the global x of local row 0 and the whole volume's rows (X: the slab's own)
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

// the extents the cells are tested against: the whole volume's (a slab's x_total)
template <int LAYOUT>
__device__ __forceinline__ int extent_x(const Volume& vol) {
  return LAYOUT == L_SLAB ? vol.x_total : vol.X;
}

template <int LAYOUT>
__device__ __forceinline__ Cell cell_at(const Volume& vol, const Dual p[3]) {
  Cell c;
  const int size[3] = {extent_x<LAYOUT>(vol), vol.Y, vol.Z};
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

// the tap of voxel (x, y, z) of a slab (global x; 0 outside the slab), y and z inside the volume (the dense planes
// address a cell's taps from its base, the brick rows from their axes' terms instead)
__device__ __forceinline__ Dual tap_xyz(const Volume& vol, int x, int y, int z) {
  const int lx = x - vol.x_base;
  if ((unsigned)lx >= (unsigned)vol.X) return {0.0f + 1e-5f, 0.0f};
  return tap_at(vol, offset_of(vol, lx, y, z));
}

// K5r: rows.cuh::row_index regrouped as a sum of one term an axis, ((x >> 3) nby nbz + (y >> 3) nbz + (z >> 3))
// 512 + (x & 7) 64 + (y & 7) 8 + (z & 7) = term<0>(x) + term<1>(y) + term<2>(z), exact in 32-bit unsigned
// arithmetic (the wrapper keeps the volume under 2^31 voxels): the same address, so the same bits. A brick row's
// neighbours along an axis are not a fixed stride apart, but a cell's 8 taps need only its two terms an axis.
template <int A>
__device__ __forceinline__ unsigned row_term(const Volume& vol, int v) {
  const unsigned brick = A == 0 ? (unsigned)vol.r.nby * (unsigned)vol.r.nbz * (unsigned)xs::BRICK_LANES
                                : A == 1 ? (unsigned)vol.r.nbz * (unsigned)xs::BRICK_LANES : (unsigned)xs::BRICK_LANES;
  return (unsigned)(v >> 3) * brick + ((unsigned)(v & 7) << (A == 0 ? 6 : A == 1 ? 3 : 0));
}

// the terms of base b and of b + 1 on each axis: a cell's taps' addresses (b inside the volume)
__device__ __forceinline__ void cell_terms(const Volume& vol, const int b[3], unsigned term[3][2]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    term[0][e] = row_term<0>(vol, b[0] + e);
    term[1][e] = row_term<1>(vol, b[1] + e);
    term[2][e] = row_term<2>(vol, b[2] + e);
  }
}

__device__ __forceinline__ void load_terms(const Volume& vol, const unsigned term[3][2], Dual tap[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) tap[k] = tap_at(vol, term[0][k >> 2] + term[1][(k >> 1) & 1] + term[2][k & 1]);
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

// the loads of one cell's eight taps (from the cell at voxel 0, a slab's local 0, where out of bounds: read,
// then discarded by combine)
template <int LAYOUT>
__device__ __forceinline__ void load_taps(const Volume& vol, const Cell& c, Dual tap[8]) {
  if (LAYOUT == L_ROWS) {
    const int b[3] = {c.ok ? c.b[0] : 0, c.ok ? c.b[1] : 0, c.ok ? c.b[2] : 0};
    unsigned term[3][2];
    cell_terms(vol, b, term);
    load_terms(vol, term, tap);
    return;
  }
  if (LAYOUT == L_SLAB) {
    const int bx = c.ok ? c.b[0] : vol.x_base, by = c.ok ? c.b[1] : 0, bz = c.ok ? c.b[2] : 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) tap[k] = tap_xyz(vol, bx + (k >> 2), by + ((k >> 1) & 1), bz + (k & 1));
    return;
  }
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
// axis A, from the vertex's block `ctr` (base cv) and the face across axis A; vt: with L_ROWS the vertex cell's
// terms (cell_terms), from which the face and a sample's own cell take the other two axes' terms
template <int A, int LAYOUT>
__device__ __forceinline__ Dual axis_difference(const Volume& vol, const Dual vertex[3], const int gv[3],
                                                const Cell& vc, const Dual ctr[8], const unsigned vt[3][2],
                                                unsigned* direct) {
  constexpr int O1 = A == 0 ? 1 : 0, O2 = A == 2 ? 1 : 2;  // the other axes
  const int* cv = vc.b;
  const bool upper = cv[A] == gv[A];                      // h = 1
  // the face at g + 1 (h = 0) or g - 1 (h = 1) on axis A
  int fb[3] = {cv[0], cv[1], cv[2]};
  fb[A] = upper ? gv[A] - 1 : gv[A] + 1;
  const unsigned fbase = offset_of(vol, fb[0], fb[1], fb[2]);
  const unsigned step1 = O1 == 0 ? (unsigned)vol.Y * (unsigned)vol.Z : (unsigned)vol.Z;
  const unsigned step2 = O2 == 2 ? 1u : (unsigned)vol.Z;
  const unsigned fterm = LAYOUT == L_ROWS ? row_term<A>(vol, fb[A]) : 0u;  // the face's term on axis A
  Dual line[3][4];  // the voxels at g - 1, g, g + 1 on axis A; j across it
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int q[3] = {fb[0], fb[1], fb[2]};
    q[O1] += j >> 1;
    q[O2] += j & 1;
    const Dual face = LAYOUT == L_ROWS   ? tap_at(vol, fterm + vt[O1][j >> 1] + vt[O2][j & 1])
                      : LAYOUT == L_SLAB ? tap_xyz(vol, q[0], q[1], q[2])
                                         : tap_at(vol, fbase + (unsigned)(j >> 1) * step1 + (unsigned)(j & 1) * step2);
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
    const int size[3] = {extent_x<LAYOUT>(vol), vol.Y, vol.Z};
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
    } else if (LAYOUT == L_ROWS) {
      // the sample's own cell: the vertex cell's terms on the other two axes (the same bases), its own on axis A
      // (the vertex cell's base where out of bounds: read, then discarded by combine)
      unsigned term[3][2] = {{vt[0][0], vt[0][1]}, {vt[1][0], vt[1][1]}, {vt[2][0], vt[2][1]}};
      const int b = c.ok ? c.b[A] : cv[A];
      term[A][0] = row_term<A>(vol, b);
      term[A][1] = row_term<A>(vol, b + 1);
      load_terms(vol, term, tap);
      if (direct != nullptr) atomicAdd(direct, 1u);
    } else {
      load_taps<LAYOUT>(vol, c, tap);
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

// one (3,) map entry: nan_to_num'ed numbers where ok, else (NaN, 0), or with SLAB (0, 0) and ok's mask
template <int LAYOUT>
__device__ __forceinline__ void store3(float* __restrict__ out_v, float* __restrict__ out_g, int HW, int pix,
                                       bool ok, const Dual m[3], float* __restrict__ mask) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out_v[i * HW + pix] = ok ? xs::nan_to_num(m[i].v) : (LAYOUT == L_SLAB ? 0.0f : xs::quiet_nan());
    out_g[i * HW + pix] = ok ? xs::nan_to_num(m[i].g) : 0.0f;
  }
  if (LAYOUT == L_SLAB) mask[pix] = ok ? 1.0f : 0.0f;
}

// t_found: this volume's (with SLAB this slab's) march hits; t_dead: its deaths (with SLAB the ranks' minimum);
// t_min: with SLAB the ranks' minimum t_found, else unused; ok_out: with SLAB the two masks' planes (v, n)
template <int LAYOUT>
__device__ __forceinline__ void refine_body(const Volume& vol, const float* __restrict__ pose,
                                            const float* __restrict__ t_found, const float* __restrict__ t_dead,
                                            const float* __restrict__ t_min, float* __restrict__ vmap_v,
                                            float* __restrict__ vmap_g, float* __restrict__ nmap_v,
                                            float* __restrict__ nmap_g, float* __restrict__ ok_out, int H, int W,
                                            float step, const xs::Camera& cam, unsigned* direct) {
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
  float* const v_mask = ok_out;
  float* const n_mask = LAYOUT == L_SLAB ? ok_out + HW : nullptr;

  // with SLAB: the ranks' first crossing, accepted as the whole volume's would be, and owned by this rank
  const float hit_t = LAYOUT == L_SLAB ? t_min[pix] : t_found[pix];
  const bool accept = hit_t < fminf(t_dead[pix], INF_T) && (LAYOUT != L_SLAB || t_found[pix] == hit_t);
  if (!accept) {
    store3<LAYOUT>(vmap_v, vmap_g, HW, pix, false, none, v_mask);
    store3<LAYOUT>(nmap_v, nmap_g, HW, pix, false, none, n_mask);
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
  const Cell c0 = cell_at<LAYOUT>(vol, p0), c1 = cell_at<LAYOUT>(vol, p1);
  Dual tap0[8], tap1[8];
  load_taps<LAYOUT>(vol, c0, tap0);
  load_taps<LAYOUT>(vol, c1, tap1);
  const Dual ft = combine(c0, tap0);
  const Dual ftdt = combine(c1, tap1);
  const bool ok = !isnan(ft.v) && !isnan(ftdt.v) && ft.v >= 0.0f && ftdt.v <= 0.0f && ftdt.v != ft.v;
  if (!ok) {
    store3<LAYOUT>(vmap_v, vmap_g, HW, pix, false, none, v_mask);
    store3<LAYOUT>(nmap_v, nmap_g, HW, pix, false, none, n_mask);
    return;
  }
  const Dual ts = t - (ft / (ftdt - ft)) * lift(step);

  Dual vertex[3], vertex_w[3];
  point_at(start, dir, ts, vertex);
  xs::matvec3(v2w, vertex, vertex_w);
#pragma unroll
  for (int i = 0; i < 3; ++i) vertex_w[i] = vertex_w[i] + Dual{v2w[18 + i], v2w[21 + i]};
  store3<LAYOUT>(vmap_v, vmap_g, HW, pix, true, vertex_w, v_mask);

  // central-difference normal, inside the reference's margin (RayCaster.cu:270-271)
  const int size[3] = {extent_x<LAYOUT>(vol), vol.Y, vol.Z};
  int gv[3];
  bool n_ok = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    gv[i] = xs::to_index(floorf(vertex[i].v * vol.inv_vs));
    n_ok = n_ok && gv[i] > 1 && gv[i] < size[i] - 2;
  }
  Dual n_w[3] = {lift(0.0f), lift(0.0f), lift(0.0f)};
  if (n_ok) {
    // the vertex's own cell: base g - 1 + h on each axis; inside the margin all 20 voxels lie in the volume (and
    // the cell is in bounds: its index is gv)
    const Cell cv = cell_at<LAYOUT>(vol, vertex);
    Dual ctr[8];
    unsigned vt[3][2];  // L_ROWS: the cell's terms, shared with the faces
    if (LAYOUT == L_ROWS) {
      cell_terms(vol, cv.b, vt);
      load_terms(vol, vt, ctr);
    } else {
      load_taps<LAYOUT>(vol, cv, ctr);
    }
    Dual n[3];
    n[0] = axis_difference<0, LAYOUT>(vol, vertex, gv, cv, ctr, vt, direct);
    n[1] = axis_difference<1, LAYOUT>(vol, vertex, gv, cv, ctr, vt, direct);
    n[2] = axis_difference<2, LAYOUT>(vol, vertex, gv, cv, ctr, vt, direct);
    const Dual nsq = xs::dot3(n, n);
    n_ok = nsq.v > 0.0f && !isnan(nsq.v);
    if (n_ok) {
      Dual unit[3];
      xs::normalized3(n, unit);
      xs::matvec3(v2w, unit, n_w);
    }
  }
  store3<LAYOUT>(nmap_v, nmap_g, HW, pix, n_ok, n_w, n_mask);
}

// K5 over the dense planes and K5r over the brick rows, each with its own launch bounds
#define REFINE_ARGS                                                                                              \
  Volume vol, const float *__restrict__ pose, const float *__restrict__ t_found, const float *__restrict__ t_dead, \
      float *__restrict__ vmap_v, float *__restrict__ vmap_g, float *__restrict__ nmap_v,                        \
      float *__restrict__ nmap_g, int H, int W, float step, xs::Camera cam, unsigned *direct
__global__ void __launch_bounds__(BLOCK_THREADS) refine_kernel(REFINE_ARGS) {
  refine_body<L_DENSE>(vol, pose, t_found, t_dead, nullptr, vmap_v, vmap_g, nmap_v, nmap_g, nullptr, H, W, step, cam,
                       direct);
}

__global__ void __launch_bounds__(BLOCK_THREADS, ROWS_MIN_BLOCKS) refine_rows_kernel(REFINE_ARGS) {
  refine_body<L_ROWS>(vol, pose, t_found, t_dead, nullptr, vmap_v, vmap_g, nmap_v, nmap_g, nullptr, H, W, step, cam,
                      direct);
}
#undef REFINE_ARGS

// B19c: K5's shard mode over a slab's planes
__global__ void __launch_bounds__(BLOCK_THREADS)
    refine_shard_kernel(Volume vol, const float* __restrict__ pose, const float* __restrict__ t_found,
                        const float* __restrict__ t_dead_min, const float* __restrict__ t_found_min,
                        float* __restrict__ vmap_v, float* __restrict__ vmap_g, float* __restrict__ nmap_v,
                        float* __restrict__ nmap_g, float* __restrict__ ok_out, int H, int W, float step,
                        xs::Camera cam) {
  refine_body<L_SLAB>(vol, pose, t_found, t_dead_min, t_found_min, vmap_v, vmap_g, nmap_v, nmap_g, ok_out, H, W,
                      step, cam, nullptr);
}

template <int LAYOUT>
int launch_refine(const Volume& vol, const void* pose, const void* t_found, const void* t_dead, const void* t_min,
                  void* vmap_v, void* vmap_g, void* nmap_v, void* nmap_g, void* ok_out, void* direct, int H, int W,
                  float step, const xs::Camera& cam, void* stream) {
  const dim3 grid((W + BLOCK_W - 1) / BLOCK_W, (H + BLOCK_H - 1) / BLOCK_H);
  const auto kernel = LAYOUT == L_ROWS ? refine_rows_kernel : refine_kernel;
  if (LAYOUT == L_SLAB)
    refine_shard_kernel<<<grid, BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
        vol, (const float*)pose, (const float*)t_found, (const float*)t_dead, (const float*)t_min, (float*)vmap_v,
        (float*)vmap_g, (float*)nmap_v, (float*)nmap_g, (float*)ok_out, H, W, step, cam);
  else
    kernel<<<grid, BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
        vol, (const float*)pose, (const float*)t_found, (const float*)t_dead, (float*)vmap_v, (float*)vmap_g,
        (float*)nmap_v, (float*)nmap_g, H, W, step, cam, (unsigned*)direct);
  return (int)cudaGetLastError();
}

// K5's finalize over the ranks' summed planes (xslam_tpu/ops/raycast.py::finalize_maps), in place: `maps` holds
// vmap.v, vmap.g, nmap.v, nmap.g (3 planes each), then the v and n masks' sums; a map's value lane becomes NaN and
// its derivative 0 where its mask sums to 0. Where a mask is set the summed planes already hold the owner's values,
// so a pixel reads only its two masks and writes only the 6 floats of a map whose mask is 0. Bound by bytes: 8 B a
// pixel read, 24 B a masked-out map written.
__global__ void refine_finalize_kernel(float* __restrict__ maps, int HW) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= HW) return;
  const bool v_ok = maps[12 * HW + pix] > 0.0f, n_ok = maps[13 * HW + pix] > 0.0f;
  if (!v_ok) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      maps[i * HW + pix] = xs::quiet_nan();
      maps[(3 + i) * HW + pix] = 0.0f;
    }
  }
  if (!n_ok) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      maps[(6 + i) * HW + pix] = xs::quiet_nan();
      maps[(9 + i) * HW + pix] = 0.0f;
    }
  }
}

}  // namespace

// direct: a counter of the normal samples read outside the shared block, or null
extern "C" int xs_raycast_refine(const void* value, const void* grad, const void* pose, const void* t_found,
                                 const void* t_dead, void* vmap_v, void* vmap_g, void* nmap_v, void* nmap_g,
                                 void* direct, int X, int Y, int Z, int H, int W, float vs, float inv_vs,
                                 float half_vs, float step, float cx, float cy, float inv_fx, float inv_fy,
                                 void* stream) {
  const Volume vol{(const float*)value, (const float*)grad, X, Y, Z, vs, inv_vs, half_vs, xs::Rows{}, 0, X};
  return launch_refine<L_DENSE>(vol, pose, t_found, t_dead, nullptr, vmap_v, vmap_g, nmap_v, nmap_g, nullptr, direct,
                              H, W, step, xs::Camera{cx, cy, inv_fx, inv_fy}, stream);
}

// B19c, the shard mode: value, grad the (X, Y, Z) planes of a slab with its halo, local x 0 at global x_base of a
// volume of x_total rows; t_found this slab's hits, t_found_min and t_dead_min the ranks' minima; maps: 14 planes
// of (H, W) floats (vmap.v, vmap.g, nmap.v, nmap.g, then the v and n masks), written whole
extern "C" int xs_raycast_refine_shard(const void* value, const void* grad, const void* pose, const void* t_found,
                                       const void* t_found_min, const void* t_dead_min, void* maps, int X, int Y,
                                       int Z, int x_base, int x_total, int H, int W, float vs, float inv_vs,
                                       float half_vs, float step, float cx, float cy, float inv_fx, float inv_fy,
                                       void* stream) {
  if ((long long)X * Y * Z >= (1ll << 31) || x_total < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const Volume vol{(const float*)value, (const float*)grad, X, Y, Z, vs, inv_vs, half_vs, xs::Rows{}, x_base, x_total};
  float* m = (float*)maps;
  const size_t HW = (size_t)H * W;
  return launch_refine<L_SLAB>(vol, pose, t_found, t_dead_min, t_found_min, m, m + 3 * HW, m + 6 * HW, m + 9 * HW,
                             m + 12 * HW, nullptr, H, W, step, xs::Camera{cx, cy, inv_fx, inv_fy}, stream);
}

// B19c, K5's finalize: maps as xs_raycast_refine_shard writes them, summed over the ranks, finalized in place
extern "C" int xs_raycast_finalize(void* maps, int H, int W, void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int HW = H * W, block = 256;
  refine_finalize_kernel<<<(HW + block - 1) / block, block, 0, (cudaStream_t)stream>>>((float*)maps, HW);
  return (int)cudaGetLastError();
}

// K5r: value, grad the (nbx * nby * nbz, 512) brick rows
extern "C" int xs_raycast_refine_rows(const void* value, const void* grad, const void* pose, const void* t_found,
                                      const void* t_dead, void* vmap_v, void* vmap_g, void* nmap_v, void* nmap_g,
                                      void* direct, int nbx, int nby, int nbz, int H, int W, float vs,
                                      float inv_vs, float half_vs, float step, float cx, float cy, float inv_fx,
                                      float inv_fy, void* stream) {
  const long long voxels = (long long)nbx * nby * nbz * xs::BRICK_LANES;
  if (voxels >= (1ll << 31) || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const xs::Rows r = xs::make_rows(nbx, nby, nbz);
  const Volume vol{(const float*)value, (const float*)grad, r.X, r.Y, r.Z, vs, inv_vs, half_vs, r, 0, r.X};
  return launch_refine<L_ROWS>(vol, pose, t_found, t_dead, nullptr, vmap_v, vmap_g, nmap_v, nmap_g, nullptr, direct,
                             H, W, step, xs::Camera{cx, cy, inv_fx, inv_fy}, stream);
}
