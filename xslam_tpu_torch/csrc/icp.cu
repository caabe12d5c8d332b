// K4: one whole ICP iteration in one launch, and the cached association.
//
// Replaces the XLA code of xslam_tpu/ops/icp.py::associate + build_system +
// solve_increment and the pose update of xslam_tpu/models/kinfu.py::
// _pose_estimate; reference ICP.cu:196-281 (search_newton, combinedKernel),
// :246-429 (the two-stage reduction) and KinectFusionReconstruction.cpp:
// 203-224 (guard, solve, incremental pose). Two entry points:
//
// - xs_icp_system: per pixel of the current maps, move the vertex into the
//   world with the dual current pose; find its target in the previous model,
//   either by projecting into the previous camera (value lane; round half to
//   even with rintf; NaN -> index -1) or by reading a cached index map; fetch
//   the model's packed row of 12 floats (v.v v.g n.v n.g); apply the gates in
//   the reference's order (current normal not NaN, in image and z >= 0,
//   fetched normal not NaN, dist <= dist_thres, sine < angle_thres); build
//   the dual row [cross(s, n), n | n.(d - s)] (NaN -> 0 and inf -> +-FLT_MAX
//   as nan_to_num); and reduce A = J^T J (21 distinct entries), b = J^T r and
//   the inlier count over all pixels, both lanes: 54 sums and one integer.
//   Given a pose output, the block that finishes the reduction goes on with
//   the rest of the iteration (the "tail"): damping, the 6x6 dual solve by LU
//   with partial pivoting and its determinant guard, the Euler increment
//   Rz Ry Rx, the left-multiplied pose update, frozen where the step failed.
//   It writes the next launch's 36 pose floats, x, the step's flag and the
//   frame's flag, so a frame's ICP loop is one launch per iteration with no
//   other device work between them.
//   A projecting launch may also be given an index map to write (assoc_out):
//   each pixel with a current normal stores the flat index it projected to,
//   -1 where the pixel is not in the image, and each pixel without one stores
//   -1 (no launch reads it: such a pixel leaves at its first gate). Caching
//   the index is equivalent to caching the 12 gathered floats, because a row
//   is valid only where the pixel is in the image. So with icp_fixed_assoc
//   the first launch of a level, which starts from the pose the association
//   is made at, makes the cache, and the level's later launches read it.
// - xs_icp_tail (B19d): the tail alone, one block, over totals given in device memory: the sharded engine's
//   iteration (parallel/sharded.py, xslam_tpu/parallel/sharded.py:163-222) launches xs_icp_system on its block
//   of the current maps' columns with totals_out (the 55 double totals, before any rounding), sums them over
//   the ranks (all_reduce), then this. The tail rounds each total to float32 where it reads it, as the fused
//   one does, so on one rank the pose, x and flags are the fused launch's bit for bit.
// - xs_icp_associate: the projection alone, written as the same index map
//   (also at pixels without a normal). The engine no longer launches it: it
//   is the reference the folded index is held against (chip_smoke.py).
//
// Bound on the H100: bytes. 72 B per pixel (24 B of current maps, a 48 B row
// of the model, 4 B more where the index is cached or written) against, per pixel with
// a current normal, 36 operations to move the vertex and 31 to project it;
// 10 for the distance gate of a pixel that fetched a target; 31 for the angle
// gate; and some 180 for an inlier's dual row, nan_to_num and 54 sums. What
// the design does about it:
//
// - The model's row is one 48-byte record (three 16-byte loads started
//   together, one or two 32-byte sectors), not twelve 4-byte gathers from
//   twelve planes behind three gates. The gates still decide in the
//   reference's order, on float32 arithmetic in its operation order, one
//   rounding at a time (built with -fmad=false), as the plain version's do.
// - No thread holds the 54 sums. A warp takes 32 consecutive pixels; each
//   inlier lane leaves its dual row (7 + 7 numbers: J and r) in shared memory,
//   converted to double by the lane that built it;
//   then lane l < 27 owns the pair (i, j) of one entry of [J r]^T [J r] and
//   adds, pixel after pixel in lane order, the value-lane and derivative-
//   lane products of that pair to two DOUBLE accumulators. A product of two
//   float32 is exact in double, so each fma rounds once, as the separate
//   multiply and add would. Few registers a thread, so many warps in flight
//   hide the gathers; no shuffle tree over 55 doubles.
// - Warps are added in order through shared memory, every block writes its
//   55 partials, and the block that takes the last ticket (one integer
//   atomic) reads all partials with independent coalesced loads (4 groups of
//   blocks, added in a fixed order) and rounds once to float32. The wrapper
//   sizes the grid by the image: one block per 128 pixels, at most three for
//   each SM (one wave); measured, the pixel loop's latency costs more than
//   the partials of more blocks do. No float atomic is used anywhere and the
//   order of every sum depends only on the shapes and the grid, so two runs
//   on the same inputs give the same bits.
// - The tail is one thread's work (a few thousand float32 operations in the
//   order of the plain version, icp_step_plain; about 3.4 us): it reads the
//   pose from one buffer and writes the other, so no block can read a pose
//   that is being written. It keeps one 6x6 matrix in registers and reads the
//   rest from shared memory where it is used, so that the kernel fits 64
//   registers a thread without spills and an SM holds four blocks.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int MIN_BLOCKS = 4;        // blocks an SM must hold: caps the registers at 64 a thread
constexpr int WARPS = BLOCK / 32;
constexpr int NPAIR = 27;            // pairs (i, j) of [J r]: 21 of A, 6 of b
constexpr int NQ = 2 * NPAIR + 1;    // value sums, derivative sums, inlier count
constexpr int ROW_STRIDE = 15;       // doubles between two pixels' rows in shared memory (no bank conflicts)
constexpr int GROUPS = 4;            // groups of blocks the last block adds side by side
constexpr float INDEX_LIMIT = 1073741824.0f;  // 2^30
constexpr float FLT_BIG = 3.402823466e+38f;
constexpr float DET_MIN = 1e-15f;

struct Geom {
  int n_curr;  // pixels of the current maps
  int Hp, Wp;  // shape of the previous model's maps
  float fx, fy, cx, cy, dist_thres, angle_thres;
};

// the tail's outputs; pose_out == nullptr: stop after A, b and the inlier count
struct Tail {
  float* pose_out;  // 36 floats, the layout of the pose read
  float* x_out;     // x.v (6), x.g (6)
  int* flags;       // [0]: this step solved; [1]: every step of the frame so far solved
  float damping;
  int first;        // the frame's first iteration: flags[1] starts from this step
};

// pose layout: R_curr.v (row-major 3x3), R_curr.g, t_curr.v, t_curr.g,
// R_prev_inv.v, t_prev.v
constexpr int RC_V = 0, RC_G = 9, TC_V = 18, TC_G = 21, RPI_V = 24, TP_V = 33, POSE_FLOATS = 36;

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

// One pixel: true where it is an inlier, and then its dual row in `row`, as
// doubles: J.v (6), r.v, J.g (6), r.g, after nan_to_num. The lane that built
// the row converts it, once, so the lanes that add it do not (conversions to
// double are the card's slowest arithmetic: 16 a clock on an SM).
// Where the launch caches the association, assoc_out[p] gets the pixel's index.
__device__ __forceinline__ bool pixel_row(int p, const float* __restrict__ vcurr, const float* __restrict__ ncurr,
                                          const float4* __restrict__ rows, const int* __restrict__ assoc,
                                          int* __restrict__ assoc_out, const float* __restrict__ pose,
                                          const Geom& g, double* row) {
  const float nc0 = ncurr[p];
  if (isnan(nc0)) {
    if (assoc_out != nullptr) assoc_out[p] = -1;
    return false;
  }
  const float v[3] = {vcurr[p], vcurr[g.n_curr + p], vcurr[2 * g.n_curr + p]};
  float sv[3], sg[3];
  world_vertex(pose, v, sv, sg);
  const int idx = assoc != nullptr ? assoc[p] : project(pose, sv, g);
  if (assoc_out != nullptr) assoc_out[p] = idx;
  if (idx < 0) return false;

  // the model's row: v.v (3), v.g (3), n.v (3), n.g (3)
  const float4 q0 = rows[3 * idx], q1 = rows[3 * idx + 1], q2 = rows[3 * idx + 2];
  const float dv[3] = {q0.x, q0.y, q0.z}, dg[3] = {q0.w, q1.x, q1.y};
  const float nv[3] = {q1.z, q1.w, q2.x}, ng[3] = {q2.y, q2.z, q2.w};
  if (isnan(nv[0])) return false;

  // e = d - s; dist = |e|
  float ev[3];
  for (int i = 0; i < 3; ++i) ev[i] = dv[i] - sv[i];
  const float dist = sqrtf((ev[0] * ev[0] + ev[1] * ev[1]) + ev[2] * ev[2]);
  if (!(dist <= g.dist_thres)) return false;

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
  if (!(sine < g.angle_thres)) return false;

  // the dual row J = [cross(s, n), n] and residual r = n . (d - s)
  float jv[7], jg[7];
  for (int i = 0; i < 3; ++i) {
    const int a = (i + 1) % 3, b = (i + 2) % 3;
    jv[i] = sv[a] * nv[b] - sv[b] * nv[a];
    jg[i] = (sg[a] * nv[b] + sv[a] * ng[b]) - (sg[b] * nv[a] + sv[b] * ng[a]);
    jv[3 + i] = nv[i];
    jg[3 + i] = ng[i];
  }
  float eg[3];
  for (int i = 0; i < 3; ++i) eg[i] = dg[i] - sg[i];
  jv[6] = (nv[0] * ev[0] + nv[1] * ev[1]) + nv[2] * ev[2];
  jg[6] = ((ng[0] * ev[0] + nv[0] * eg[0]) + (ng[1] * ev[1] + nv[1] * eg[1])) + (ng[2] * ev[2] + nv[2] * eg[2]);

#pragma unroll
  for (int i = 0; i < 7; ++i) {
    row[i] = (double)nan_to_num(jv[i]);
    row[7 + i] = (double)nan_to_num(jg[i]);
  }
  return true;
}

// index of pair (i, j), i <= j < 6, in the row-major upper triangle
__device__ __forceinline__ int tri(int i, int j) { return i * 6 - i * (i - 1) / 2 + (j - i); }

// ---- the tail: float32 dual arithmetic in the plain version's order ----------

// c = a * b, dual 3x3, in the order of se3.matmul
__device__ void dual_matmul3(const float* av, const float* ag, const float* bv, const float* bg, float* cv,
                             float* cg) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float accv = av[3 * i] * bv[j];
      float accg = ag[3 * i] * bv[j] + av[3 * i] * bg[j];
#pragma unroll
      for (int l = 1; l < 3; ++l) {
        const float pv = av[3 * i + l] * bv[3 * l + j];
        const float pg = ag[3 * i + l] * bv[3 * l + j] + av[3 * i + l] * bg[3 * l + j];
        accv = accv + pv;
        accg = accg + pg;
      }
      cv[3 * i + j] = accv;
      cg[3 * i + j] = accg;
    }
  }
}

// The row swaps of the factorisation (whole rows were swapped, multipliers
// included, so all swaps come first), then forward and back substitution
// with the LU factors, in place on rhs.
__device__ void lu_solve(const float (&lu)[6][6], const int (&piv)[6], float (&rhs)[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
#pragma unroll
    for (int r = k + 1; r < 6; ++r) {
      if (r == piv[k]) {
        const float tmp = rhs[k];
        rhs[k] = rhs[r];
        rhs[r] = tmp;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
#pragma unroll
    for (int r = k + 1; r < 6; ++r) rhs[r] = rhs[r] - lu[r][k] * rhs[k];
  }
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    float acc = rhs[k];
#pragma unroll
    for (int c = k + 1; c < 6; ++c) acc = acc - lu[k][c] * rhs[c];
    rhs[k] = acc / lu[k][k];
  }
}

__device__ void icp_tail(const double* totals, const float* __restrict__ pose, const Tail& t) {
  // The value lane of A goes straight into the array that is factorised, and
  // A.g, b.v and b.g are read from the totals where they are used: the one
  // thread here must not set the register count of the whole kernel.
  float lu[6][6];
  int piv[6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) lu[i][j] = (float)totals[i <= j ? tri(i, j) : tri(j, i)];
  if (t.damping > 0.0f) {
#pragma unroll
    for (int i = 0; i < 6; ++i) lu[i][i] = lu[i][i] + t.damping * lu[i][i];
  }

  // LU with partial pivoting of the value lane; det from the pivots
  float det = 1.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(lu[k][k]);
#pragma unroll
    for (int r = k + 1; r < 6; ++r) {
      const float a = fabsf(lu[r][k]);
      if (a > best) {
        best = a;
        p = r;
      }
    }
    piv[k] = p;
#pragma unroll
    for (int r = k + 1; r < 6; ++r) {
      if (r == p) {
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          const float tmp = lu[k][c];
          lu[k][c] = lu[r][c];
          lu[r][c] = tmp;
        }
        det = -det;
      }
    }
    det = det * lu[k][k];
#pragma unroll
    for (int r = k + 1; r < 6; ++r) {
      const float mult = lu[r][k] / lu[k][k];
      lu[r][k] = mult;
#pragma unroll
      for (int c = k + 1; c < 6; ++c) lu[r][c] = lu[r][c] - mult * lu[k][c];
    }
  }
  const bool det_ok = fabsf(det) >= DET_MIN && !isnan(det);

  // x.v = A.v^-1 b.v; x.g = A.v^-1 (b.g - A.g x.v); a failed guard solves I x = 0
  float xv[6], xg[6];
  bool x_ok = true;
  if (det_ok) {
#pragma unroll
    for (int i = 0; i < 6; ++i) xv[i] = (float)totals[21 + i];
    lu_solve(lu, piv, xv);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float acc = (float)totals[NPAIR + tri(0, i)] * xv[0];
#pragma unroll
      for (int j = 1; j < 6; ++j) acc = acc + (float)totals[NPAIR + (i <= j ? tri(i, j) : tri(j, i))] * xv[j];
      xg[i] = (float)totals[NPAIR + 21 + i] - acc;
    }
    lu_solve(lu, piv, xg);
#pragma unroll
    for (int i = 0; i < 6; ++i) x_ok = x_ok && !isnan(xv[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 6; ++i) xv[i] = xg[i] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    xv[i] = nan_to_num(xv[i]);
    xg[i] = nan_to_num(xg[i]);
  }
  const bool step_ok = det_ok && x_ok;

  // R_inc = Rz(gamma) Ry(beta) Rx(alpha), dual
  float c[3], s[3], cgd[3], sgd[3];  // cos, sin and their derivative lanes
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    c[i] = cosf(xv[i]);
    s[i] = sinf(xv[i]);
    cgd[i] = (-s[i]) * xg[i];
    sgd[i] = c[i] * xg[i];
  }
  const float Rxv[9] = {1.0f, 0.0f, 0.0f, 0.0f, c[0], -s[0], 0.0f, s[0], c[0]};
  const float Rxg[9] = {0.0f, 0.0f, 0.0f, 0.0f, cgd[0], -sgd[0], 0.0f, sgd[0], cgd[0]};
  const float Ryv[9] = {c[1], 0.0f, s[1], 0.0f, 1.0f, 0.0f, -s[1], 0.0f, c[1]};
  const float Ryg[9] = {cgd[1], 0.0f, sgd[1], 0.0f, 0.0f, 0.0f, -sgd[1], 0.0f, cgd[1]};
  const float Rzv[9] = {c[2], -s[2], 0.0f, s[2], c[2], 0.0f, 0.0f, 0.0f, 1.0f};
  const float Rzg[9] = {cgd[2], -sgd[2], 0.0f, sgd[2], cgd[2], 0.0f, 0.0f, 0.0f, 0.0f};
  float Ryxv[9], Ryxg[9], Riv[9], Rig[9];
  dual_matmul3(Ryv, Ryg, Rxv, Rxg, Ryxv, Ryxg);
  dual_matmul3(Rzv, Rzg, Ryxv, Ryxg, Riv, Rig);

  // t_new = R_inc t + t_inc; R_new = R_inc R; frozen where the step failed
  float Rnv[9], Rng[9];
  dual_matmul3(Riv, Rig, pose + RC_V, pose + RC_G, Rnv, Rng);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float accv = Riv[3 * i] * pose[TC_V];
    float accg = Rig[3 * i] * pose[TC_V] + Riv[3 * i] * pose[TC_G];
#pragma unroll
    for (int l = 1; l < 3; ++l) {
      const float pv = Riv[3 * i + l] * pose[TC_V + l];
      const float pg = Rig[3 * i + l] * pose[TC_V + l] + Riv[3 * i + l] * pose[TC_G + l];
      accv = accv + pv;
      accg = accg + pg;
    }
    t.pose_out[TC_V + i] = step_ok ? accv + xv[3 + i] : pose[TC_V + i];
    t.pose_out[TC_G + i] = step_ok ? accg + xg[3 + i] : pose[TC_G + i];
  }
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    t.pose_out[RC_V + e] = step_ok ? Rnv[e] : pose[RC_V + e];
    t.pose_out[RC_G + e] = step_ok ? Rng[e] : pose[RC_G + e];
  }
  for (int e = RPI_V; e < POSE_FLOATS; ++e) t.pose_out[e] = pose[e];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    t.x_out[i] = xv[i];
    t.x_out[6 + i] = xg[i];
  }
  t.flags[0] = step_ok ? 1 : 0;
  t.flags[1] = (t.first ? 1 : t.flags[1]) & (step_ok ? 1 : 0);
}

// out: A.v (6x6), A.g (6x6), b.v (6), b.g (6) as float32, and the inlier count, from the NQ totals
__device__ __forceinline__ void write_system(const double* totals, float* __restrict__ out, int* __restrict__ inliers,
                                             int t) {
  if (t < 72) {
    const int lane_g = t / 36, e = t % 36;
    out[t] = (float)totals[lane_g * NPAIR + tri(min(e / 6, e % 6), max(e / 6, e % 6))];
  } else if (t < 84) {
    const int lane_g = (t - 72) / 6, i = (t - 72) % 6;
    out[t] = (float)totals[lane_g * NPAIR + 21 + i];
  } else if (t == 84) {
    *inliers = (int)totals[NQ - 1];
  }
}

__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
icp_system_kernel(const float* __restrict__ vcurr, const float* __restrict__ ncurr,
                  const float4* __restrict__ rows, const int* __restrict__ assoc, int* __restrict__ assoc_out,
                  const float* __restrict__ pose, double* partials, unsigned int* ticket,
                  float* __restrict__ out, int* __restrict__ inliers, double* __restrict__ totals_out, Tail tail,
                  Geom g) {
  __shared__ double pixel_rows[WARPS][32 * ROW_STRIDE];
  __shared__ double warp_sums[WARPS][NQ];
  __shared__ double group_sums[GROUPS][64];
  __shared__ double totals[NQ];
  __shared__ bool is_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // lane l < 27 owns the pair (pi, pj) of [J r]: 21 of A's upper triangle, then (i, 6) of b
  int pi = 0, pj = 0;
  if (lane < 21) {
    int l = lane;
    while (l >= 6 - pi) {
      l -= 6 - pi;
      ++pi;
    }
    pj = pi + l;
  } else if (lane < NPAIR) {
    pi = lane - 21;
    pj = 6;
  }

  double sum_v = 0.0, sum_g = 0.0;
  int count = 0;
  double* my_rows = pixel_rows[warp];
  for (int base = (blockIdx.x * WARPS + warp) * 32; base < g.n_curr; base += gridDim.x * BLOCK) {
    const int p = base + lane;
    const bool inlier = p < g.n_curr && pixel_row(p, vcurr, ncurr, rows, assoc, assoc_out, pose, g,
                                                         my_rows + lane * ROW_STRIDE);
    const unsigned int mask = __ballot_sync(0xffffffffu, inlier);
    if (mask == 0u) continue;
    __syncwarp();
    if (lane < NPAIR) {
      for (unsigned int m = mask; m != 0u; m &= m - 1u) {
        const double* r = my_rows + (__ffs(m) - 1) * ROW_STRIDE;
        const double a = r[pi], b = r[pj], ag = r[7 + pi], bg = r[7 + pj];
        sum_v = fma(a, b, sum_v);
        sum_g += fma(ag, b, a * bg);
      }
    }
    count += __popc(mask);
    __syncwarp();
  }

  // block: the warps' sums through shared memory, added in warp order
  if (lane < NPAIR) {
    warp_sums[warp][lane] = sum_v;
    warp_sums[warp][NPAIR + lane] = sum_g;
  }
  if (lane == 0) warp_sums[warp][NQ - 1] = (double)count;  // exact: far below 2^53
  __syncthreads();
  if (threadIdx.x < NQ) {
    double x = 0.0;
    for (int w = 0; w < WARPS; ++w) x += warp_sums[w][threadIdx.x];
    __stcg(&partials[(size_t)blockIdx.x * NQ + threadIdx.x], x);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the last block adds the blocks' partials: thread (group, q) takes blocks
  // group, group + 4, ... in order, then the groups are added in order
  {
    const int q = threadIdx.x & 63, group = threadIdx.x >> 6;
    double x = 0.0;
    if (q < NQ) {
#pragma unroll 8
      for (int b = group; b < (int)gridDim.x; b += GROUPS) x += __ldcg(&partials[(size_t)b * NQ + q]);
    }
    group_sums[group][q] = x;
  }
  __syncthreads();
  if (threadIdx.x < NQ) {
    double x = group_sums[0][threadIdx.x];
    for (int grp = 1; grp < GROUPS; ++grp) x += group_sums[grp][threadIdx.x];
    totals[threadIdx.x] = x;
  }
  __syncthreads();

  write_system(totals, out, inliers, threadIdx.x);
  if (threadIdx.x == 84) {
    *ticket = 0u;  // ready for the next launch on this stream
  } else if (threadIdx.x == BLOCK - 1 && tail.pose_out != nullptr) {
    icp_tail(totals, pose, tail);
  }
  if (totals_out != nullptr && threadIdx.x < NQ) totals_out[threadIdx.x] = totals[threadIdx.x];
}

// B19d: the system and the tail over totals summed elsewhere (one block)
__global__ void __launch_bounds__(128) icp_tail_kernel(const double* __restrict__ summed,
                                                       const float* __restrict__ pose, float* __restrict__ out,
                                                       int* __restrict__ inliers, Tail tail) {
  __shared__ double totals[NQ];
  if (threadIdx.x < NQ) totals[threadIdx.x] = summed[threadIdx.x];
  __syncthreads();
  write_system(totals, out, inliers, threadIdx.x);
  if (threadIdx.x == 127) icp_tail(totals, pose, tail);
}

Geom make_geom(int Hc, int Wc, int Hp, int Wp, float fx, float fy, float cx, float cy, float dist_thres,
               float angle_thres) {
  return Geom{Hc * Wc, Hp, Wp, fx, fy, cx, cy, dist_thres, angle_thres};
}

}  // namespace

// rows: the model's packed rows, (Hp * Wp, 12) float32, 16-byte aligned.
// partials: room for blocks * 55 doubles; ticket: one zeroed unsigned int
// that the kernel leaves zeroed. pose_out (which must not be pose), x_out and
// flags are given together or not at all. assoc_out, an int32 (Hc, Wc) map,
// only where assoc is not given. totals_out: 55 doubles (the 54 sums, the inlier count) or null. All scratch
// belongs to one stream at a time.
extern "C" int xs_icp_system(const void* vcurr, const void* ncurr, const void* rows, const void* assoc,
                             void* assoc_out, const void* pose, void* partials, void* ticket, int blocks, void* out,
                             void* inliers, void* pose_out, void* x_out, void* flags, float damping, int first,
                             int Hc, int Wc, int Hp, int Wp, float fx, float fy, float cx, float cy,
                             float dist_thres, float angle_thres, void* totals_out, void* stream) {
  const Geom g = make_geom(Hc, Wc, Hp, Wp, fx, fy, cx, cy, dist_thres, angle_thres);
  if (blocks < 1 || pose_out == pose || (assoc != nullptr && assoc_out != nullptr)) return (int)cudaErrorInvalidValue;
  if ((pose_out == nullptr) != (x_out == nullptr) || (pose_out == nullptr) != (flags == nullptr))
    return (int)cudaErrorInvalidValue;
  const Tail tail{(float*)pose_out, (float*)x_out, (int*)flags, damping, first};
  icp_system_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)vcurr, (const float*)ncurr, (const float4*)rows, (const int*)assoc, (int*)assoc_out,
      (const float*)pose, (double*)partials, (unsigned int*)ticket, (float*)out, (int*)inliers, (double*)totals_out,
      tail, g);
  return (int)cudaGetLastError();
}

// B19d: totals, 55 doubles in xs_icp_system's totals_out layout (summed over the ranks); pose, pose_out, x_out,
// flags, damping and first as xs_icp_system's tail takes them; out and inliers the summed system as float32
extern "C" int xs_icp_tail(const void* totals, const void* pose, void* out, void* inliers, void* pose_out,
                           void* x_out, void* flags, float damping, int first, void* stream) {
  if (pose_out == nullptr || pose_out == pose || x_out == nullptr || flags == nullptr) return (int)cudaErrorInvalidValue;
  const Tail tail{(float*)pose_out, (float*)x_out, (int*)flags, damping, first};
  icp_tail_kernel<<<1, 128, 0, (cudaStream_t)stream>>>((const double*)totals, (const float*)pose, (float*)out,
                                                       (int*)inliers, tail);
  return (int)cudaGetLastError();
}

extern "C" int xs_icp_associate(const void* vcurr, const void* pose, void* assoc, int Hc, int Wc, int Hp,
                                int Wp, float fx, float fy, float cx, float cy, void* stream) {
  const Geom g = make_geom(Hc, Wc, Hp, Wp, fx, fy, cx, cy, 0.0f, 0.0f);
  icp_associate_kernel<<<(g.n_curr + BLOCK - 1) / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)vcurr, (const float*)pose, (int*)assoc, g);
  return (int)cudaGetLastError();
}
