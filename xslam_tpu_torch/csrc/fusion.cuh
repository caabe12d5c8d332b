// The per-voxel arithmetic of dual TSDF fusion, shared by K2 (fusion.cu, the
// dense pass) and B3c (bricks.cu, the brick pass), so that a voxel's gate
// and update have the same bits in both.
//
// Port of xslam_tpu/ops/fusion.py::_voxel_update, nearest-depth branch
// (reference TsdfFusion.cu:85-171): dual camera coordinates of the voxel,
// summed ((a + b) + c) + t; the in-front test and the pixel gate
// floor(img - 0.5) in (1, W-1) x (1, H-1); the nearest depth at round(img)
// (rintf: half to even, as jnp.round); the dual SDF dp * sqrt(lambda^2) -
// |v_c|; the truncation gate and the "beyond" saturation; the running average
// with the weight clamp. Each function runs the reference's operations in its
// order, one rounding at a time (the sources build with -fmad=false); terms
// that the reference multiplies by a lifted constant's zero derivative are
// dropped, which changes no finite result.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace xs {

struct FuseParams {
  int X, Y, Z, H, W;
  float vs, fx, fy, cx, cy, inv_fx, inv_fy, trunc, inv_trunc, max_w;
};

// The 24 pose floats of the dual volume->camera pose: R.v (row-major 3x3),
// R.g, t.v, t.g.
struct FusePose {
  const float* Rv;
  const float* Rg;
  const float* tv;
  const float* tg;
  __device__ explicit FusePose(const float* pose) : Rv(pose), Rg(pose + 9), tv(pose + 18), tg(pose + 21) {}
};

// The part of a voxel's camera coordinates that its z column shares:
// R[i][0] gx + R[i][1] gy, both lanes. The reference adds ((a + b) + c) + t,
// so hoisting (a + b) keeps every bit.
struct ColumnSums {
  float v[3], g[3];
};

__device__ __forceinline__ float voxel_centre(int i, float vs) { return ((float)i + 0.5f) * vs; }

__device__ __forceinline__ ColumnSums column_sums(const FusePose& pose, float gx, float gy) {
  ColumnSums s;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.v[i] = pose.Rv[3 * i] * gx + pose.Rv[3 * i + 1] * gy;
    s.g[i] = pose.Rg[3 * i] * gx + pose.Rg[3 * i + 1] * gy;
  }
  return s;
}

// A voxel taken up to its pixel gate: dual camera coordinates, dual image
// coordinates, and whether it lies in front of the camera with its pixel
// inside the gate.
struct VoxelView {
  float cv[3], cg[3];  // camera coordinates, value and derivative lanes
  float ixv, ixg, iyv, iyg;
  bool gated;
};

__device__ __forceinline__ VoxelView voxel_view(const FusePose& pose, const FuseParams& p, const ColumnSums& s,
                                                float gz) {
  VoxelView o;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o.cv[i] = (s.v[i] + pose.Rv[3 * i + 2] * gz) + pose.tv[i];
    o.cg[i] = (s.g[i] + pose.Rg[3 * i + 2] * gz) + pose.tg[i];
  }
  // inv_z = 1 / v_c.z
  const float izv = 1.0f / o.cv[2];
  const float izg = (0.0f - izv * o.cg[2]) * izv;
  const bool in_front = izv >= 0.0f;

  // image = v_c * f * inv_z + c
  const float axv = o.cv[0] * p.fx, axg = o.cg[0] * p.fx;
  o.ixv = axv * izv + p.cx;
  o.ixg = axg * izv + axv * izg;
  const float ayv = o.cv[1] * p.fy, ayg = o.cg[1] * p.fy;
  o.iyv = ayv * izv + p.cy;
  o.iyg = ayg * izv + ayv * izg;

  // pixel gate on floor(img - 0.5), compared as floats (NaN fails)
  const float cxf = floorf(o.ixv - 0.5f), cyf = floorf(o.iyv - 0.5f);
  const bool in_bounds = cxf > 1.0f && cyf > 1.0f && cxf < (float)(p.W - 1) && cyf < (float)(p.H - 1);
  o.gated = in_front && in_bounds;
  return o;
}

// The "beyond" sample 1 + 0i that a voxel takes past +trunc.
constexpr float BEYOND_V = 1.0f, BEYOND_G = 0.0f;

// The running average with the weight clamp, for a TSDF sample (tsv, tsg),
// on a voxel's (value, grad, weight) held in registers.
__device__ __forceinline__ void average(float& v, float& g, float& w, float tsv, float tsg, float max_w) {
  const float inv = 1.0f / (w + 1.0f);
  v = (v * w + tsv) * inv;
  g = (g * w + tsg) * inv;
  w = fminf(w + 1.0f, max_w);
}

// The depth pixel a gated voxel reads: round(img), inside the gate in
// [2, size-1].
__device__ __forceinline__ int depth_index(const VoxelView& o, const FuseParams& p) {
  return __float2int_rn(o.iyv) * p.W + __float2int_rn(o.ixv);
}

// The TSDF sample of a gated voxel from its nearest depth dv: the dual SDF
// and the truncation gate. Computed whatever dv is; false where dv is not
// positive or the voxel lies beyond the band behind the surface: the voxel
// is then left as it is.
__device__ __forceinline__ bool sample_at(float dv, const FuseParams& p, const VoxelView& o, float& tsv, float& tsg) {
  // lambda^2 = xl^2 + yl^2 + 1 with xl = (img_x - cx) / fx
  const float xlv = (o.ixv - p.cx) * p.inv_fx, xlg = o.ixg * p.inv_fx;
  const float ylv = (o.iyv - p.cy) * p.inv_fy, ylg = o.iyg * p.inv_fy;
  const float l2v = (xlv * xlv + ylv * ylv) + 1.0f;
  const float l2g = (xlg * xlv + xlv * xlg) + (ylg * ylv + ylv * ylg);
  const float slv = sqrtf(l2v);
  const float slg = (0.5f * l2g) / slv;

  // |v_c|
  const float nv = (o.cv[0] * o.cv[0] + o.cv[1] * o.cv[1]) + o.cv[2] * o.cv[2];
  const float ng = (o.cg[0] * o.cv[0] + o.cv[0] * o.cg[0]) + (o.cg[1] * o.cv[1] + o.cv[1] * o.cg[1]) +
                   (o.cg[2] * o.cv[2] + o.cv[2] * o.cg[2]);
  const float snv = sqrtf(nv);
  const float sng = (0.5f * ng) / snv;

  const float sdfv = dv * slv - snv;
  const float sdfg = dv * slg - sng;
  const bool beyond = sdfv > p.trunc;  // constant 1 + 0i past +trunc
  tsv = beyond ? BEYOND_V : sdfv * p.inv_trunc;
  tsg = beyond ? BEYOND_G : sdfg * p.inv_trunc;
  return dv > 0.0f && sdfv >= -p.trunc;
}

// The exact update of a gated voxel in the planes: its nearest depth, its
// sample, then the running average. Writes nothing where the depth is 0 or
// sample_at says so.
__device__ __forceinline__ void fuse_gated_voxel(float* __restrict__ value, float* __restrict__ grad,
                                                 float* __restrict__ weight, const float* __restrict__ depth,
                                                 const FuseParams& p, const VoxelView& o, size_t idx) {
  const float dv = depth[depth_index(o, p)];
  float tsv, tsg;
  if (!(dv > 0.0f) || !sample_at(dv, p, o, tsv, tsg)) return;
  float v = value[idx], g = grad[idx], w = weight[idx];
  average(v, g, w, tsv, tsg, p.max_w);
  value[idx] = v;
  grad[idx] = g;
  weight[idx] = w;
}

}  // namespace xs
