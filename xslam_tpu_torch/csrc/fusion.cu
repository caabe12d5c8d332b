// K2: dual TSDF fusion of one depth frame, in place.
//
// Replaces the XLA code of xslam_tpu/ops/fusion.py::_voxel_update, nearest-
// depth branch (bi_threshold <= 0), called from fusion.integrate; reference
// TsdfFusion.cu:85-171. Per voxel: dual camera coordinates from the dual
// volume->camera pose; the in-front test and the pixel gate floor(img - 0.5)
// in (1, W-1) x (1, H-1); the nearest depth at round(img) (rintf: half to
// even, as jnp.round); the dual SDF dp * sqrt(lambda^2) - |v_c|; the
// truncation gate and the "beyond" saturation; the running average with the
// weight clamp. value, grad and weight are read and rewritten only where the
// frame updates the voxel: every other voxel returns at a gate first.
//
// Bound on the H100: operations. Every voxel does the 69 operations up to
// the pixel gate (dual camera coordinates and projection); only the voxels
// the frame updates (about 6% of a 256^3 volume on the synthetic orbit) do
// the other 60 and move 24 bytes each (three planes read and written), plus
// the 1.2 MB depth image. Design: one thread per voxel, z fastest, so a
// warp's updated voxels of each plane lie in neighbouring addresses; the 24
// pose floats come from a small device tensor (no host read), and the depth
// image stays in L2. The dual arithmetic repeats the reference's
// operation order one rounding at a time (built with -fmad=false); terms
// that the reference multiplies by a lifted constant's zero derivative are
// dropped, which changes no finite result.

#include <cuda_runtime.h>

namespace {

struct Params {
  int X, Y, Z, H, W;
  float vs, fx, fy, cx, cy, inv_fx, inv_fy, trunc, inv_trunc, max_w;
};

__global__ void fuse_kernel(float* __restrict__ value, float* __restrict__ grad, float* __restrict__ weight,
                            const float* __restrict__ depth, const float* __restrict__ pose, Params p) {
  const long long n = (long long)p.X * p.Y * p.Z;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int z = (int)(idx % p.Z);
  const int y = (int)((idx / p.Z) % p.Y);
  const int x = (int)(idx / ((long long)p.Y * p.Z));

  // pose layout: R.v (row-major 3x3), R.g, t.v, t.g
  const float* Rv = pose;
  const float* Rg = pose + 9;
  const float* tv = pose + 18;
  const float* tg = pose + 21;

  const float gx = ((float)x + 0.5f) * p.vs;
  const float gy = ((float)y + 0.5f) * p.vs;
  const float gz = ((float)z + 0.5f) * p.vs;

  float cv[3], cg[3];  // camera coordinates, value and derivative lanes
  for (int i = 0; i < 3; ++i) {
    cv[i] = ((Rv[3 * i] * gx + Rv[3 * i + 1] * gy) + Rv[3 * i + 2] * gz) + tv[i];
    cg[i] = ((Rg[3 * i] * gx + Rg[3 * i + 1] * gy) + Rg[3 * i + 2] * gz) + tg[i];
  }

  // inv_z = 1 / v_c.z
  const float izv = 1.0f / cv[2];
  const float izg = (0.0f - izv * cg[2]) * izv;
  const bool in_front = izv >= 0.0f;

  // image = v_c * f * inv_z + c
  const float axv = cv[0] * p.fx, axg = cg[0] * p.fx;
  const float ixv = axv * izv + p.cx;
  const float ixg = axg * izv + axv * izg;
  const float ayv = cv[1] * p.fy, ayg = cg[1] * p.fy;
  const float iyv = ayv * izv + p.cy;
  const float iyg = ayg * izv + ayv * izg;

  // pixel gate on floor(img - 0.5), compared as floats (NaN fails)
  const float cxf = floorf(ixv - 0.5f), cyf = floorf(iyv - 0.5f);
  const bool in_bounds = cxf > 1.0f && cyf > 1.0f && cxf < (float)(p.W - 1) && cyf < (float)(p.H - 1);
  if (!(in_front && in_bounds)) return;

  // inside the gate, round(img) lies in [2, size-1]
  const int px = __float2int_rn(ixv), py = __float2int_rn(iyv);
  const float dv = depth[py * p.W + px];
  if (!(dv > 0.0f)) return;

  // lambda^2 = xl^2 + yl^2 + 1 with xl = (img_x - cx) / fx
  const float xlv = (ixv - p.cx) * p.inv_fx, xlg = ixg * p.inv_fx;
  const float ylv = (iyv - p.cy) * p.inv_fy, ylg = iyg * p.inv_fy;
  const float l2v = (xlv * xlv + ylv * ylv) + 1.0f;
  const float l2g = (xlg * xlv + xlv * xlg) + (ylg * ylv + ylv * ylg);
  const float slv = sqrtf(l2v);
  const float slg = (0.5f * l2g) / slv;

  // |v_c|
  const float nv = (cv[0] * cv[0] + cv[1] * cv[1]) + cv[2] * cv[2];
  const float ng = (cg[0] * cv[0] + cv[0] * cg[0]) + (cg[1] * cv[1] + cv[1] * cg[1]) + (cg[2] * cv[2] + cv[2] * cg[2]);
  const float snv = sqrtf(nv);
  const float sng = (0.5f * ng) / snv;

  const float sdfv = dv * slv - snv;
  const float sdfg = dv * slg - sng;
  if (!(sdfv >= -p.trunc)) return;

  float tsv = sdfv * p.inv_trunc, tsg = sdfg * p.inv_trunc;
  if (sdfv > p.trunc) {  // constant 1 + 0i past +trunc
    tsv = 1.0f;
    tsg = 0.0f;
  }

  const float w = weight[idx];
  const float inv = 1.0f / (w + 1.0f);
  value[idx] = (value[idx] * w + tsv) * inv;
  grad[idx] = (grad[idx] * w + tsg) * inv;
  weight[idx] = fminf(w + 1.0f, p.max_w);
}

}  // namespace

extern "C" int xs_fuse_volume(void* value, void* grad, void* weight, const void* depth, const void* pose,
                              int X, int Y, int Z, int H, int W,
                              float vs, float fx, float fy, float cx, float cy,
                              float inv_fx, float inv_fy, float trunc, float inv_trunc, float max_w,
                              void* stream) {
  const Params p{X, Y, Z, H, W, vs, fx, fy, cx, cy, inv_fx, inv_fy, trunc, inv_trunc, max_w};
  const long long n = (long long)X * Y * Z;
  const int block = 256;
  const unsigned int grid = (unsigned int)((n + block - 1) / block);
  fuse_kernel<<<grid, block, 0, (cudaStream_t)stream>>>((float*)value, (float*)grad, (float*)weight,
                                                        (const float*)depth, (const float*)pose, p);
  return (int)cudaGetLastError();
}
