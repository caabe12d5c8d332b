// K6, K7, K8: the small image kernels around the march and the bilateral
// filter, one launch each where the plain PyTorch versions take dozens of
// operators. All three are bound by bytes on the H100 (a few operations per
// pixel against 4 to 96 bytes moved), and at these image sizes (at most
// 480 x 640) by the launch itself; the design is one thread per output pixel,
// neighbouring threads on neighbouring addresses, every intermediate in
// registers. Each follows its plain version one rounding at a time (built
// with -fmad=false).
//
// K6 xs_resize_model_maps: one level of the model-map pyramid, both maps,
//   both lanes. Replaces the XLA code of xslam_tpu/ops/preprocess.py::
//   resize_vmap (_resize_map) applied to the vertex map's value and
//   derivative, and of xslam_tpu/models/kinfu.py::_resize_nmap_dual;
//   reference resizeMapKernel, Map.cu:105-152. 2 x 2 mean (the two column
//   sums added, times 0.25, which is the order torch.mean reduces them in on
//   the card); a vertex lane is NaN
//   where any of ITS four first-channel entries is NaN; the normal is
//   renormalised as a dual vector and is (NaN, 0) where any of the four
//   value-lane first-channel entries is NaN.
// K7 xs_pyr_down: one level of the depth pyramid. Replaces xslam_tpu/ops/
//   preprocess.py::pyr_down; reference pyrDownKernel, Map.cu:202-230. The
//   source rounded half to even, a 5 x 5 window at stride 2, a neighbour
//   counted where its row and column lie in [0, size - 2] and it is within
//   90 mm of the centre, taps added dy outer, dx inner, floor(sum / max(cnt,
//   1)).
// K8 xs_vertex_normal_maps: the vertex and normal maps of every pyramid
//   level, one launch. Replaces xslam_tpu/ops/preprocess.py::create_vmap and
//   ::create_nmap on each level; reference computeVmapKernel,
//   computeNmapKernel, Map.cu:8-70. The vertices of the pixel and of its right
//   and lower neighbours are recomputed in registers (z = d / 1000, then
//   z * (u - cx) / fx), so the normal needs no second pass over a stored
//   vertex map. A division by a host scalar is a multiply by its reciprocal
//   (taken in double, rounded to float32), which is how PyTorch's CUDA
//   operator rounds it, so the maps have the bits of the plain versions' on
//   the card. The levels' depths, shapes, cameras and output places travel
//   by value in one struct; the flat grid holds level 0's blocks first, so
//   the largest level starts first and the small ones fill its tail (a level
//   of 120 x 160 alone is 75 blocks: 57% of the SMs, for a launch's floor).

#include <cuda_runtime.h>

#include "rays.cuh"

namespace {

using xs::Camera;
using xs::Dual;

constexpr int BLOCK = 256;
constexpr int MAX_MAP_LEVELS = 3;  // ops/kernels.py::MAX_MAP_LEVELS

// 2 x 2 mean of channel c at output pixel (oy, ox), as torch.mean over the
// (2, 4) axes of reshape(3, oh, 2, ow, 2) adds the four on the card (measured:
// the upper and lower entry of each column first, then the two columns)
__device__ __forceinline__ float mean4(const float* __restrict__ m, int HW, int W, int c, int oy, int ox) {
  const float* q = m + (long long)c * HW + (2 * oy) * W + 2 * ox;
  return ((q[0] + q[W]) + (q[1] + q[W + 1])) * 0.25f;
}

__device__ __forceinline__ bool any_nan4(const float* __restrict__ m, int W, int oy, int ox) {
  const float* q = m + (2 * oy) * W + 2 * ox;
  return isnan(q[0]) || isnan(q[1]) || isnan(q[W]) || isnan(q[W + 1]);
}

__global__ void __launch_bounds__(BLOCK)
    resize_model_maps_kernel(const float* __restrict__ vv, const float* __restrict__ vg,
                             const float* __restrict__ nv, const float* __restrict__ ng, float* __restrict__ out_vv,
                             float* __restrict__ out_vg, float* __restrict__ out_nv, float* __restrict__ out_ng,
                             int H, int W) {
  const int oh = H / 2, ow = W / 2;
  const int o = blockIdx.x * BLOCK + threadIdx.x;
  if (o >= oh * ow) return;
  const int oy = o / ow, ox = o % ow;
  const int HW = H * W, OHW = oh * ow;

  const bool v_nan = any_nan4(vv, W, oy, ox), g_nan = any_nan4(vg, W, oy, ox);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out_vv[c * OHW + o] = v_nan ? xs::quiet_nan() : mean4(vv, HW, W, c, oy, ox);
    out_vg[c * OHW + o] = g_nan ? xs::quiet_nan() : mean4(vg, HW, W, c, oy, ox);
  }

  const bool n_nan = any_nan4(nv, W, oy, ox);
  Dual avg[3], unit[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    avg[c] = {mean4(nv, HW, W, c, oy, ox), mean4(ng, HW, W, c, oy, ox)};
    if (n_nan) avg[c] = {1.0f, 0.0f};
  }
  xs::normalized3(avg, unit);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out_nv[c * OHW + o] = n_nan ? xs::quiet_nan() : unit[c].v;
    out_ng[c * OHW + o] = n_nan ? 0.0f : unit[c].g;
  }
}

__global__ void __launch_bounds__(BLOCK)
    pyr_down_kernel(const float* __restrict__ src, float* __restrict__ dst, int H, int W) {
  const int oh = H / 2, ow = W / 2;
  const int o = blockIdx.x * BLOCK + threadIdx.x;
  if (o >= oh * ow) return;
  const int y = 2 * (o / ow), x = 2 * (o % ow);
  const float center = rintf(src[y * W + x]);
  float sum = 0.0f, cnt = 0.0f;
  for (int dy = -2; dy <= 2; ++dy) {
    const int ny = y + dy;
    if (ny < 0 || ny > H - 2) continue;  // a tap that does not count adds exactly 0
#pragma unroll
    for (int dx = -2; dx <= 2; ++dx) {
      const int nx = x + dx;
      if (nx < 0 || nx > W - 2) continue;
      const float nbr = rintf(src[ny * W + nx]);
      if (fabsf(nbr - center) < 90.0f) {
        sum = sum + nbr;
        cnt = cnt + 1.0f;
      }
    }
  }
  dst[o] = floorf(sum / fmaxf(cnt, 1.0f));
}

// create_vmap at one pixel; false where the depth is 0 (the vertex is NaN)
__device__ __forceinline__ bool vertex_of(const float* __restrict__ depth, int W, int x, int y, const Camera& cam,
                                          float v[3]) {
  const float z = depth[y * W + x] * 0.001f;  // d / 1000.0 as the card rounds it: d * float(1.0 / 1000.0)
  v[0] = (z * ((float)x - cam.cx)) * cam.inv_fx;
  v[1] = (z * ((float)y - cam.cy)) * cam.inv_fy;
  v[2] = z;
  return z != 0.0f;
}

// one level of the pyramid: its depth (H, W), its (3, H, W) maps, its first block
struct MapLevel {
  const float* depth;
  float* vmap;
  float* nmap;
  int H, W, first_block;
  Camera cam;
};

struct MapPyramid {
  MapLevel level[MAX_MAP_LEVELS];
  int levels;
};

__global__ void __launch_bounds__(BLOCK) vertex_normal_maps_kernel(const MapPyramid pyr) {
  // the block's level, picked by selects (the struct stays in parameter space)
  MapLevel lv = pyr.level[0];
#pragma unroll
  for (int l = 1; l < MAX_MAP_LEVELS; ++l) {
    if (l < pyr.levels && (int)blockIdx.x >= pyr.level[l].first_block) lv = pyr.level[l];
  }
  const int pix = ((int)blockIdx.x - lv.first_block) * BLOCK + threadIdx.x;
  const int H = lv.H, W = lv.W, HW = H * W;
  if (pix >= HW) return;
  const int y = pix / W, x = pix % W;
  const float nan = xs::quiet_nan();
  float v00[3], v01[3], v10[3];
  const bool ok00 = vertex_of(lv.depth, W, x, y, lv.cam, v00);
#pragma unroll
  for (int c = 0; c < 3; ++c) lv.vmap[c * HW + pix] = ok00 ? v00[c] : nan;

  // the right and lower neighbours: NaN beyond the last column and row
  bool ok = ok00 && x + 1 < W && y + 1 < H;
  if (ok) {
    const bool ok01 = vertex_of(lv.depth, W, x + 1, y, lv.cam, v01);
    const bool ok10 = vertex_of(lv.depth, W, x, y + 1, lv.cam, v10);
    ok = ok01 && ok10;
  }
  float n[3] = {nan, nan, nan};
  if (ok) {
    float a[3], b[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a[c] = v01[c] - v00[c];
      b[c] = v10[c] - v00[c];
    }
    const float cr[3] = {a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]};
    const float norm = sqrtf((cr[0] * cr[0] + cr[1] * cr[1]) + cr[2] * cr[2]);
    if (norm != 0.0f) {
#pragma unroll
      for (int c = 0; c < 3; ++c) n[c] = cr[c] / norm;
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) lv.nmap[c * HW + pix] = n[c];
}

}  // namespace

extern "C" int xs_resize_model_maps(const void* vv, const void* vg, const void* nv, const void* ng, void* out_vv,
                                    void* out_vg, void* out_nv, void* out_ng, int H, int W, void* stream) {
  const int n = (H / 2) * (W / 2);
  resize_model_maps_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)vv, (const float*)vg, (const float*)nv, (const float*)ng, (float*)out_vv, (float*)out_vg,
      (float*)out_nv, (float*)out_ng, H, W);
  return (int)cudaGetLastError();
}

extern "C" int xs_pyr_down(const void* src, void* dst, int H, int W, void* stream) {
  const int n = (H / 2) * (W / 2);
  pyr_down_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>((const float*)src, (float*)dst, H,
                                                                               W);
  return (int)cudaGetLastError();
}

// levels: 1 to MAX_MAP_LEVELS. depths[l]: (H[l], W[l]); the maps of level l at
// out + offsets[2 l] (vertex) and out + offsets[2 l + 1] (normal), each
// (3, H[l], W[l]); cams[4 l ...]: cx, cy, 1 / fx, 1 / fy
extern "C" int xs_vertex_normal_maps(const void* const* depths, const int* H, const int* W, void* out,
                                     const long long* offsets, const float* cams, int levels, void* stream) {
  if (levels < 1 || levels > MAX_MAP_LEVELS) return (int)cudaErrorInvalidValue;
  MapPyramid pyr{};
  pyr.levels = levels;
  int blocks = 0;
  for (int l = 0; l < levels; ++l) {
    const float* c = cams + 4 * l;
    pyr.level[l] = MapLevel{(const float*)depths[l], (float*)out + offsets[2 * l], (float*)out + offsets[2 * l + 1],
                            H[l], W[l], blocks, Camera{c[0], c[1], c[2], c[3]}};
    blocks += (H[l] * W[l] + BLOCK - 1) / BLOCK;
  }
  vertex_normal_maps_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(pyr);
  return (int)cudaGetLastError();
}
