// K1: 13x13 bilateral filter of a uint16 depth map (mm) -> float32 (mm).
//
// Replaces xslam_tpu/ops/pallas_kernels.py::bilateral_filter_pallas
// (_bilateral_kernel); oracle xslam_tpu/ops/preprocess.py::bilateral_filter,
// reference Map.cu:155-199. R = 6, sigma_space 4.5 px, sigma_color 30 mm. A
// neighbour counts only if its row and column lie in [0, size-2]; the result
// is rounded half to even (rintf, as jnp.round / torch.round; CUDA's roundf
// rounds half away from zero), zeroed outside [200, 5000] mm and clipped to
// [0, 32767].
//
// Bound on the H100: operations. 169 taps per pixel, each an expf and a few
// multiply-adds, against 6 bytes of device memory per pixel (u16 in, f32 out).
// Design: one thread per output pixel; a block stages its 32x8 tile plus the
// 6-pixel halo, converted to float, in shared memory once, so the 169 taps
// read shared memory and device memory is read about 2.3 times per pixel
// instead of 169. No fast-math: the sum is rounded to an integer, so expf and
// the division keep their IEEE-accurate forms, and the tap order (dy outer,
// dx inner) is the reference's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 6;
constexpr int TX = 32;
constexpr int TY = 8;
constexpr int SW = TX + 2 * R;
constexpr int SH = TY + 2 * R;

__global__ void bilateral_kernel(const uint16_t* __restrict__ src, float* __restrict__ dst, int H, int W) {
  __shared__ float tile[SH][SW];
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  for (int i = threadIdx.y * TX + threadIdx.x; i < SH * SW; i += TX * TY) {
    const int ty = i / SW, tx = i % SW;
    const int gy = y0 + ty - R, gx = x0 + tx - R;
    tile[ty][tx] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? (float)src[gy * W + gx] : 0.0f;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  // 0.5 / sigma^2 computed in double and rounded once, as the reference's
  // Python-float constants are
  const float inv_ss = (float)(0.5 / (4.5 * 4.5));
  const float inv_sc = (float)(0.5 / (30.0 * 30.0));
  const float center = tile[threadIdx.y + R][threadIdx.x + R];
  float sum1 = 0.0f, sum2 = 0.0f;
  for (int dy = -R; dy <= R; ++dy) {
    const int ny = y + dy;
    if (ny < 0 || ny > H - 2) continue;  // invalid taps add exactly 0
    for (int dx = -R; dx <= R; ++dx) {
      const int nx = x + dx;
      if (nx < 0 || nx > W - 2) continue;
      const float nbr = tile[threadIdx.y + R + dy][threadIdx.x + R + dx];
      const float space2 = (float)(dy * dy + dx * dx);
      const float diff = center - nbr;
      const float color2 = diff * diff;
      const float w = expf(-(space2 * inv_ss + color2 * inv_sc));
      sum1 = sum1 + nbr * w;
      sum2 = sum2 + w;
    }
  }
  float res = rintf(sum1 / sum2);
  if (res > 5000.0f || res < 200.0f) res = 0.0f;
  // clip without fminf/fmaxf, which would turn a NaN (0/0 at the last
  // row/column) into a number where jnp.clip keeps it
  if (res > 32767.0f) res = 32767.0f;
  if (res < 0.0f) res = 0.0f;
  dst[y * W + x] = res;
}

}  // namespace

extern "C" int xs_bilateral_filter(const void* src, void* dst, int H, int W, void* stream) {
  const dim3 block(TX, TY);
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  bilateral_kernel<<<grid, block, 0, (cudaStream_t)stream>>>((const uint16_t*)src, (float*)dst, H, W);
  return (int)cudaGetLastError();
}
