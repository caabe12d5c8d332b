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
// Bound on the H100: operations, and among them the accurate expf of each of
// the 169 taps a pixel (some 25 operations with its range reduction, one of
// them on the quarter-rate special-function unit), against 6 bytes of device
// memory a pixel. What the design does about it:
//
// - No expf in the tap loop. The weight is exp(-(space2 * inv_ss + diff^2 *
//   inv_sc)); space2 = dy^2 + dx^2 takes 27 distinct values, and the depths
//   are whole millimetres, so diff is an integer and the weight is exactly 0
//   in float32 from |diff| = 440 on. The 27 x 448 weights are a table (48
//   KB), made once for a device by xs_bilateral_weights with the tap's own
//   expression and the same expf; a block copies it into shared memory, then
//   a tap is one table read at (space2's rank, min(|diff|, 447)): the bits
//   of the weight are those of the direct evaluation, so the output equals
//   the plain version's as the earlier kernel's did.
// - The index comes without a float-to-int conversion (quarter rate): |diff|
//   + 2^23 has the integer in its low mantissa bits.
// - A thread computes P = 2 horizontally adjacent pixels from a register
//   window of P + 12 tile values per row (vector shared-memory reads), so a
//   tap costs a fraction of a tile read, one table read and five float
//   operations.
// - The [0, size-2] rule and the image border need no branch: a tile cell
//   that may not count holds -1e6, whose |diff| clamps to the table's zero
//   column, and nbr * 0 adds nothing. The centre is read from the image.
// - Tap order (dy outer, dx inner), rintf, the division and the NaN-keeping
//   clip are the reference's; no fast math.
//
// 264 blocks (two a multiprocessor of the H100) walk over the 64 x 8 pixel
// tiles, so the table is copied once for two or three tiles. Measured beside
// it and slower: 128 x 8 and 128 x 4 tiles at 4 pixels a thread, a block a
// tile, the table filled by every block (47 expf a thread), one expf a tap
// with the window and a skip of taps past the underflow, and the earlier
// design (one thread a pixel, one expf and one shared-memory read a tap).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 6;
constexpr int TXT = 32, TYT = 8;     // threads of a block
constexpr int P = 2;                 // horizontally adjacent pixels a thread
constexpr int BLOCKS = 264;          // the grid, where there are that many tiles
constexpr int NS = 27;               // distinct dy^2 + dx^2 for |dy|, |dx| <= 6
constexpr int ND = 448;              // |diff| columns; the last holds exactly 0
constexpr float OUTSIDE = -1e6f;     // a tile cell that may not count
constexpr float MAGIC = 8388608.0f;  // 2^23

// rank of dy^2 + dx^2 among its distinct values, by (|dy|, |dx|), and the values
__constant__ unsigned char S_RANK[7 * 7] = {
    0,  1,  3,  6,  9,  13, 18,  //
    1,  2,  4,  7,  10, 14, 19,  //
    3,  4,  5,  8,  12, 15, 20,  //
    6,  7,  8,  11, 13, 17, 22,  //
    9,  10, 12, 13, 16, 21, 24,  //
    13, 14, 15, 17, 21, 23, 25,  //
    18, 19, 20, 22, 24, 25, 26};
__constant__ float S_VALUE[NS] = {0,  1,  2,  4,  5,  8,  9,  10, 13, 16, 17, 18, 20, 25,
                                  26, 29, 32, 34, 36, 37, 40, 41, 45, 50, 52, 61, 72};

// 0.5 / sigma^2 computed in double and rounded once, as the reference's
// Python-float constants are
__device__ __forceinline__ float inv_sigma_space() { return (float)(0.5 / (4.5 * 4.5)); }
__device__ __forceinline__ float inv_sigma_color() { return (float)(0.5 / (30.0 * 30.0)); }

// entry i of the [NS][ND] weight table: the tap's own expression
__global__ void bilateral_weights_kernel(float* __restrict__ table) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NS * ND) return;
  const int d = i % ND;
  const float color2 = (float)d * (float)d;
  table[i] = expf(-(S_VALUE[i / ND] * inv_sigma_space() + color2 * inv_sigma_color()));
}

__device__ __forceinline__ float finish(float sum1, float sum2) {
  float res = rintf(sum1 / sum2);
  if (res > 5000.0f || res < 200.0f) res = 0.0f;
  // clip without fminf/fmaxf, which would turn a NaN (0/0 at the last
  // row/column) into a number where jnp.clip keeps it
  if (res > 32767.0f) res = 32767.0f;
  if (res < 0.0f) res = 0.0f;
  return res;
}

// a tile of (TXT * P) x TYT pixels at a time
__global__ void __launch_bounds__(TXT* TYT)
    bilateral_kernel(const uint16_t* __restrict__ src, const float* __restrict__ weights, float* __restrict__ dst,
                     int H, int W, int tiles_x, int n_tiles) {
  constexpr int TW = TXT * P, TH = TYT, SW = TW + 2 * R, SH = TH + 2 * R, THREADS = TXT * TYT;
  constexpr int WIN = P + 2 * R;  // tile values one row gives a thread's pixels
  static_assert(WIN % P == 0 && SW % P == 0 && (NS * ND) % 4 == 0, "the window is read as vectors of P floats");
  extern __shared__ __align__(16) float smem[];
  float* table = smem;           // [NS][ND]
  float* tile = smem + NS * ND;  // [SH][SW]
  const int tid = threadIdx.y * TXT + threadIdx.x;
  for (int i = tid; i < NS * ND / 4; i += THREADS)
    reinterpret_cast<float4*>(table)[i] = reinterpret_cast<const float4*>(weights)[i];
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int x0 = (t % tiles_x) * TW, y0 = (t / tiles_x) * TH;
    __syncthreads();  // the table is there; the previous tile is done with
    for (int i = tid; i < SH * SW; i += THREADS) {
      const int gy = y0 + i / SW - R, gx = x0 + i % SW - R;
      tile[i] = (gy >= 0 && gy <= H - 2 && gx >= 0 && gx <= W - 2) ? (float)src[gy * W + gx] : OUTSIDE;
    }
    __syncthreads();

    const int y = y0 + threadIdx.y, px = x0 + threadIdx.x * P;
    if (y >= H || px >= W) continue;
    float center[P], sum1[P], sum2[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      center[p] = px + p < W ? (float)src[y * W + px + p] : 0.0f;
      sum1[p] = 0.0f;
      sum2[p] = 0.0f;
    }
#pragma unroll 1
    for (int dy = -R; dy <= R; ++dy) {
      const float* row = tile + (threadIdx.y + R + dy) * SW + threadIdx.x * P;
      float win[WIN];
#pragma unroll
      for (int q = 0; q < WIN / P; ++q) {
        const float2 v = reinterpret_cast<const float2*>(row)[q];
        win[2 * q] = v.x, win[2 * q + 1] = v.y;
      }
      const int ady = dy < 0 ? -dy : dy;
#pragma unroll
      for (int dx = -R; dx <= R; ++dx) {
        const int rank = S_RANK[ady * 7 + (dx < 0 ? -dx : dx)];
        const float* column = table + rank * ND;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float nbr = win[p + dx + R];
          const float diff = center[p] - nbr;
          const float at = fminf(fabsf(diff), (float)(ND - 1)) + MAGIC;
          const float w = column[__float_as_int(at) & 0x1ff];
          sum1[p] = sum1[p] + nbr * w;
          sum2[p] = sum2[p] + w;
        }
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (px + p < W) dst[y * W + px + p] = finish(sum1[p], sum2[p]);
  }
}

}  // namespace

// the [27][448] weight table, made once for a device and handed to every launch
extern "C" int xs_bilateral_weights(void* table, void* stream) {
  bilateral_weights_kernel<<<(NS * ND + 255) / 256, 256, 0, (cudaStream_t)stream>>>((float*)table);
  return (int)cudaGetLastError();
}

extern "C" int xs_bilateral_filter(const void* src, const void* weights, void* dst, int H, int W, void* stream) {
  constexpr int TW = TXT * P, TH = TYT;
  const int tiles_x = (W + TW - 1) / TW, n_tiles = tiles_x * ((H + TH - 1) / TH);
  const int bytes = (NS * ND + (TH + 2 * R) * (TW + 2 * R)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(bilateral_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  bilateral_kernel<<<n_tiles < BLOCKS ? n_tiles : BLOCKS, dim3(TXT, TYT), bytes, (cudaStream_t)stream>>>(
      (const uint16_t*)src, (const float*)weights, (float*)dst, H, W, tiles_x, n_tiles);
  return (int)cudaGetLastError();
}
