// The brick-major volume (ops/bricks.py) as the kernels address it: a
// plane of (NB, 512) rows, row b = (bx * nby + by) * nbz + bz of the 8^3
// bricks, lane (x & 7) << 6 | (y & 7) << 3 | (z & 7). Shared by B3c's row
// variant (bricks.cu), B4 (window.cu) and B5 (skip.cu).

#pragma once

#include "dual.cuh"

namespace xs {

constexpr int BRICK_EDGE = 8;
constexpr int BRICK_LANES = 512;

struct Rows {
  int nbx, nby, nbz;  // bricks along x, y, z
  int X, Y, Z;        // voxels along x, y, z
};

__host__ __device__ inline Rows make_rows(int nbx, int nby, int nbz) {
  return {nbx, nby, nbz, nbx * BRICK_EDGE, nby * BRICK_EDGE, nbz * BRICK_EDGE};
}

// ops/bricks.py::flat_index of a voxel inside the volume (the wrapper keeps the volume under 2^31 voxels)
__device__ __forceinline__ unsigned row_index(const Rows& r, int x, int y, int z) {
  const unsigned b = ((unsigned)(x >> 3) * (unsigned)r.nby + (unsigned)(y >> 3)) * (unsigned)r.nbz + (unsigned)(z >> 3);
  return b * (unsigned)BRICK_LANES + ((unsigned)(x & 7) << 6 | (unsigned)(y & 7) << 3 | (unsigned)(z & 7));
}

__device__ __forceinline__ bool in_volume(const Rows& r, const int g[3]) {
  return (unsigned)g[0] < (unsigned)r.X && (unsigned)g[1] < (unsigned)r.Y && (unsigned)g[2] < (unsigned)r.Z;
}

// the voxel of a march sample: floor(p / voxel) as PyTorch's CUDA operator divides by a host number, a multiply
// by the reciprocal taken in double (inv_vs), then ops/sampling.py::to_index
__device__ __forceinline__ void sample_voxel(const float s[3], const float d[3], float t, float inv_vs, int g[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) g[i] = to_index(floorf((s[i] + d[i] * t) * inv_vs));
}

}  // namespace xs
