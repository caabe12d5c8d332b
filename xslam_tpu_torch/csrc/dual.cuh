// First-order dual numbers on the device, for the kernels that carry the
// derivative lane: the arithmetic of xslam_tpu_torch/csfd/single.py and
// csfd/vec3.py, formula by formula.
//
// Every operator rounds where the Python operator rounds, in its order (the
// sources build with -fmad=false), and a constant is lifted to {c, 0} and goes
// through the same formula as in Python (`g * c + v * 0`), so a kernel written
// with these operators gives the bits of the plain PyTorch version on the
// card. 1 / x, a / b and sqrtf are the IEEE-rounded forms (no fast math).

#pragma once

#include <cuda_runtime.h>

namespace xs {

constexpr float INDEX_LIMIT = 1073741824.0f;  // 2^30
constexpr float FLT_BIG = 3.402823466e+38f;

struct Dual {
  float v, g;
};

__device__ __forceinline__ Dual lift(float c) { return {c, 0.0f}; }
__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.g + b.g}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.g - b.g}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) { return {a.v * b.v, a.g * b.v + a.v * b.g}; }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float inv = 1.0f / b.v;
  const float val = a.v * inv;
  return {val, (a.g - val * b.g) * inv};
}
__device__ __forceinline__ Dual dsqrt(Dual x) {
  const float v = sqrtf(x.v);
  return {v, (0.5f * x.g) / v};
}

// vec3.dot: the three products added left to right
__device__ __forceinline__ Dual dot3(const Dual a[3], const Dual b[3]) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// vec3.normalized
__device__ __forceinline__ void normalized3(const Dual v[3], Dual out[3]) {
  const Dual n = dsqrt(dot3(v, v));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[i].v = v[i].v / n.v;
    out[i].g = (v[i].g * n.v - v[i].v * n.g) / (n.v * n.v);
  }
}

// vec3.matvec with a packed dual matrix: m[0:9] the value lane (row-major
// 3x3), m[9:18] the derivative lane. The derivative adds the three
// `m.g * v.v` products, then the three `m.v * v.g` products, left to right.
__device__ __forceinline__ void matvec3(const float* m, const Dual v[3], Dual out[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* mv = m + 3 * i;
    const float* mg = m + 9 + 3 * i;
    out[i].v = (mv[0] * v[0].v + mv[1] * v[1].v) + mv[2] * v[2].v;
    out[i].g = ((((mg[0] * v[0].v + mg[1] * v[1].v) + mg[2] * v[2].v) + mv[0] * v[0].g) + mv[1] * v[1].g) +
               mv[2] * v[2].g;
  }
}

// ops/sampling.py::to_index of an already floored float: NaN -> -1, clamped
// to +-2^30 (a bare cast of NaN or of an out-of-range float is undefined)
__device__ __forceinline__ int to_index(float floored) {
  if (isnan(floored)) return -1;
  return (int)fminf(fmaxf(floored, -INDEX_LIMIT), INDEX_LIMIT);
}

// torch.nan_to_num
__device__ __forceinline__ float nan_to_num(float x) {
  if (isnan(x)) return 0.0f;
  if (isinf(x)) return x > 0.0f ? FLT_BIG : -FLT_BIG;
  return x;
}

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

}  // namespace xs
