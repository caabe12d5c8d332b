// The camera ray of a pixel, computed in the kernel, and the pixel a thread
// of a block owns. Shared by K3 (march.cu), K5 (refine.cu), B4 (window.cu) and
// B5b (skip.cu).
//
// camera_ray follows xslam_tpu_torch/ops/kernels.py::camera_rays operation
// by operation: ((u - cx) / fx, (v - cy) / fy, 1) through the dual
// camera->volume rotation (vec3.matvec), vec3.normalized, and a value lane
// that is exactly 0 patched to 1e-15 (RayCaster.cu:211-213). The division by
// the focal length is a multiply by its reciprocal (taken in double, rounded
// to float32), which is how PyTorch's CUDA operator divides a tensor by a
// host scalar, so the ray has
// the bits of the plain version's on the card (on the CPU that version
// divides truly: at most one ulp apart in rx, ry). Computing the ray here
// takes the (3, H, W) direction planes, value and derivative, out of device
// memory.
//
// The packed pose (ops/kernels.py::pack_ray_pose), 48 floats: camera->volume
// R.v (row-major 3x3), R.g, t.v, t.g, then volume->world R.v, R.g, t.v, t.g.

#pragma once

#include "dual.cuh"

namespace xs {

constexpr int POSE_C2V = 0;    // rotation at +0 (18 floats), translation at +18 (v) and +21 (g)
constexpr int POSE_V2W = 24;
constexpr int POSE_FLOATS = 48;
constexpr int BLOCK_W = 32, BLOCK_H = 8;  // pixels of one 256-thread block

struct Camera {
  float cx, cy, inv_fx, inv_fy;
};

__device__ __forceinline__ void camera_ray(const float* c2v, float u, float v, const Camera& cam, Dual dir[3]) {
  const Dual ray_cam[3] = {lift((u - cam.cx) * cam.inv_fx), lift((v - cam.cy) * cam.inv_fy), lift(1.0f)};
  Dual d[3];
  matvec3(c2v, ray_cam, d);
  normalized3(d, dir);
#pragma unroll
  for (int i = 0; i < 3; ++i) dir[i].v = dir[i].v == 0.0f ? 1e-15f : dir[i].v;
}

// The pixel of thread `tid` in a block of BLOCK_W x BLOCK_H pixels: a warp
// owns 8 x 4 pixels, not 32 x 1 of one image row, so its 32 rays stay a
// compact bundle and their samples at one step fall into few cache lines of
// the (X, Y, Z) volume.
__device__ __forceinline__ void block_pixel(int tid, int& x, int& y) {
  const int warp = tid >> 5, lane = tid & 31;
  x = blockIdx.x * BLOCK_W + (warp & 3) * 8 + (lane & 7);
  y = blockIdx.y * BLOCK_H + (warp >> 2) * 4 + (lane >> 3);
}

// The same for a block of NT threads: a tile of PixelTile<NT>::W x H pixels, its NT / 32 warps at most 4 along a
// row, each an 8 x 4 pixel tile (NT = 256 is block_pixel's)
template <int NT>
struct PixelTile {
  static constexpr int WARPS_X = NT / 32 < 4 ? NT / 32 : 4, WARPS_Y = NT / 32 / WARPS_X;
  static constexpr int W = 8 * WARPS_X, H = 4 * WARPS_Y;
};

template <int NT>
__device__ __forceinline__ void tile_pixel(int tid, int& x, int& y) {
  using Tile = PixelTile<NT>;
  const int warp = tid >> 5, lane = tid & 31;
  x = blockIdx.x * Tile::W + (warp % Tile::WARPS_X) * 8 + (lane & 7);
  y = blockIdx.y * Tile::H + (warp / Tile::WARPS_X) * 4 + (lane >> 3);
}

template <int NT>
dim3 tile_grid(int H, int W) {
  return dim3((W + PixelTile<NT>::W - 1) / PixelTile<NT>::W, (H + PixelTile<NT>::H - 1) / PixelTile<NT>::H);
}

}  // namespace xs
