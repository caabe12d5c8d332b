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
// the 1.2 MB depth image. What the design does about it:
//
// - A 3-D launch: a block of 32 x 8 threads owns a tile of 4 x 8 x 64 voxels
//   (x, y, z), z fastest within the warp, so a warp's updated voxels of each
//   plane lie in neighbouring addresses, and x, y, z come from block and
//   thread indices with 32-bit arithmetic (no division).
// - The block first tests its tile against the camera. The camera
//   coordinates are affine in the voxel index, so each of five linear
//   functions of them (depth; the four sides of the pixel gate, multiplied
//   through by the depth so that nothing is divided) takes its largest value
//   over the tile at one of the eight corner voxels. Where one of them is
//   below zero at all eight corners by a margin that covers float32
//   rounding, no voxel of the tile can pass its gates and the block returns.
//   The test may keep a tile that updates nothing; it never drops a voxel
//   that the frame updates (ops/fusion.py::tile_keep_mask is its plain twin).
// - A thread walks the tile's x slices and, within one, its z steps, so the
//   sums R[i][0] gx + R[i][1] gy of a z column are computed once. The
//   reference adds ((a + b) + c) + t, so hoisting (a + b) keeps every bit.
// - Inside a kept tile each voxel runs the reference's operations in its
//   order, one rounding at a time (built with -fmad=false): the per-voxel
//   code is fusion.cuh's, which the brick pass (bricks.cu) shares. The 24
//   pose floats come from a small device tensor (no host read), and the
//   depth image stays in L2.

#include <cuda_runtime.h>

#include "fusion.cuh"

namespace {

using xs::FuseParams;
using Params = FuseParams;

constexpr int TILE_X = 4, TILE_Y = 8, TILE_Z = 64;  // ops/fusion.py::FUSE_TILE
constexpr int LANES_Z = 32;                         // threads along z; TILE_Y threads along y
constexpr float CULL_MARGIN = 4e-6f;                // ops/fusion.py::FUSE_CULL_MARGIN
// the pixel gate needs 2.5 <= img < size - 0.5; the tile test asks only for
// 1 <= img <= size, a pixel and a half looser
constexpr float CULL_LO = 1.0f;

// True where no voxel of the tile whose first voxel is (x0, y0, z0) can pass
// the in-front test and the pixel gate. Every lane of the calling warp takes
// one of the eight corner voxels (lane & 7).
__device__ __forceinline__ bool tile_outside(const float* __restrict__ pose, const Params& p, int x0, int y0,
                                             int z0, int lane) {
  const int x = (lane & 1) ? min(x0 + TILE_X, p.X) - 1 : x0;
  const int y = (lane & 2) ? min(y0 + TILE_Y, p.Y) - 1 : y0;
  const int z = (lane & 4) ? min(z0 + TILE_Z, p.Z) - 1 : z0;
  const float gx = ((float)x + 0.5f) * p.vs, gy = ((float)y + 0.5f) * p.vs, gz = ((float)z + 0.5f) * p.vs;
  float c[3];
  for (int i = 0; i < 3; ++i) c[i] = ((pose[3 * i] * gx + pose[3 * i + 1] * gy) + pose[3 * i + 2] * gz) + pose[18 + i];
  float cmax = fmaxf(fmaxf(fabsf(c[0]), fabsf(c[1])), fabsf(c[2]));
  for (int off = 4; off > 0; off >>= 1) cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
  const float scale = CULL_MARGIN * (cmax + 1.0f);
  const float eps_x = scale * ((fabsf(p.fx) + fabsf(p.cx)) + (float)p.W);
  const float eps_y = scale * ((fabsf(p.fy) + fabsf(p.cy)) + (float)p.H);
  const float ax = c[0] * p.fx, ay = c[1] * p.fy;
  const bool outside[5] = {
      c[2] < -scale,                               // behind the camera
      ax - (CULL_LO - p.cx) * c[2] < -eps_x,       // img_x < 1
      ((float)p.W - p.cx) * c[2] - ax < -eps_x,    // img_x > W
      ay - (CULL_LO - p.cy) * c[2] < -eps_y,       // img_y < 1
      ((float)p.H - p.cy) * c[2] - ay < -eps_y,    // img_y > H
  };
  bool all_outside = false;
  for (int k = 0; k < 5; ++k) all_outside = all_outside || __all_sync(0xffffffffu, outside[k]);
  return all_outside;
}

__global__ void __launch_bounds__(LANES_Z * TILE_Y)
fuse_kernel(float* __restrict__ value, float* __restrict__ grad, float* __restrict__ weight,
            const float* __restrict__ depth, const float* __restrict__ pose, Params p) {
  const int z0 = blockIdx.x * TILE_Z, y0 = blockIdx.y * TILE_Y, x0 = blockIdx.z * TILE_X;
  const int keep = threadIdx.y == 0 && !tile_outside(pose, p, x0, y0, z0, threadIdx.x);
  if (!__syncthreads_or(keep)) return;

  const int y = y0 + threadIdx.y;
  if (y >= p.Y) return;
  const int x_end = min(x0 + TILE_X, p.X), z_end = min(z0 + TILE_Z, p.Z);
  const xs::FusePose dual_pose(pose);
  const float gy = xs::voxel_centre(y, p.vs);

  for (int x = x0; x < x_end; ++x) {
    const xs::ColumnSums sums = xs::column_sums(dual_pose, xs::voxel_centre(x, p.vs), gy);
    for (int z = z0 + threadIdx.x; z < z_end; z += LANES_Z) {
      const xs::VoxelView o = xs::voxel_view(dual_pose, p, sums, xs::voxel_centre(z, p.vs));
      if (!o.gated) continue;
      xs::fuse_gated_voxel(value, grad, weight, depth, p, o, ((size_t)x * p.Y + y) * p.Z + z);
    }
  }
}

}  // namespace

extern "C" int xs_fuse_volume(void* value, void* grad, void* weight, const void* depth, const void* pose,
                              int X, int Y, int Z, int H, int W,
                              float vs, float fx, float fy, float cx, float cy,
                              float inv_fx, float inv_fy, float trunc, float inv_trunc, float max_w,
                              void* stream) {
  const Params p{X, Y, Z, H, W, vs, fx, fy, cx, cy, inv_fx, inv_fy, trunc, inv_trunc, max_w};
  const dim3 block(LANES_Z, TILE_Y);
  const dim3 grid((Z + TILE_Z - 1) / TILE_Z, (Y + TILE_Y - 1) / TILE_Y, (X + TILE_X - 1) / TILE_X);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  fuse_kernel<<<grid, block, 0, (cudaStream_t)stream>>>((float*)value, (float*)grad, (float*)weight,
                                                        (const float*)depth, (const float*)pose, p);
  return (int)cudaGetLastError();
}
