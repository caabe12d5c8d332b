// K6, K7, K8: the small image kernels around the march and the bilateral
// filter, one launch each where the plain PyTorch versions take dozens of
// operators. All three are bound by bytes on the H100 (a few operations per
// pixel against 4 to 96 bytes moved), and at these image sizes (at most
// 480 x 640) by the launch itself; the design is one thread per output pixel,
// neighbouring threads on neighbouring addresses, every intermediate in
// registers. Each follows its plain version one rounding at a time (built
// with -fmad=false).
//
// K6 xs_model_map_pyramid: every coarser level of the model-map pyramid,
//   both maps, both lanes, in one launch. Replaces the XLA code of
//   xslam_tpu/ops/preprocess.py::resize_vmap (_resize_map) applied to the
//   vertex map's value and derivative, and of xslam_tpu/models/kinfu.py::
//   _resize_nmap_dual, level after level (kinfu.py:525-529); reference
//   resizeMapKernel, Map.cu:105-152. 2 x 2 mean (the two column sums added,
//   times 0.25, which is the order torch.mean reduces them in on the card); a
//   vertex lane is NaN where any of ITS four first-channel entries is NaN; the
//   normal is renormalised as a dual vector and is (NaN, 0) where any of the
//   four value-lane first-channel entries is NaN. One thread per pixel of
//   level 1; the four threads of a 2 x 2 quad of level-1 pixels are four
//   neighbouring lanes of a warp, and after each has written its pixel the
//   quad's first lane gathers the four by shuffles and computes the level-2
//   pixel from them. The means do not overlap, so no halo and no shared
//   memory; level 2 reads level 1's float32 results from registers, the
//   numbers a second launch would read, so the bits are the plain version's.
//   What held the one-level kernel (a chain of 48 loads behind NaN selects,
//   and a second launch waiting on the first's stores) is cut: a thread
//   issues all its loads before any arithmetic, 24 eight-byte loads of its
//   row pairs where the rows have an even width (48 four-byte loads else).
// K6 with NORMALS, xs_model_map_normals: B4n, the brick layout's screen
//   normals of level 0, in the same launch. Replaces the XLA code of
//   xslam_tpu/ops/raycast.py::screen_normals (central=True) as well; plain
//   version ops/raycast.py::screen_normals_plain. A thread owns its 2 x 2
//   block of level-0 pixels: it loads their 4 x 4 neighbourhood of the
//   vertex map (corners left out, 12 dual entries, (NaN, 0) past the edge),
//   computes the four normals by B4n's rule (the normalised dual cross
//   product of the central differences; (NaN, 0) where a neighbour's first
//   component or the squared norm fails), writes them as level 0's normal
//   map and takes them from registers into the 2 x 2 means, the numbers a
//   second launch would read, so the bits are the plain chain's. The grid
//   covers the source's 2 x 2 blocks, so an odd last row or column (no
//   level-1 pixel owns it) and a pyramid of one level get their normals. B4n
//   alone was bound by a launch's own length (0.0041 ms, 27% of its bound):
//   inside K6's launch it costs no launch and reads the map once.
// K7 xs_depth_pyramid: levels 1 and 2 of the depth pyramid in one launch.
//   Replaces xslam_tpu/ops/preprocess.py::pyr_down applied twice; reference
//   pyrDownKernel, Map.cu:202-230. Each level: the source rounded half to
//   even, a 5 x 5 window at stride 2, a neighbour counted where its row and
//   column lie in [0, size - 2] of that level and it is within 90 mm of the
//   centre, taps added dy outer, dx inner, floor(sum / max(cnt, 1)); level 2
//   reads level 1's floored float32 results. What held the earlier one-level
//   kernel: not bytes or arithmetic but the launch itself, a tail of 75 blocks
//   at 120 x 160, 25 dependent loads behind branches a pixel, and a second
//   launch waiting on the first's stores. A block owns PYR_TY x PYR_TX
//   level-2 pixels (and the 2 PYR_TY x 2 PYR_TX level-1 pixels under them):
//   it stages the level-0 window its tile needs in shared memory, rounded
//   once, computes its level-1 tile with a 2-pixel halo into shared memory
//   (halo pixels outside level 1 are skipped: the [0, size - 2] rule never
//   counts them), writes the tile, and computes level 2 from shared memory.
//   The grid covers level 1, so an odd level-1 row or column past level 2
//   is written too. Neighbouring threads take neighbouring columns of each
//   stage.
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

#include <cstdint>

#include "rays.cuh"

namespace {

using xs::Camera;
using xs::Dual;

constexpr int BLOCK = 256;
constexpr int MAX_MAP_LEVELS = 3;  // ops/kernels.py::MAX_MAP_LEVELS
// K6: one warp a block, so the 600 warps of a 240 x 320 launch spread evenly over the SMs (measured on the
// H100: 0.0048 ms against 0.0049 with 128 threads and 0.0051 with 256)
constexpr int PYRAMID_BLOCK = 32;

// The maps of one coarser pixel from its 2 x 2 quad of finer pixels. q[m][c][k]:
// map m (v.v, v.g, n.v, n.g), channel c, quad member k = 2 dy + dx. The mean
// adds as torch.mean over the (2, 4) axes of reshape(3, oh, 2, ow, 2) adds the
// four on the card (measured): the upper and lower entry of each column
// first, then the two columns.
__device__ __forceinline__ float mean4(const float q[4]) { return ((q[0] + q[2]) + (q[1] + q[3])) * 0.25f; }

__device__ __forceinline__ bool any_nan4(const float q[4]) {
  return isnan(q[0]) || isnan(q[1]) || isnan(q[2]) || isnan(q[3]);
}

__device__ __forceinline__ void resize_quad(const float (&q)[4][3][4], float (&o)[4][3]) {
  const bool v_nan = any_nan4(q[0][0]), g_nan = any_nan4(q[1][0]), n_nan = any_nan4(q[2][0]);
  Dual avg[3], unit[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[0][c] = v_nan ? xs::quiet_nan() : mean4(q[0][c]);
    o[1][c] = g_nan ? xs::quiet_nan() : mean4(q[1][c]);
    avg[c] = n_nan ? Dual{1.0f, 0.0f} : Dual{mean4(q[2][c]), mean4(q[3][c])};
  }
  xs::normalized3(avg, unit);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[2][c] = n_nan ? xs::quiet_nan() : unit[c].v;
    o[3][c] = n_nan ? 0.0f : unit[c].g;
  }
}

// level 0's four (3, H, W) maps in (with NORMALS the vertex map's two, and level 0's normals out); the four maps
// of levels 1 and 2 out
struct ModelPyramid {
  const float* in[4];
  float* normals[2];
  float* out[MAX_MAP_LEVELS - 1][4];
  int H, W, levels;
};

// the dual (3,) entry of the map at (y, x): (NaN, 0) past the edge (ops/preprocess.py::_shift2d's fills)
__device__ __forceinline__ void map_at(const float* __restrict__ vv, const float* __restrict__ vg, int H, int W,
                                       int y, int x, Dual m[3]) {
  const bool in = y >= 0 && y < H && x >= 0 && x < W;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    m[c] = in ? Dual{__ldg(vv + (c * H + y) * W + x), __ldg(vg + (c * H + y) * W + x)} : Dual{xs::quiet_nan(), 0.0f};
}

// B4n's rule (ops/raycast.py::screen_normals_plain): the normalised dual cross product of the central
// differences, false (the normal is (NaN, 0)) where the centre's or a neighbour's first component is NaN or the
// product's squared norm is not > 0
__device__ __forceinline__ bool screen_normal(float centre, const Dual xp[3], const Dual xm[3], const Dual yp[3],
                                              const Dual ym[3], Dual unit[3]) {
  if (isnan(centre) || isnan(xp[0].v) || isnan(xm[0].v) || isnan(yp[0].v) || isnan(ym[0].v)) return false;
  Dual a[3], b[3], n[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a[c] = xp[c] - xm[c];
    b[c] = yp[c] - ym[c];
  }
  // csfd/vec3.py::cross
  n[0] = a[1] * b[2] - a[2] * b[1];
  n[1] = a[2] * b[0] - a[0] * b[2];
  n[2] = a[0] * b[1] - a[1] * b[0];
  const Dual nsq = xs::dot3(n, n);
  if (!(nsq.v > 0.0f) || isnan(nsq.v)) return false;
  xs::normalized3(n, unit);
  return true;
}

// PAIRS: the rows have an even width and 8-byte aligned starts, so a thread
// reads each of its two rows of a plane as one float2. NORMALS: level 0's
// normals are computed here from the vertex map (B4n), written, and fed from
// registers into the means; the grid then covers every source pixel.
template <bool PAIRS, bool NORMALS>
__global__ void __launch_bounds__(PYRAMID_BLOCK) model_map_pyramid_kernel(const ModelPyramid p) {
  const int H1 = p.H / 2, W1 = p.W / 2;
  // a thread a 2 x 2 block of the source: level 1's blocks, or with NORMALS every block of the source
  const int GH = NORMALS ? (p.H + 1) / 2 : H1, GW = NORMALS ? (p.W + 1) / 2 : W1;
  const int quads_w = (GW + 1) / 2, quads_h = (GH + 1) / 2;
  const int t = blockIdx.x * PYRAMID_BLOCK + threadIdx.x;
  const int quad = t >> 2, k = t & 3;
  const int qy = quad / quads_w, qx = quad - qy * quads_w;
  const int y1 = 2 * qy + (k >> 1), x1 = 2 * qx + (k & 1);
  // a quad at an odd border has members past it, and the grid's tail quads past the last
  const bool in_grid = qy < quads_h && y1 < GH && x1 < GW;
  const bool live = in_grid && y1 < H1 && x1 < W1 && p.levels >= 2;

  float o[4][3] = {};  // a lane past the level's border shuffles zeros that no lane writes
  float q[4][3][4];
  if (NORMALS && in_grid) {
    // the 4 x 4 neighbourhood of the thread's 2 x 2 block, corners left out: w[r][c] is source pixel
    // (2 y1 - 1 + r, 2 x1 - 1 + c); every load issued before any arithmetic
    Dual w[4][4][3];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if ((r == 1 || r == 2) || (c == 1 || c == 2))
          map_at(p.in[0], p.in[1], p.H, p.W, 2 * y1 - 1 + r, 2 * x1 - 1 + c, w[r][c]);
    const int HW = p.H * p.W;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int dy = m >> 1, dx = m & 1, y = 2 * y1 + dy, x = 2 * x1 + dx;
      const Dual(&ctr)[3] = w[1 + dy][1 + dx];
      Dual unit[3];
      const bool ok =
          screen_normal(ctr[0].v, w[1 + dy][2 + dx], w[1 + dy][dx], w[2 + dy][1 + dx], w[dy][1 + dx], unit);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        q[0][c][m] = ctr[c].v;
        q[1][c][m] = ctr[c].g;
        q[2][c][m] = ok ? unit[c].v : xs::quiet_nan();
        q[3][c][m] = ok ? unit[c].g : 0.0f;
      }
      if (y < p.H && x < p.W) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          p.normals[0][c * HW + y * p.W + x] = q[2][c][m];
          p.normals[1][c * HW + y * p.W + x] = q[3][c][m];
        }
      }
    }
  } else if (!NORMALS && live) {
    const int HW = p.H * p.W, at = (2 * y1) * p.W + 2 * x1;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* r = p.in[m] + c * HW + at;
        if (PAIRS) {
          const float2 top = __ldg(reinterpret_cast<const float2*>(r));
          const float2 bottom = __ldg(reinterpret_cast<const float2*>(r + p.W));
          q[m][c][0] = top.x;
          q[m][c][1] = top.y;
          q[m][c][2] = bottom.x;
          q[m][c][3] = bottom.y;
        } else {
          q[m][c][0] = __ldg(r);
          q[m][c][1] = __ldg(r + 1);
          q[m][c][2] = __ldg(r + p.W);
          q[m][c][3] = __ldg(r + p.W + 1);
        }
      }
    }
  }
  if (live) {
    resize_quad(q, o);
    const int H1W1 = H1 * W1, o1 = y1 * W1 + x1;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int c = 0; c < 3; ++c) p.out[0][m][c * H1W1 + o1] = o[m][c];
  }
  if (p.levels < 3) return;  // the same for every thread: no lane leaves the shuffles below alone

  // level 2: the quad's first lane takes its members' level-1 numbers
  const int first = (threadIdx.x & 31) & ~3;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) q[m][c][j] = __shfl_sync(0xffffffffu, o[m][c], first + j);
  const int H2 = H1 / 2, W2 = W1 / 2;
  if (k != 0 || qy >= H2 || qx >= W2) return;  // a quad with a member past level 1 writes no level-2 pixel
  float o2[4][3];
  resize_quad(q, o2);
  const int H2W2 = H2 * W2, at2 = qy * W2 + qx;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int c = 0; c < 3; ++c) p.out[1][m][c * H2W2 + at2] = o2[m][c];
}

// K7's tile: the level-2 rows and columns a block owns, 600 blocks at 120 x 160
// (measured on the H100, from 480 x 640: 0.00511 ms, against 0.00561 for 2 x 16
// and 0.00632 for 4 x 16 with 128 threads, 0.00601-0.00606 for 4 x 32 and 8 x 16
// with 256; all bit-equal)
constexpr int PYR_TY = 4, PYR_TX = 8;
constexpr int PYR_THREADS = 128;
constexpr int PYR_L1_ROWS = 2 * PYR_TY + 3, PYR_L1_COLS = 2 * PYR_TX + 3;  // level 1: tile and 2-pixel halo
constexpr int PYR_L0_ROWS = 2 * PYR_L1_ROWS + 3, PYR_L0_COLS = 2 * PYR_L1_COLS + 3;  // the level-0 window

// One pixel of the next level: the centre at (y, x) of a level of H x W,
// staged at (sy, sx) of s (already rounded), the window read from s.
template <int COLS>
__device__ __forceinline__ float pyr_pixel(const float (*s)[COLS], int sy, int sx, int y, int x, int H, int W) {
  const float center = s[sy][sx];
  float sum = 0.0f, cnt = 0.0f;
#pragma unroll
  for (int dy = -2; dy <= 2; ++dy) {
    const int ny = y + dy;
    const bool row_ok = ny >= 0 && ny <= H - 2;
#pragma unroll
    for (int dx = -2; dx <= 2; ++dx) {
      const int nx = x + dx;
      const float nbr = s[sy + dy][sx + dx];
      if (row_ok && nx >= 0 && nx <= W - 2 && fabsf(nbr - center) < 90.0f) {  // else the tap adds exactly 0
        sum = sum + nbr;
        cnt = cnt + 1.0f;
      }
    }
  }
  return floorf(sum / fmaxf(cnt, 1.0f));
}

__global__ void __launch_bounds__(PYR_THREADS)
    depth_pyramid_kernel(const float* __restrict__ src, float* __restrict__ l1, float* __restrict__ l2, int H,
                         int W, int two_levels) {
  __shared__ float s0[PYR_L0_ROWS][PYR_L0_COLS];
  __shared__ float s1[PYR_L1_ROWS][PYR_L1_COLS];
  const int H1 = H / 2, W1 = W / 2, H2 = H1 / 2, W2 = W1 / 2;
  // the tile's first level-1 row and column, halo included, and the window's first level-0 ones
  const int r1 = 2 * PYR_TY * (int)blockIdx.y - 2, c1 = 2 * PYR_TX * (int)blockIdx.x - 2;
  const int r0 = 2 * r1 - 2, c0 = 2 * c1 - 2;

  // every tap and centre that counts lies in [0, H - 2] x [0, W - 2]; the rest is never read as a number
  for (int i = threadIdx.x; i < PYR_L0_ROWS * PYR_L0_COLS; i += PYR_THREADS) {
    const int sy = i / PYR_L0_COLS, sx = i - sy * PYR_L0_COLS;
    const int y = r0 + sy, x = c0 + sx;
    s0[sy][sx] = (y >= 0 && y <= H - 2 && x >= 0 && x <= W - 2) ? rintf(__ldg(src + y * W + x)) : 0.0f;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < PYR_L1_ROWS * PYR_L1_COLS; i += PYR_THREADS) {
    const int ty = i / PYR_L1_COLS, tx = i - ty * PYR_L1_COLS;
    const int y = r1 + ty, x = c1 + tx;
    float out = 0.0f;
    if (y >= 0 && y < H1 && x >= 0 && x < W1) {
      out = pyr_pixel<PYR_L0_COLS>(s0, 2 * ty + 2, 2 * tx + 2, 2 * y, 2 * x, H, W);
      if (ty >= 2 && ty < 2 + 2 * PYR_TY && tx >= 2 && tx < 2 + 2 * PYR_TX) l1[y * W1 + x] = out;
    }
    s1[ty][tx] = rintf(out);  // level 2 rounds its source as the plain version does (exact on these integers)
  }
  if (!two_levels) return;
  __syncthreads();

  for (int i = threadIdx.x; i < PYR_TY * PYR_TX; i += PYR_THREADS) {
    const int ty = i / PYR_TX, tx = i - ty * PYR_TX;
    const int y = PYR_TY * (int)blockIdx.y + ty, x = PYR_TX * (int)blockIdx.x + tx;
    if (y < H2 && x < W2) l2[y * W2 + x] = pyr_pixel<PYR_L1_COLS>(s1, 2 * ty + 2, 2 * tx + 2, 2 * y, 2 * x, H1, W1);
  }
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

// levels: 2 or 3 (level 0 and one or two halvings of it). in: level 0's
// v.v, v.g, n.v, n.g, each (3, H, W); the maps of level l >= 1 at out +
// offsets[4 (l - 1) + m], each (3, H >> l, W >> l) in the same order
extern "C" int xs_model_map_pyramid(const void* const* in, void* out, const long long* offsets, int levels, int H,
                                    int W, void* stream) {
  if (levels < 2 || levels > MAX_MAP_LEVELS) return (int)cudaErrorInvalidValue;
  ModelPyramid p{};
  bool aligned = W % 2 == 0;
  for (int m = 0; m < 4; ++m) {
    p.in[m] = (const float*)in[m];
    aligned = aligned && (reinterpret_cast<uintptr_t>(in[m]) % sizeof(float2)) == 0;
  }
  for (int l = 1; l < levels; ++l)
    for (int m = 0; m < 4; ++m) p.out[l - 1][m] = (float*)out + offsets[4 * (l - 1) + m];
  p.H = H;
  p.W = W;
  p.levels = levels;
  const int threads = 4 * (((H / 2) + 1) / 2) * (((W / 2) + 1) / 2);
  const int blocks = (threads + PYRAMID_BLOCK - 1) / PYRAMID_BLOCK;
  if (blocks == 0) return (int)cudaSuccess;
  if (aligned)
    model_map_pyramid_kernel<true, false><<<blocks, PYRAMID_BLOCK, 0, (cudaStream_t)stream>>>(p);
  else
    model_map_pyramid_kernel<false, false><<<blocks, PYRAMID_BLOCK, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// levels: 1 to 3. vmap_v, vmap_g: level 0's vertex map, each (3, H, W); nmap_v, nmap_g: its screen normals out,
// the same shape; the four maps of level l >= 1 at out + offsets[4 (l - 1) + m] as above (none with 1 level)
extern "C" int xs_model_map_normals(const void* vmap_v, const void* vmap_g, void* nmap_v, void* nmap_g, void* out,
                                    const long long* offsets, int levels, int H, int W, void* stream) {
  if (levels < 1 || levels > MAX_MAP_LEVELS || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  ModelPyramid p{};
  p.in[0] = (const float*)vmap_v;
  p.in[1] = (const float*)vmap_g;
  p.normals[0] = (float*)nmap_v;
  p.normals[1] = (float*)nmap_g;
  for (int l = 1; l < levels; ++l)
    for (int m = 0; m < 4; ++m) p.out[l - 1][m] = (float*)out + offsets[4 * (l - 1) + m];
  p.H = H;
  p.W = W;
  p.levels = levels;
  const int threads = 4 * ((((H + 1) / 2) + 1) / 2) * ((((W + 1) / 2) + 1) / 2);
  const int blocks = (threads + PYRAMID_BLOCK - 1) / PYRAMID_BLOCK;
  model_map_pyramid_kernel<false, true><<<blocks, PYRAMID_BLOCK, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// levels: 2 or 3 (the source and one or two halvings of it). src: (H, W); l1: (H / 2, W / 2); l2:
// (H / 4, W / 4) with 3 levels, null with 2
extern "C" int xs_depth_pyramid(const void* src, void* l1, void* l2, int H, int W, int levels, void* stream) {
  if (levels < 2 || levels > 3 || H < 2 || W < 2 || (levels == 3) != (l2 != nullptr))
    return (int)cudaErrorInvalidValue;
  const int H1 = H / 2, W1 = W / 2;
  const dim3 grid((W1 + 2 * PYR_TX - 1) / (2 * PYR_TX), (H1 + 2 * PYR_TY - 1) / (2 * PYR_TY));
  depth_pyramid_kernel<<<grid, PYR_THREADS, 0, (cudaStream_t)stream>>>((const float*)src, (float*)l1, (float*)l2, H,
                                                                       W, levels == 3 ? 1 : 0);
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
