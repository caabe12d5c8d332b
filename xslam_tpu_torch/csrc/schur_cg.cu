// B18: the two passes of S·x, the reduced camera system's product in the
// Schur-complement CG of bundle adjustment.
//
// Replaces the XLA code of xslam_tpu/models/ba.py:602-614 (schur_ba_cg's
// matvec: two scatter-add passes over the observations). With x the
// gauge-masked (K, 6) camera step, Jc (N, R, 6) and Jl (N, R, 3) the
// observations' Jacobians (R = 4 with normals, 3 without):
//
//   pass L (xs_schur_cg_anchors), by anchor:
//     u_o = Jc_o x[k_o]                          (R values)
//     v[l] = sum over o of anchor l of Jl_o^T u_o   (L, 3)
//   pass K (xs_schur_cg_keyframes), by keyframe, after v is summed over the
//   ranks where the observations are sharded:
//     w_o = Hll_inv[l_o] v[l_o],  z_o = Jl_o w_o
//     hz[k] = (sum over o of k of Jc_o^T u_o, sum over o of k of Jc_o^T z_o)   (K, 12)
//
// The caller takes hz's difference, sums it over the ranks, adds damping * x
// and masks the gauge (models/ba.py::schur_ba_cg). Plain versions:
// models/ba.py::_anchors_plain and _keyframes_plain. Every per-observation
// product is its plain version's to the bit: each contraction adds its
// float32 products in index order, one rounding a product and a sum (built
// with -fmad=false). Each key's sum is taken in float64 over its observations
// in the problem's sorted order and rounded once to float32, as
// models/ba.py::_Segments does with its prefix sums: the two orders differ, so
// an output may lie an ulp from the plain version's. No float atomics: the
// same bits on every call.
//
// Design: a block a chunk of CG_CHUNK = CG_THREADS x CG_PER_THREAD
// consecutive sorted positions, a thread CG_PER_THREAD consecutive ones (the
// chunks outnumber the 41 blocks that a block a keyframe would give 132 SMs).
// A thread forms its positions' contributions and adds each run of one key
// serially in float64: a run that begins and ends inside the thread is its
// key's whole segment, written at once (rounded); the thread keeps the sum of
// its first run (`head`) and of its last. A segmented inclusive scan over the
// threads' (a run starts in the thread, the last run's sum) pairs by
// __shfl_up_sync within each warp, and the warps' totals through shared
// memory laid out plane-major (s[j * WARPS + w]: broadcast reads, no bank
// conflict), give each thread the sum that its first run carries in from the
// threads before it in the chunk. The first run's sum, where it ends inside
// the thread, and the last run's, where it ends at the thread's last
// position, are written as a run's end was before: to the output, rounded,
// where the key's whole segment lies in the chunk; else to the chunk's
// `first` partial (the run began in an earlier chunk) or `last` partial (it
// goes on in a later one). The block that takes the last ticket (an integer
// atomic) sums each key that crosses a chunk boundary in chunk order,
// last[c0] + first[c0 + 1] + ... + first[c1], going over the chunk boundaries
// (n_chunks of them, not the keys), and resets the ticket. Keys with no
// observation are zeroed by a grid-stride loop. One launch a pass: two a CG
// step. 128 threads of 4 positions read fastest of 128 and 256 threads of 1,
// 2, 4 and 8 positions for the keyframe pass (its 151 registers a thread
// leave 3 blocks of 128 an SM) and within 6% of the best for the anchor pass
// in the sweep in PERF.md, whose keyframe reading later runs did not
// reproduce (PERF.md, open questions). The Jacobian rows are read as float4
// (float2 or floats where a row's bytes are not a multiple of 16: R = 3) into
// registers before the arithmetic; the launch refuses tensors that are not
// 16-byte aligned.
//
// The earlier design (a thread a position in chunks of 256, an 8-step
// Hillis-Steele segmented scan of D doubles a thread in shared memory: 16
// __syncthreads, pass K's 96 B stride a 4-way bank conflict, partial sums no
// run's end reads) was timed beside this one in one call and taken out; its
// times are in PERF.md.
//
// Bound: bytes. Each pass reads Jc and Jl once (72 B + 36 B an observation at
// R = 4 ... 144 B) with the sorted order, the keys and the observations'
// other index (12 B), the segments (8 B a key) and writes its sums; about 100
// (pass L) and 170 (pass K) float32 operations an observation. Pass L reads
// the Jacobians in anchor order, a gather of 96 B and 48 B rows; pass K in
// keyframe order, which build_ba_problem's observations already follow.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CG_THREADS = 128;                       // threads a block
constexpr int CG_PER_THREAD = 4;                      // sorted positions a thread
constexpr int CG_CHUNK = CG_THREADS * CG_PER_THREAD;  // sorted positions a block: models/ba.py::CG_CHUNK
constexpr unsigned FULL = 0xffffffffu;

struct CgParams {
  const float* jc;        // (N, R, 6)
  const float* jl;        // (N, R, 3)
  const int* order;       // (N,) the observation at each sorted position
  const int* keys;        // (N,) the sorted keys
  const int* start;       // (n_keys,) each key's first sorted position
  const int* end;         // (n_keys,) one past its last
  const int* other;       // (N,) pass L: each observation's keyframe; pass K: its anchor
  const float* x;         // (K, 6), gauge-masked
  const float* hll_inv;   // (L, 3, 3), pass K
  const float* v;         // (L, 3), pass K
  double* first;          // (n_chunks, D)
  double* last;           // (n_chunks, D)
  unsigned* ticket;
  float* out;             // (n_keys, D)
  int n, n_keys, n_chunks;
};

// the N floats of a row at `src` into `dst`: float4 loads where the row's bytes are a multiple of 16, float2 where
// of 8 (the row then starts as aligned: the tensor is 16-byte aligned), else one at a time
template <int N>
__device__ __forceinline__ void load_row(const float* __restrict__ src, float* dst) {
  if (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(src) + i);
      dst[4 * i] = q.x, dst[4 * i + 1] = q.y, dst[4 * i + 2] = q.z, dst[4 * i + 3] = q.w;
    }
  } else if (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(src) + i);
      dst[2 * i] = q.x, dst[2 * i + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = __ldg(src + i);
  }
}

// u_r = Jc_r . x (index order), r < R
template <int R>
__device__ __forceinline__ void camera_rows(const float* jc, const float* xk, float* u) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float a = jc[r * 6] * xk[0];
#pragma unroll
    for (int i = 1; i < 6; ++i) a = a + jc[r * 6 + i] * xk[i];
    u[r] = a;
  }
}

// out_i = sum over r of J[r, i] * y_r (r in order), i < C
template <int R, int C>
__device__ __forceinline__ void transposed(const float* J, const float* y, float* out) {
#pragma unroll
  for (int i = 0; i < C; ++i) {
    float a = J[i] * y[0];
#pragma unroll
    for (int r = 1; r < R; ++r) a = a + J[r * C + i] * y[r];
    out[i] = a;
  }
}

// the contribution of observation o (key `key`) to its key's sum, its Jacobian rows loaded into registers first
template <int R, bool KEYFRAMES>
__device__ __forceinline__ void contribution(const CgParams& p, int o, int key, float* c) {
  float jc[R * 6], jl[R * 3];
  load_row<R * 6>(p.jc + (long long)o * (R * 6), jc);
  load_row<R * 3>(p.jl + (long long)o * (R * 3), jl);
  const int k = KEYFRAMES ? key : p.other[o];
  float u[R];
  camera_rows<R>(jc, p.x + k * 6, u);
  if (!KEYFRAMES) {
    transposed<R, 3>(jl, u, c);
    return;
  }
  const int l = p.other[o];
  const float* m = p.hll_inv + l * 9;
  const float* vl = p.v + l * 3;
  float w[3], z[R];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float a = m[i * 3] * vl[0];
    a = a + m[i * 3 + 1] * vl[1];
    w[i] = a + m[i * 3 + 2] * vl[2];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float a = jl[r * 3] * w[0];
    a = a + jl[r * 3 + 1] * w[1];
    z[r] = a + jl[r * 3 + 2] * w[2];
  }
  transposed<R, 6>(jc, u, c);
  transposed<R, 6>(jc, z, c + 6);
}

__device__ __forceinline__ bool in_range(const CgParams& p, int key) { return key >= 0 && key < p.n_keys; }

// the sorted key at `pos`, -1 past the end (no sum is written for it)
__device__ __forceinline__ int key_at(const CgParams& p, int pos) { return pos < p.n ? p.keys[pos] : -1; }

// keys with no observation: zero sums (a grid-stride loop over the keys)
template <int D>
__device__ __forceinline__ void zero_empty_keys(const CgParams& p) {
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < p.n_keys; k += gridDim.x * blockDim.x)
    if (p.start[k] == p.end[k])
      for (int j = 0; j < D; ++j) p.out[k * D + j] = 0.0f;
}

// the sum `s` of a run of `key` that ends at `pos` in chunk `chunk` (first position c0): to the output where the
// key's whole segment lies in the chunk, else to the chunk's first partial (the key began in an earlier chunk) or
// last partial (it goes on in a later one)
template <int D>
__device__ __forceinline__ void put_run(const CgParams& p, int chunk, int c0, int key, int pos, const double* s) {
  if (!in_range(p, key)) return;
  if (p.start[key] < c0) {
#pragma unroll
    for (int j = 0; j < D; ++j) p.first[chunk * D + j] = s[j];
  } else if (p.end[key] > pos + 1) {
#pragma unroll
    for (int j = 0; j < D; ++j) p.last[chunk * D + j] = s[j];
  } else {
#pragma unroll
    for (int j = 0; j < D; ++j) p.out[key * D + j] = (float)s[j];
  }
}

// the last block to finish sums the keys that cross a chunk boundary, in chunk order, and resets the ticket
template <int D>
__device__ __forceinline__ void cross_chunk_sums(const CgParams& p) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int c = threadIdx.x + 1; c < p.n_chunks; c += blockDim.x) {
    const int k = p.keys[c * CG_CHUNK];
    if (!in_range(p, k)) continue;
    const int first_chunk = p.start[k] / CG_CHUNK;
    if (first_chunk + 1 != c) continue;  // not the key's first boundary, or the key begins here
    const int last_chunk = (p.end[k] - 1) / CG_CHUNK;
    double acc[D];
#pragma unroll
    for (int j = 0; j < D; ++j) acc[j] = __ldcg(p.last + first_chunk * D + j);
    for (int cc = c; cc <= last_chunk; ++cc)
#pragma unroll
      for (int j = 0; j < D; ++j) acc[j] = acc[j] + __ldcg(p.first + cc * D + j);
#pragma unroll
    for (int j = 0; j < D; ++j) p.out[k * D + j] = (float)acc[j];
  }
  if (threadIdx.x == 0) *p.ticket = 0u;
}

template <int R, bool KEYFRAMES>
__global__ void __launch_bounds__(CG_THREADS) schur_cg_kernel(CgParams p) {
  constexpr int D = KEYFRAMES ? 12 : 3;
  constexpr int P = CG_PER_THREAD, WARPS = CG_THREADS / 32;
  __shared__ double s_total[D * WARPS];  // each warp's inclusive scan at its last lane, plane-major
  __shared__ int s_starts[WARPS];        // whether a run starts in the warp
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int chunk = blockIdx.x, c0 = chunk * CG_CHUNK, p0 = c0 + t * P;
  zero_empty_keys<D>(p);

  // the thread's positions in order, each run's sum in float64; a run between two key changes is written at once
  const int head_key = key_at(p, p0);
  int run_key = head_key, head_end = p0 + P - 1;
  bool broken = false;  // a key change inside the thread
  double acc[D], head[D];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int pos = p0 + i, key = i == 0 ? head_key : key_at(p, pos);
    float c[D];
#pragma unroll
    for (int j = 0; j < D; ++j) c[j] = 0.0f;
    if (pos < p.n && in_range(p, key)) contribution<R, KEYFRAMES>(p, p.order[pos], key, c);
    const bool change = i > 0 && key != run_key;
    if (change) {
      if (broken) {
        put_run<D>(p, chunk, c0, run_key, pos - 1, acc);  // the key's whole segment
      } else {
        head_end = pos - 1;
#pragma unroll
        for (int j = 0; j < D; ++j) head[j] = acc[j];
      }
      broken = true;
      run_key = key;
    }
#pragma unroll
    for (int j = 0; j < D; ++j) acc[j] = i == 0 || change ? (double)c[j] : acc[j] + (double)c[j];
  }

  // segmented inclusive scan of (a run starts in the thread, the last run's sum) over the warp
  const bool head_starts = t == 0 || key_at(p, p0 - 1) != head_key;
  int f = head_starts || broken;
  double v[D];
#pragma unroll
  for (int j = 0; j < D; ++j) v[j] = acc[j];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int fu = __shfl_up_sync(FULL, f, off);
    double u[D];
#pragma unroll
    for (int j = 0; j < D; ++j) u[j] = __shfl_up_sync(FULL, v[j], off);
    if (lane >= off && !f) {
#pragma unroll
      for (int j = 0; j < D; ++j) v[j] = u[j] + v[j];
      f = fu;
    }
  }
  const int fe = __shfl_up_sync(FULL, f, 1);  // the lanes before this one
  double ve[D];
#pragma unroll
  for (int j = 0; j < D; ++j) ve[j] = __shfl_up_sync(FULL, v[j], 1);
  if (lane == 31) {
#pragma unroll
    for (int j = 0; j < D; ++j) s_total[j * WARPS + w] = v[j];
    s_starts[w] = f;
  }
  __syncthreads();
  // the sum the thread's first run carries in: the warps before this one in order, then the lanes before it
  double carry[D];
#pragma unroll
  for (int j = 0; j < D; ++j) carry[j] = 0.0;
  for (int ww = 0; ww < w; ++ww) {
    const bool starts = s_starts[ww];
#pragma unroll
    for (int j = 0; j < D; ++j) carry[j] = starts ? s_total[j * WARPS + ww] : carry[j] + s_total[j * WARPS + ww];
  }
  if (lane > 0) {
#pragma unroll
    for (int j = 0; j < D; ++j) carry[j] = fe ? ve[j] : carry[j] + ve[j];
  }

  // the first run's sum (where it ends inside the thread) and the last run's (where it ends at the last position)
  double total[D], tail[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const double own = broken ? head[j] : acc[j];
    total[j] = head_starts ? own : carry[j] + own;
    tail[j] = broken ? acc[j] : total[j];
  }
  if (broken) put_run<D>(p, chunk, c0, head_key, head_end, total);
  const int p_last = p0 + P - 1;
  if (t == CG_THREADS - 1 || key_at(p, p_last + 1) != run_key) put_run<D>(p, chunk, c0, run_key, p_last, tail);

  cross_chunk_sums<D>(p);
}

template <bool KEYFRAMES>
int launch(const CgParams& p, int R, cudaStream_t s) {
  if (p.n < 1 || p.n_keys < 1 || p.n_chunks != (p.n + CG_CHUNK - 1) / CG_CHUNK) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)p.jc | (uintptr_t)p.jl) & 15) return (int)cudaErrorMisalignedAddress;
  if (R == 4)
    schur_cg_kernel<4, KEYFRAMES><<<p.n_chunks, CG_THREADS, 0, s>>>(p);
  else if (R == 3)
    schur_cg_kernel<3, KEYFRAMES><<<p.n_chunks, CG_THREADS, 0, s>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// pass L: v (n_keys = L, 3) from x
extern "C" int xs_schur_cg_anchors(const void* jc, const void* jl, const void* order, const void* keys,
                                   const void* start, const void* end, const void* frame_idx, const void* x,
                                   void* first, void* last, void* ticket, void* v, int n, int R, int n_keys,
                                   int n_chunks, void* stream) {
  const CgParams p{(const float*)jc, (const float*)jl, (const int*)order, (const int*)keys, (const int*)start,
                   (const int*)end, (const int*)frame_idx, (const float*)x, nullptr, nullptr, (double*)first,
                   (double*)last, (unsigned*)ticket, (float*)v, n, n_keys, n_chunks};
  return launch<false>(p, R, (cudaStream_t)stream);
}

// pass K: hz (n_keys = K, 12) from x, Hll_inv and the summed v
extern "C" int xs_schur_cg_keyframes(const void* jc, const void* jl, const void* order, const void* keys,
                                     const void* start, const void* end, const void* anchor_idx, const void* x,
                                     const void* hll_inv, const void* v, void* first, void* last, void* ticket,
                                     void* hz, int n, int R, int n_keys, int n_chunks, void* stream) {
  const CgParams p{(const float*)jc, (const float*)jl, (const int*)order, (const int*)keys, (const int*)start,
                   (const int*)end, (const int*)anchor_idx, (const float*)x, (const float*)hll_inv,
                   (const float*)v, (double*)first, (double*)last, (unsigned*)ticket, (float*)hz, n, n_keys,
                   n_chunks};
  return launch<true>(p, R, (cudaStream_t)stream);
}
