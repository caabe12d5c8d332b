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
// Design: a block a chunk of CG_THREADS consecutive sorted positions, a
// thread a position (N / 256 blocks: 720 at the loop backend's N = 184,320,
// where a block a keyframe would give 41 blocks to 132 SMs). A block computes
// its positions' contributions, converts them to double and takes a
// segmented inclusive scan by key in shared memory (Hillis-Steele: a fixed
// tree). At the end of each run of one key in the chunk the thread writes the
// run's sum: to the output, rounded, where the key's whole segment lies in
// the chunk; else to the chunk's `first` partial (the run began in an earlier
// chunk) or `last` partial (it goes on in a later one). The block that takes
// the last ticket (an integer atomic) sums each key that crosses a chunk
// boundary in chunk order, last[c0] + first[c0 + 1] + ... + first[c1], going
// over the chunk boundaries (n_chunks of them, not the keys), and resets the
// ticket. Keys with no observation are zeroed by a grid-stride loop of stage
// one. One launch a pass: two a CG step.
//
// Bound: bytes. Each pass reads Jc and Jl once (72 B + 36 B an observation at
// R = 4 ... 144 B) with the sorted order, the keys and the observations'
// other index (12 B), the segments (8 B a key) and writes its sums; about 100
// (pass L) and 170 (pass K) float32 operations an observation. Pass L reads
// the Jacobians in anchor order, a gather of 96 B and 48 B rows; pass K in
// keyframe order, which build_ba_problem's observations already follow.

#include <cuda_runtime.h>

namespace {

constexpr int CG_THREADS = 256;  // sorted positions of a chunk: models/ba.py::CG_CHUNK

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

// the contribution of observation o (key `key`) to its key's sum
template <int R, bool KEYFRAMES>
__device__ __forceinline__ void contribution(const CgParams& p, int o, int key, float* c) {
  const float* jc = p.jc + (long long)o * (R * 6);
  const float* jl = p.jl + (long long)o * (R * 3);
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

template <int R, bool KEYFRAMES>
__global__ void __launch_bounds__(CG_THREADS) schur_cg_kernel(CgParams p) {
  constexpr int D = KEYFRAMES ? 12 : 3;
  __shared__ double s_val[CG_THREADS * D];
  __shared__ int s_flag[CG_THREADS];
  __shared__ int s_key[CG_THREADS];
  __shared__ bool s_last;
  const int t = threadIdx.x;
  const int chunk = blockIdx.x;
  const int c0 = chunk * CG_THREADS;
  const int pos = c0 + t;

  // keys with no observation: zero sums
  for (int k = blockIdx.x * CG_THREADS + t; k < p.n_keys; k += gridDim.x * CG_THREADS)
    if (p.start[k] == p.end[k])
      for (int j = 0; j < D; ++j) p.out[k * D + j] = 0.0f;

  int key = -1;
  double val[D];
#pragma unroll
  for (int j = 0; j < D; ++j) val[j] = 0.0;
  if (pos < p.n) {
    key = p.keys[pos];
    if (key >= 0 && key < p.n_keys) {
      float c[D];
      contribution<R, KEYFRAMES>(p, p.order[pos], key, c);
#pragma unroll
      for (int j = 0; j < D; ++j) val[j] = (double)c[j];
    }
  }
  s_key[t] = key;
#pragma unroll
  for (int j = 0; j < D; ++j) s_val[t * D + j] = val[j];
  __syncthreads();
  s_flag[t] = t == 0 || s_key[t - 1] != key;
  // segmented inclusive scan: s_val[t] becomes the sum of its run from the run's first position in the chunk
  for (int off = 1; off < CG_THREADS; off <<= 1) {
    __syncthreads();
    const bool take = t >= off && !s_flag[t];
    int flag = s_flag[t];
    if (take) {
#pragma unroll
      for (int j = 0; j < D; ++j) val[j] = s_val[(t - off) * D + j] + val[j];
      flag = s_flag[t - off];
    }
    __syncthreads();
    if (take) {
#pragma unroll
      for (int j = 0; j < D; ++j) s_val[t * D + j] = val[j];
      s_flag[t] = flag;
    }
  }
  const bool run_end = t == CG_THREADS - 1 || pos == p.n - 1 || s_key[t + 1] != key;
  if (pos < p.n && run_end && key >= 0 && key < p.n_keys) {
    const int s = p.start[key], e = p.end[key];
    if (s < c0) {
#pragma unroll
      for (int j = 0; j < D; ++j) p.first[chunk * D + j] = val[j];
    } else if (e > pos + 1) {
#pragma unroll
      for (int j = 0; j < D; ++j) p.last[chunk * D + j] = val[j];
    } else {
#pragma unroll
      for (int j = 0; j < D; ++j) p.out[key * D + j] = (float)val[j];
    }
  }

  // the last block to finish sums the keys that cross a chunk boundary
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int c = t + 1; c < p.n_chunks; c += CG_THREADS) {
    const int k = p.keys[c * CG_THREADS];
    if (k < 0 || k >= p.n_keys) continue;
    const int s = p.start[k];
    const int first_chunk = s / CG_THREADS;
    if (first_chunk + 1 != c) continue;  // not the key's first boundary, or the key begins here
    const int last_chunk = (p.end[k] - 1) / CG_THREADS;
    double acc[D];
#pragma unroll
    for (int j = 0; j < D; ++j) acc[j] = __ldcg(p.last + first_chunk * D + j);
    for (int cc = c; cc <= last_chunk; ++cc)
#pragma unroll
      for (int j = 0; j < D; ++j) acc[j] = acc[j] + __ldcg(p.first + cc * D + j);
#pragma unroll
    for (int j = 0; j < D; ++j) p.out[k * D + j] = (float)acc[j];
  }
  if (t == 0) *p.ticket = 0u;
}

template <bool KEYFRAMES>
int launch(const CgParams& p, int R, cudaStream_t s) {
  if (p.n < 1 || p.n_keys < 1 || p.n_chunks != (p.n + CG_THREADS - 1) / CG_THREADS) return (int)cudaErrorInvalidValue;
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
