// The five gather probes: which gather forms a hand-written kernel can use on
// this card, and what a chained dependent gather costs per element.
//
// Replace the Pallas kernels of apps/probe_pallas_gather.py (probe_a :56,
// probe_b :77, probe_c :98, probe_d :121, make_e :142), at the original's
// shapes. On the TPU each asked whether Mosaic accepts the gather form at
// all; on Hopper every form is an indexed load, so what the probes keep is
// the result (exact: copies, short float sums in the order of k, integers)
// and probe E's time.
//
// Bound on the H100: latency. Each moves a few KB (A-D one launch of at most
// 1024 threads, bytes-bound on paper at a few nanoseconds) and takes a
// launch's few microseconds; probe E's 8192 rays each walk a chain of
// n_steps dependent 4-byte loads from a 8 MB table that sits in L2, so its
// time is n_steps load latencies, not bytes or operations. Design: one
// thread per output element (lane = column, so a warp reads neighbouring
// columns of whichever rows its indices name), the loops inside the thread.

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 128;

// A: out[r, c] = table[idx[r, c], c]
__global__ void probe_a_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                               float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = table[idx[i] * LANES + i % LANES];
}

// B: out[r, c] = table[r, idx[r, c]]
__global__ void probe_b_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                               float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = table[(i / LANES) * LANES + idx[i]];
}

// C: sum over k < 16 of table[7 + k, k], in order of k
__global__ void probe_c_kernel(const float* __restrict__ table, float* __restrict__ out) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  float acc = 0.0f;
  for (int k = 0; k < 16; ++k) acc = acc + table[(7 + k) * LANES + k];
  out[0] = acc;
}

// D: sum over k < 8 of the 8-row slice that starts at row (24 k) % 248
__global__ void probe_d_kernel(const float* __restrict__ table, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  for (int k = 0; k < 8; ++k) acc = acc + table[((k * 24) % 248) * LANES + i];
  out[i] = acc;
}

// E: n_steps times idx = (idx + table[idx, lane] + 1) % n_rows
__global__ void probe_e_kernel(const int* __restrict__ table, const int* __restrict__ idx0,
                               int* __restrict__ out, int n, int n_rows, int n_steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int lane = i % LANES;
  int idx = idx0[i];
  for (int k = 0; k < n_steps; ++k) idx = (idx + table[idx * LANES + lane] + 1) % n_rows;
  out[i] = idx;
}

constexpr int BLOCK = 256;
inline int grid(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace

extern "C" int xs_probe_a(const void* table, const void* idx, void* out, int n, void* stream) {
  probe_a_kernel<<<grid(n), BLOCK, 0, (cudaStream_t)stream>>>((const float*)table, (const int*)idx, (float*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int xs_probe_b(const void* table, const void* idx, void* out, int n, void* stream) {
  probe_b_kernel<<<grid(n), BLOCK, 0, (cudaStream_t)stream>>>((const float*)table, (const int*)idx, (float*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int xs_probe_c(const void* table, void* out, void* stream) {
  probe_c_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const float*)table, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int xs_probe_d(const void* table, void* out, int n, void* stream) {
  probe_d_kernel<<<grid(n), BLOCK, 0, (cudaStream_t)stream>>>((const float*)table, (float*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int xs_probe_e(const void* table, const void* idx0, void* out, int n, int n_rows, int n_steps,
                          void* stream) {
  probe_e_kernel<<<grid(n), BLOCK, 0, (cudaStream_t)stream>>>((const int*)table, (const int*)idx0, (int*)out, n,
                                                              n_rows, n_steps);
  return (int)cudaGetLastError();
}
