// Per-pixel nearest-candidate z-buffer for Hopper (sm_90a).
//
// Replaces the XLA sort formulations of semantic_suma_tpu/ops/zbuffer.py
// (zbuffer_argmin and zbuffer_runs). A TPU has no atomic scatter, so the JAX
// package sorts (cell, quantized depth, index) keys and reads the head of each
// cell's run. Hopper has 64-bit atomics, so each query is one atomicMin per
// candidate on a table of 64-bit cells keyed
//
//     key = depth_key * 2^32 + candidate_index
//
// and the minimum is the lowest depth bucket, then the lowest input index:
// exactly the winner of the JAX stable sort. Query 0 takes every candidate
// whose id lies in [0, num_cells); query 1 + k takes those whose flag k is set.
//
// depth_key is bit-for-bit the JAX quantization: with
// depth_bits = 31 - bit_length(num_cells) and scale = 2^depth_bits / bound
// (rounded to f32), q = clip(trunc(f32(depth * scale)), 0, qclip) + qoff, where
// zbuffer_argmin passes (qclip, qoff) = (qmax, 0) and zbuffer_runs
// (qmax - 1, 1). When depth_bits < 12 (the JAX exact two-key sort) the key is
// the f32 depth itself, mapped to an int32 that orders like the float (-0
// counts as +0, every NaN equal and last, as in the JAX sort), so ties again
// go to the lowest index.
//
// Bound on an H100 SXM at the fusion shape (2^18 candidates, 57,600 cells,
// 2 flags): bytes = 2^18 x (8 B id + 4 B depth + 2 B flags) + 3 x 57,600 x
// (8 B winner + 4 B depth key) = 5.7 MB, 1.7 us at 3.35 TB/s; the arithmetic is
// a few integer ops per candidate. The atomics on a 1.4 MB table stay in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kEmpty = 0x7fffffffffffffffLL;
constexpr int kThreads = 256;

__device__ __forceinline__ int depth_key(float d, int exact, float scale,
                                         int qclip, int qoff) {
  if (exact) {
    if (d == 0.f) d = 0.f;                        // -0 sorts as +0
    if (d != d) d = __int_as_float(0x7fc00000);   // one NaN, sorted last
    const int b = __float_as_int(d);
    return b < 0 ? (b ^ 0x7fffffff) : b;
  }
  const float s = d * scale;
  int q;
  if (!(s > 0.f)) {
    q = 0;  // negatives and NaN truncate into bucket 0
  } else if (s >= (float)qclip) {
    q = qclip;
  } else {
    q = (int)s;
  }
  return q + qoff;
}

__global__ void fill_kernel(long long* cells, long long total) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < total) cells[j] = kEmpty;
}

__global__ void scatter_kernel(const long long* __restrict__ ids,
                               const float* __restrict__ depth,
                               const uint8_t* __restrict__ flags, int n,
                               int num_flags, long long num_cells, int exact,
                               float scale, int qclip, int qoff,
                               long long* __restrict__ cells) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long id = ids[i];
  if (id < 0 || id >= num_cells) return;
  const long long key =
      (long long)depth_key(depth[i], exact, scale, qclip, qoff) * 4294967296LL + i;
  atomicMin(cells + id, key);
  for (int k = 0; k < num_flags; ++k) {
    if (flags[(size_t)k * n + i]) atomicMin(cells + (k + 1) * num_cells + id, key);
  }
}

__global__ void decode_kernel(const long long* __restrict__ cells,
                              long long total, long long* __restrict__ winner,
                              int* __restrict__ dkey) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= total) return;
  const long long key = cells[j];
  if (key == kEmpty) {
    winner[j] = -1;
    dkey[j] = 0;
  } else {
    winner[j] = key & 0xffffffffLL;
    dkey[j] = (int)(key >> 32);
  }
}

}  // namespace

// ids i64[n], depth f32[n], flags u8[num_flags, n] (may be null when
// num_flags == 0); scratch cells i64[(1 + num_flags) * num_cells]; outputs
// winner i64[(1 + num_flags) * num_cells] (-1 = empty) and dkey
// i32[(1 + num_flags) * num_cells] (the winner's depth key). Launches three
// kernels on `stream`; returns the first non-zero cudaGetLastError().
extern "C" int zbuffer_cells(const long long* ids, const float* depth,
                             const uint8_t* flags, int n, int num_flags,
                             long long num_cells, int exact, float scale,
                             int qclip, int qoff, long long* cells,
                             long long* winner, int* dkey,
                             cudaStream_t stream) {
  const long long total = (long long)(1 + num_flags) * num_cells;
  const int gcells = (int)((total + kThreads - 1) / kThreads);
  fill_kernel<<<gcells, kThreads, 0, stream>>>(cells, total);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  if (n > 0) {
    scatter_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        ids, depth, flags, n, num_flags, num_cells, exact, scale, qclip, qoff,
        cells);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  decode_kernel<<<gcells, kThreads, 0, stream>>>(cells, total, winner, dkey);
  return (int)cudaGetLastError();
}
