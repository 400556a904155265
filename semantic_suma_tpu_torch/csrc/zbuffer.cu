// Per-pixel nearest-candidate z-buffer for Hopper (sm_90a).
//
// Replaces the XLA sort formulations of semantic_suma_tpu/ops/zbuffer.py
// (zbuffer_argmin and zbuffer_runs). A TPU has no atomic scatter, so the JAX
// package sorts (cell, quantized depth, index) keys and reads the head of each
// cell's run. Hopper has 64-bit atomics, so each query is an atomicMin on a
// table of 64-bit cells keyed
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
// 2 flags, one of them existence-only): bytes = 2^18 x (4 or 8 B id + 4 B
// depth + 2 B flags) + 3 x 57,600 x (8 B winner + 4 B depth), ~1.7 us at
// 3.35 TB/s; atomics = one per non-empty cell of every query that needs its
// winner, which no atomic design avoids, at the card's rate for 64-bit atomics
// on distinct cells. Both lie under the cost of one launch (~5 us for a
// replayed graph of one empty kernel), and the answer takes two.
//
// Design, against that bound:
//  * Two launches, none to fill. The key table is a workspace that the caller
//    keeps filled with the empty key. scatter_kernel lowers it; decode_kernel
//    reads each cell, writes the empty key back where it was lowered, and
//    writes the finished answer: winner (-1 = none) and winner depth (+inf =
//    none; depth[winner] for query 0 and in the exact branch, the bucket floor
//    (key - qoff) / scale, correctly rounded, for a flag in the packed branch),
//    so nothing runs after it. A table may serve one stream at a time.
//  * A flag of which only existence is wanted issues no atomic: a plain store
//    of key 0 into its cell, a benign race of equal values; decode reports
//    winner 0 and depth 0.
//  * Inputs as they come: int32 or int64 ids, up to three one-byte flag arrays
//    by pointer; outputs int64 winners and f32 depths, the types the callers
//    index and compare with.
//  * Tried on the card and not kept (times in PERF.md): looking before the
//    atomic, i.e. reading the cell and skipping the atomicMin when it already
//    holds a smaller key, is slower at both shapes (1.5x at the fusion shape):
//    the atomic returns nothing, so the thread never waits for it, while the
//    look is a round trip to L2 that it does wait for. One cooperative launch
//    with a grid-wide barrier between the passes is slower at both shapes too
//    (~20% at the fusion shape).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr long long kEmpty = 0x7fffffffffffffffLL;
constexpr int kThreads = 256;

struct Query {
  const float* depth;
  const uint8_t* flag[3];
  int n, num_flags, payload_mask;  // bit k: flag k wants its winner
  long long num_cells;
  int exact;
  float scale;
  int qclip, qoff;
};

__device__ __forceinline__ int depth_key(float d, const Query& q) {
  if (q.exact) {
    if (d == 0.f) d = 0.f;                        // -0 sorts as +0
    if (d != d) d = __int_as_float(0x7fc00000);   // one NaN, sorted last
    const int b = __float_as_int(d);
    return b < 0 ? (b ^ 0x7fffffff) : b;
  }
  const float s = __fmul_rn(d, q.scale);
  int k;
  if (!(s > 0.f)) {
    k = 0;  // negatives and NaN truncate into bucket 0
  } else if (s >= (float)q.qclip) {
    k = q.qclip;
  } else {
    k = (int)s;
  }
  return k + q.qoff;
}

template <typename IdT>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const IdT* __restrict__ ids, Query q,
                   long long* __restrict__ table) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= q.n) return;
  const long long id = ids[i];
  if (id < 0 || id >= q.num_cells) return;
  const long long key =
      (long long)depth_key(q.depth[i], q) * 4294967296LL + i;
  atomicMin(table + id, key);
  for (int k = 0; k < q.num_flags; ++k) {
    if (!q.flag[k][i]) continue;
    long long* cell = table + (k + 1) * q.num_cells + id;
    if ((q.payload_mask >> k) & 1) {
      atomicMin(cell, key);
    } else {
      *cell = 0;  // existence only: no atomic
    }
  }
}

// Cell j of every query: the finished answer out, the empty key back in.
__global__ void __launch_bounds__(kThreads)
    decode_kernel(Query q, long long* __restrict__ table,
                  long long* __restrict__ winner, float* __restrict__ wdepth) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= q.num_cells) return;
  for (int k = 0; k <= q.num_flags; ++k) {
    const long long off = k * q.num_cells + j;
    const long long key = __ldcg(table + off);  // L2: where the atomics land
    long long w = -1;
    float d = CUDART_INF_F;
    if (key != kEmpty) {
      table[off] = kEmpty;
      if (k > 0 && !((q.payload_mask >> (k - 1)) & 1)) {
        w = 0;
        d = 0.f;
      } else {
        w = key & 0xffffffffLL;
        d = (k == 0 || q.exact)
                ? q.depth[w]
                : __fdiv_rn(__int2float_rn((int)(key >> 32) - q.qoff), q.scale);
      }
    }
    winner[off] = w;
    wdepth[off] = d;
  }
}

template <typename IdT>
int run(const void* ids, const Query& q, long long* table, long long* winner,
        float* wdepth, cudaStream_t stream) {
  if (q.n > 0) {
    const int gcand = (q.n + kThreads - 1) / kThreads;
    scatter_kernel<IdT><<<gcand, kThreads, 0, stream>>>(
        static_cast<const IdT*>(ids), q, table);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  const int gcells = (int)((q.num_cells + kThreads - 1) / kThreads);
  decode_kernel<<<gcells, kThreads, 0, stream>>>(q, table, winner, wdepth);
  return (int)cudaGetLastError();
}

}  // namespace

// ids i32[n] or i64[n] (ids_i64), depth f32[n], flag0..2 u8[n] (non-zero =
// set; null beyond num_flags); payload_mask bit k set when flag k wants its
// winner and depth, clear when only existence. table i64[(1 + num_flags) *
// num_cells] holds the empty key (INT64_MAX) in every cell on entry and again
// when the launches have run. Outputs winner i64 and wdepth f32, both
// [(1 + num_flags) * num_cells]. Two launches on `stream` (one when n = 0);
// returns the first non-zero cudaGetLastError().
extern "C" int zbuffer_cells(const void* ids, int ids_i64, const float* depth,
                             const uint8_t* flag0, const uint8_t* flag1,
                             const uint8_t* flag2, int n, int num_flags,
                             int payload_mask, long long num_cells, int exact,
                             float scale, int qclip, int qoff,
                             long long* table, long long* winner,
                             float* wdepth, cudaStream_t stream) {
  if (num_flags < 0 || num_flags > 3 || num_cells <= 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  const Query q = {depth, {flag0, flag1, flag2}, n, num_flags, payload_mask,
                   num_cells, exact, scale, qclip, qoff};
  return ids_i64 ? run<long long>(ids, q, table, winner, wdepth, stream)
                 : run<int>(ids, q, table, winner, wdepth, stream);
}
