// Kernel C: the per-pixel KNN label vote over a range image.
//
// Replaces the JAX package's knn_clean_image
// (semantic_suma_tpu/models/rangenet.py:208-253), which re-expressed
// rangenet_lib's CUDA KNN as 25 jnp.roll shifts and a lax.top_k. For every
// pixel it takes the 5x5 window around it (columns wrap: the yaw wrap is
// real; rows past the top or bottom edge are no candidates), keeps the
// neighbours whose range differs from the centre's by less than the cutoff,
// and among the K nearest of those (by |range difference|, the lower window
// index first among equal differences, as lax.top_k orders them) takes the
// label held by the most; the first such label in that order wins a tie. A
// pixel with no kept neighbour keeps its own class. NaN or infinite ranges
// are no candidates. The answer equals the JAX function's exactly.
//
// Bound on an H100: the bytes. Each pixel reads its class and range once
// and writes one label: 12 bytes a pixel, ~0.69 MB at 64x900, ~0.0002 ms at
// 3.35 TB/s, far under the launch floor. What held the first version (one
// thread a pixel reading its 25 taps through L2) at 3x the floor was
// latency: each tap's class load waited on its range test, a chain of ~50
// dependent L2 round trips with ~14 warps an SM to hide them. Design:
//   - Load the tile once. A block stages its TW x TH pixels' (range, class)
//     and a 2-pixel halo into shared memory with coalesced loads: one L2
//     round trip a block. Halo rows past the image edges hold +inf (no
//     candidate); a halo column's wrap is computed where it is loaded, not
//     per tap.
//   - One thread a pixel walks its 25 taps in window order from shared
//     memory. Its K nearest are (difference, label) pairs in registers,
//     kept sorted by a branch-free insertion (every index a compile-time
//     constant after unrolling): a tap goes in before the first entry with
//     a larger difference and every entry from there moves down one, so
//     equal differences keep the lower window index first without carrying
//     the index. A tap that is no candidate enters as +inf and goes nowhere.
// Spreading a pixel's taps over 2 or 4 lanes and merging their lists with
// warp shuffles (64-bit (difference, window index) keys, a bitonic merge)
// was tried first and was slower: with the tile in shared memory the
// kernel is bound by instructions issued, which the merges add to; a
// warp-uniform skip of taps that cannot enter the list was slower too.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int R = 2;                  // window 5x5
constexpr int WIN = 2 * R + 1;
constexpr int TAPS = WIN * WIN;
constexpr int K = 5;                  // nearest neighbours that vote
constexpr int TW = 32;                // pixels a block: TW columns ...
constexpr int TH = 8;                 // ... by TH rows, one thread each
constexpr int SW = TW + 2 * R;        // the staged tile with its halo
constexpr int SH = TH + 2 * R;
constexpr int THREADS = TW * TH;

__global__ void __launch_bounds__(THREADS)
knn_vote_kernel(const int* __restrict__ cls, const float* __restrict__ depth,
                int* __restrict__ out, int h, int w, float cutoff) {
  __shared__ float s_depth[SH * SW];
  __shared__ int s_cls[SH * SW];
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  for (int i = threadIdx.x; i < SH * SW; i += THREADS) {
    const int r = i / SW;
    const int c = i - r * SW;
    const int y = y0 + r - R;
    int x = (x0 + c - R) % w;
    if (x < 0) x += w;
    float d = CUDART_INF_F;  // rows past the edges: no candidate
    int l = 0;
    if (y >= 0 && y < h) {
      d = __ldg(depth + y * w + x);
      l = __ldg(cls + y * w + x);
    }
    s_depth[i] = d;
    s_cls[i] = l;
  }
  __syncthreads();

  const int tx = threadIdx.x % TW;
  const int ty = threadIdx.x / TW;
  const int x = x0 + tx;
  const int y = y0 + ty;
  if (x >= w || y >= h) return;
  const int centre = (ty + R) * SW + tx + R;
  const float d0 = s_depth[centre];

  float td[K];
  int tl[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    td[j] = CUDART_INF_F;
    tl[j] = 0;
  }
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    const int off = (ty + t / WIN) * SW + tx + t % WIN;
    const float nd = s_depth[off];
    const float diff = fabsf(d0 - nd);
    // a NaN or infinite centre range fails here too
    float d = (isfinite(nd) && diff < cutoff) ? diff : CUDART_INF_F;
    int l = s_cls[off];
    bool shift = false;  // the tap went in: every later entry moves down
#pragma unroll
    for (int j = 0; j < K; ++j) {  // insert, drop the last
      shift = shift || d < td[j];
      const float dj = td[j];
      const int lj = tl[j];
      td[j] = shift ? d : dj;
      tl[j] = shift ? l : lj;
      d = shift ? dj : d;
      l = shift ? lj : l;
    }
  }

  int label = s_cls[centre];
  int best = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    int count = 0;
#pragma unroll
    for (int m = 0; m < K; ++m)
      count += (td[m] < CUDART_INF_F && tl[m] == tl[j]);
    if (td[j] < CUDART_INF_F && count > best) {
      best = count;  // the first maximum: the nearest of a tie
      label = tl[j];
    }
  }
  out[y * w + x] = label;
}

}  // namespace

extern "C" int knn_vote(const void* cls, const void* depth, void* out, int h,
                        int w, float cutoff, void* stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  knn_vote_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cls), static_cast<const float*>(depth),
      static_cast<int*>(out), h, w, cutoff);
  return static_cast<int>(cudaGetLastError());
}
