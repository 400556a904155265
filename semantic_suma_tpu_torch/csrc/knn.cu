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
// pixel with no kept neighbour keeps its own class. The answer equals the
// JAX function's exactly.
//
// Bound on an H100: the bytes. Each pixel reads its class and range once
// and writes one label: 12 bytes a pixel, ~0.69 MB at 64x900, ~0.0002 ms
// at 3.35 TB/s, under the launch floor. Design: one thread per pixel, 32x8
// pixels a block; the 25 window loads go through the read-only cache (the
// two images, 460 KB together, stay in L2); the top K is an insertion list
// held in registers (every index is a compile-time constant after
// unrolling), then K*K label comparisons decide the vote.

#include <cuda_runtime.h>

namespace {

constexpr int R = 2;   // window 5x5
constexpr int K = 5;   // nearest neighbours that vote

__global__ void __launch_bounds__(256)
knn_vote_kernel(const int* __restrict__ cls, const float* __restrict__ depth,
                int* __restrict__ out, int h, int w, float cutoff) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const float d0 = __ldg(depth + y * w + x);

  float td[K];
  int tl[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    td[j] = 0.0f;
    tl[j] = 0;
  }
  int n = 0;  // kept candidates so far, at most K

#pragma unroll
  for (int dy = -R; dy <= R; ++dy) {
    const int ny = y + dy;
    if (ny < 0 || ny >= h) continue;  // vertical wrap is not adjacency
#pragma unroll
    for (int dx = -R; dx <= R; ++dx) {
      int nx = (x + dx) % w;
      if (nx < 0) nx += w;
      const float nd = __ldg(depth + ny * w + nx);
      const float d = fabsf(d0 - nd);
      // a NaN or infinite centre range fails here too
      if (!(isfinite(nd) && d < cutoff)) continue;
      if (n == K && !(d < td[K - 1])) continue;
      float cd = d;
      int cl = __ldg(cls + ny * w + nx);
      // insert after every kept candidate with a difference <= d: the
      // window index grows, so equal differences keep the earlier first
      bool carry = true, shifting = false;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (carry) {
          if (j >= n) {
            td[j] = cd;
            tl[j] = cl;
            carry = false;
          } else if (shifting || cd < td[j]) {
            const float t = td[j];
            const int l = tl[j];
            td[j] = cd;
            tl[j] = cl;
            cd = t;
            cl = l;
            shifting = true;
          }
        }
      }
      n = n < K ? n + 1 : K;
    }
  }

  int label = __ldg(cls + y * w + x);
  if (n > 0) {
    int best = -1;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j < n) {
        int count = 0;
#pragma unroll
        for (int m = 0; m < K; ++m) count += (m < n && tl[m] == tl[j]);
        if (count > best) {  // the first maximum: the nearest of a tie
          best = count;
          label = tl[j];
        }
      }
    }
  }
  out[y * w + x] = label;
}

}  // namespace

extern "C" int knn_vote(const void* cls, const void* depth, void* out, int h,
                        int w, float cutoff, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  knn_vote_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cls), static_cast<const float*>(depth),
      static_cast<int*>(out), h, w, cutoff);
  return static_cast<int>(cudaGetLastError());
}
