// SqueezeSegV3's spatially-adaptive modulation (SAC-ISK, Xu et al., ECCV 2020,
// arXiv:2004.01803): the input of a SAC block's adaptive 3x3 convolution,
// written as im2col times a per-pixel, per-channel, per-tap attention,
//   out[n, c*9 + t, h, w] = sigmoid(bn(a[n, c*9 + t, h, w]))
//                           * x[n, c, h + t/3 - 1, w + t%3 - 1]
// (x zero outside the image), in one pass, rounded once to bfloat16 for the
// 1x1 convolution that reads it.
//
// It replaces no TPU kernel: the JAX package has no SqueezeSegV3. Without it
// the modulation is four ATen passes over 9C x H x W elements (the batch
// norm's addcmul, the sigmoid, F.unfold, the product) and its float32
// intermediates, and no library call computes it: each weight of the adaptive
// convolution belongs to its own pixel.
//
// Per element, in the order and roundings of the plain version
// (ops/sac.sac_modulate_plain, the ATen operations of the module forward):
//   v = fma(float(a) - mean[j], mul[j], bias[j])   (ATen's addcmul)
//   s = 1 / (1 + expf(-v))                         (ATen's sigmoid, IEEE /)
//   out = bfloat16_rn(float(x_neighbour) * s)
// with j = c*9 + t, the channel order of F.unfold. Tried on an H100 against
// the plain version on the card over the 23 calls of a 64x2048 forward and
// four odd shapes: 0 of 868,515,336 elements differ.
//
// Bound on an H100: the bytes, nearly. A call reads a (9C.H.W bfloat16) and
// x (C.H.W) once and writes out (9C.H.W) once: 38 B a pixel and channel,
// 159.4 MB at every stage of a 64x2048 SqueezeSegV3-53 forward (C.W = 65,536
// at H = 64), 47.6 us at 3.35 TB/s. The sigmoid costs ~25 instructions an
// element (expf's range reduction and ex2, the IEEE division): 37.7 M
// elements a call is ~40 us of the card's FP32 issue rate, close to the
// bytes' time. Measured alone in a replayed graph: 0.087-0.090 ms a call,
// 53-55% of the bytes bound.
//
// Design, against that bound:
//  * A block takes a tile of TP pixels along one row (TP = 2048 / C: every
//    tile holds 2048 pixel-channels of x) and stages x's three rows around
//    it, TP + 2 pixels by C channels each, into shared memory with 16-byte
//    loads. Rows and columns outside the image are staged as zeros, so the
//    product needs no bounds test. x is read from L2 about three times (once
//    a row it borders) and from device memory about once.
//  * A thread writes 8 consecutive output channels of a pixel (16 bytes):
//    a warp's loads of a and stores of out cover 512 contiguous bytes. The
//    batch norm's constants of those 8 channels come through the read-only
//    cache (9C x 12 B, shared by every block).
//  * Nothing is allocated: the caller hands in the output. One launch on the
//    caller's stream, no synchronisation; cudaGetLastError() is returned.
//  * It takes channels in multiples of 8, at most 2048, and 16-byte aligned
//    pointers (fresh allocations).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileElems = 2048;   // pixel-channels of x a tile holds

__device__ __forceinline__ float sigmoid_bn(float t, float mean, float mul,
                                            float bias) {
  const float v = __fmaf_rn(__fsub_rn(t, mean), mul, bias);
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
}

__device__ __forceinline__ void unpack8(uint4 p, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void load8(const float* __restrict__ p, float* f) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p + 4));
  f[0] = lo.x;
  f[1] = lo.y;
  f[2] = lo.z;
  f[3] = lo.w;
  f[4] = hi.x;
  f[5] = hi.y;
  f[6] = hi.z;
  f[7] = hi.w;
}

// One block a tile: image n, row h, pixels w0 .. w0 + tp - 1 (those inside
// the image). xs holds x's rows h - 1, h, h + 1 at pixels w0 - 1 .. w0 + tp,
// C channels innermost, zero outside the image.
__global__ void __launch_bounds__(kThreads)
    sac_kernel(const __nv_bfloat16* __restrict__ a,
               const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ mean, const float* __restrict__ mul,
               const float* __restrict__ bias,
               __nv_bfloat16* __restrict__ out, int height, int width, int c,
               int tp, int tiles_per_row) {
  extern __shared__ uint4 smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  const int row = blockIdx.x / tiles_per_row;   // n * height + h
  const int w0 = (blockIdx.x - row * tiles_per_row) * tp;
  const int h = row % height;
  const int span = tp + 2;                      // staged pixels a row
  const int chunks = c / 8;                     // 16-byte chunks a pixel

  // stage x: 3 rows x span pixels x chunks, zero outside the image
  for (int i = threadIdx.x; i < 3 * span * chunks; i += kThreads) {
    const int r = i / (span * chunks);
    const int rest = i - r * span * chunks;
    const int px = rest / chunks;
    const int ch = rest - px * chunks;
    const int hh = h + r - 1;
    const int ww = w0 + px - 1;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (hh >= 0 && hh < height && ww >= 0 && ww < width) {
      const long long pix = (long long)(row + r - 1) * width + ww;
      v = __ldg(reinterpret_cast<const uint4*>(x + pix * c) + ch);
    }
    reinterpret_cast<uint4*>(xs)[(r * span + px) * chunks + ch] = v;
  }
  __syncthreads();

  const int pixels = min(tp, width - w0);
  const int vecs = 9 * chunks;                  // 16-byte vectors a pixel
  const long long first = (long long)row * width + w0;
  for (int i = threadIdx.x; i < pixels * vecs; i += kThreads) {
    const int px = i / vecs;
    const int j0 = (i - px * vecs) * 8;         // first output channel
    const long long e = (first + px) * (9LL * c) + j0;
    float av[8], m[8], k[8], b[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(a + e)), av);
    load8(mean + j0, m);
    load8(mul + j0, k);
    load8(bias + j0, b);
    int ch = j0 / 9;
    int tap = j0 - 9 * ch;
    float o[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int dr = tap / 3;                   // staged row: h - 1 + dr
      const int dc = tap - 3 * dr;              // staged pixel: px + dc
      const float xv =
          __bfloat162float(xs[(dr * span + px + dc) * c + ch]);
      o[q] = __fmul_rn(xv, sigmoid_bn(av[q], m[q], k[q], b[q]));
      if (++tap == 9) {
        tap = 0;
        ++ch;
      }
    }
    uint4 packed;
    __nv_bfloat162* ph = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      ph[q] = __floats2bfloat162_rn(o[2 * q], o[2 * q + 1]);
    *reinterpret_cast<uint4*>(out + e) = packed;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// a bf16[n, h, w, 9c] and out bf16[n, h, w, 9c] (channels_last
// [N, 9C, H, W] tensors, channel c*9 + t innermost), x bf16[n, h, w, c]
// (channels_last [N, C, H, W]), mean, mul, bias f32[9c]. c a multiple of 8, at
// most 2048; all on the device, 16-byte aligned. Launches one kernel on
// `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int sac_modulate(const void* a, const void* x, const float* mean,
                            const float* mul, const float* bias, void* out,
                            int n, int height, int width, int c,
                            cudaStream_t stream) {
  if (a == nullptr || x == nullptr || mean == nullptr || mul == nullptr ||
      bias == nullptr || out == nullptr || n <= 0 || height <= 0 ||
      width <= 0 || c <= 0 || c % 8 != 0 || c > kTileElems ||
      !aligned16(a) || !aligned16(x) || !aligned16(mean) || !aligned16(mul) ||
      !aligned16(bias) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  int tp = kTileElems / c;
  if (tp > width) tp = width;
  const int tiles_per_row = (width + tp - 1) / tp;
  const long long blocks = (long long)n * height * tiles_per_row;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)3 * (tp + 2) * c * sizeof(__nv_bfloat16);
  sac_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(x), mean, mul, bias,
      static_cast<__nv_bfloat16*>(out), height, width, c, tp, tiles_per_row);
  return (int)cudaGetLastError();
}
