// The darknet network's batch-norm epilogue: batch norm with the running
// statistics, leaky_relu(0.1), an optional residual or skip sum, and the
// roundings its consumers need, in one pass over a convolution's output.
//
// It replaces no TPU kernel. The JAX package's darknet network
// (semantic_suma_tpu/models/rangenet.py) runs flax's nn.BatchNorm and
// leaky_relu and leaves them to XLA, which fuses them into its convolutions'
// neighbours. Run as PyTorch operations on the card, each of the network's 72
// batch-norm sites was 7 to 10 passes over the activation (the float32 cast,
// the statistics' three tiny kernels, x - mean, addcmul, leaky_relu, the sum,
// the next convolution's bfloat16 cast): about 10.4 GB of traffic and 550
// launches a 64x2048 forward, two thirds of the network's device time.
//
// Per element of a bfloat16 convolution output y in channels_last memory
// (channels innermost), in the order and roundings of the PyTorch modules
// (models/rangenet.py: BatchNorm.forward, F.leaky_relu, the sums, the next
// Conv's .to(bfloat16)):
//   u = float(y) - mean[c];  v = u * mul[c] + bias[c];  w = v > 0 ? v : v * 0.1
//   s = r + w                           (where a float32 stream r is given)
//   out_f32 = s;  out_bf16 = round_to_nearest_even(s)  (each where asked for)
// mul = rsqrt(var + eps) * scale is computed once by the caller, by
// BatchNorm.forward's own expression. v is one fused multiply-add, rounded
// once, as ATen's addcmul computes it on the card (a + 1 * b * c, contracted):
// tried on an H100 against the modules' ATen operations on the inputs of every
// call of a darknet53 forward at 64x2048, the FMA gave 0 elements that differ,
// a multiply and an add 3,290,250. The network's logits equal the modules'.
//
// Bound on an H100: the bytes. At the network's widest activation, 1 x 32 x
// 64 x 2048 (E = 4,194,304 elements; every darknet53 site at 64x2048 is E or
// E/2), a call reads 2 B of y a element, 4 B of r where given, and writes 4 B
// of out_f32 and 2 B of out_bf16 where asked for: 8.4 MB (E/2, bfloat16 out
// only) to 50.3 MB (E, r in, both out), 2.5 to 15.0 us at 3.35 TB/s. There are
// ~3 operations an element: far below the card's ratio of operations to bytes.
//
// Design, against that bound:
//  * Every access of a warp is one contiguous span. A warp takes 256
//    consecutive elements at a time and a lane two groups of 4 channels,
//    at 4 lane and 128 + 4 lane: 8-byte loads and stores of bfloat16 and
//    16-byte loads and stores of float32, so that each instruction of the
//    warp covers 256 or 512 contiguous bytes. Both groups' loads are issued
//    before either is computed. Each store instruction thus writes whole
//    32-byte sectors.
//  * A grid-stride loop over a grid of whole waves on the card's SMs. The
//    grid's stride is a multiple of C, so a lane keeps its two channel groups
//    for all its elements: their means, multipliers and biases are loaded
//    into registers once.
//  * Nothing is allocated: the caller hands in the outputs. One launch on the
//    caller's stream, no synchronisation; cudaGetLastError() is returned.
//  * It takes channels in multiples of 8 (every darknet of the port has
//    them) and 16-byte aligned pointers (fresh allocations).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;      // elements a warp handles at a time
constexpr int kHalf = kChunk / 2;
constexpr int kBlocksPerSM = 8;  // 2048 threads: a full SM
constexpr float kSlope = 0.1f;

__device__ __forceinline__ float bn_leaky(float t, float mean, float mul,
                                          float bias) {
  const float v = __fmaf_rn(__fsub_rn(t, mean), mul, bias);
  return v > 0.f ? v : __fmul_rn(v, kSlope);
}

// The 4 elements of a group, from bfloat16 y and float32 r, batch-normed,
// activated and summed.
template <bool HAS_R>
__device__ __forceinline__ float4 group4(uint2 yv, float4 rv, const float* m,
                                         const float* k, const float* b) {
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&yv.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&yv.y));
  float4 s = make_float4(bn_leaky(lo.x, m[0], k[0], b[0]),
                         bn_leaky(lo.y, m[1], k[1], b[1]),
                         bn_leaky(hi.x, m[2], k[2], b[2]),
                         bn_leaky(hi.y, m[3], k[3], b[3]));
  if (HAS_R) {
    s.x = __fadd_rn(rv.x, s.x);
    s.y = __fadd_rn(rv.y, s.y);
    s.z = __fadd_rn(rv.z, s.z);
    s.w = __fadd_rn(rv.w, s.w);
  }
  return s;
}

__device__ __forceinline__ uint2 to_bf16x4(float4 s) {
  uint2 out;
  *reinterpret_cast<__nv_bfloat162*>(&out.x) = __floats2bfloat162_rn(s.x, s.y);
  *reinterpret_cast<__nv_bfloat162*>(&out.y) = __floats2bfloat162_rn(s.z, s.w);
  return out;
}

__device__ __forceinline__ void load4(const float* __restrict__ p,
                                      float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// A warp takes kChunk consecutive elements at a time, lane l the groups of
// 4 at 4 l and kHalf + 4 l: each load and store instruction of the warp
// covers one contiguous span (256 B of bfloat16, 512 B of float32).
template <bool HAS_R, bool OUT_F, bool OUT_B>
__global__ void __launch_bounds__(kThreads)
    bn_act_kernel(const __nv_bfloat16* __restrict__ y,
               const float* __restrict__ r, const float* __restrict__ mean,
               const float* __restrict__ mul, const float* __restrict__ bias,
               float* __restrict__ out_f, __nv_bfloat16* __restrict__ out_b,
               long long n, int c) {
  constexpr int kWarps = kThreads / 32;
  const long long stride = (long long)gridDim.x * kWarps * kChunk;
  const long long first = ((long long)blockIdx.x * kWarps + threadIdx.x / 32) *
                              kChunk +
                          4 * (threadIdx.x % 32);
  if (first >= n) return;
  // the stride is a multiple of c: the thread's two groups keep their
  // channels, whose constants it loads once
  float m[2][4], k[2][4], b[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ch = (int)((first + h * kHalf) % c);
    load4(mean + ch, m[h]);
    load4(mul + ch, k[h]);
    load4(bias + ch, b[h]);
  }
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long e = first; e < n; e += stride) {
    // n and c are multiples of 8: a group lies wholly inside or outside
    const long long e2 = e + kHalf;
    const bool two = e2 < n;
    const uint2 y1 = __ldg(reinterpret_cast<const uint2*>(y + e));
    const uint2 y2 =
        two ? __ldg(reinterpret_cast<const uint2*>(y + e2)) : make_uint2(0, 0);
    float4 r1 = zero, r2 = zero;
    if (HAS_R) {
      r1 = __ldg(reinterpret_cast<const float4*>(r + e));
      if (two) r2 = __ldg(reinterpret_cast<const float4*>(r + e2));
    }
    const float4 s1 = group4<HAS_R>(y1, r1, m[0], k[0], b[0]);
    const float4 s2 = group4<HAS_R>(y2, r2, m[1], k[1], b[1]);
    if (OUT_F) {
      *reinterpret_cast<float4*>(out_f + e) = s1;
      if (two) *reinterpret_cast<float4*>(out_f + e2) = s2;
    }
    if (OUT_B) {
      *reinterpret_cast<uint2*>(out_b + e) = to_bf16x4(s1);
      if (two) *reinterpret_cast<uint2*>(out_b + e2) = to_bf16x4(s2);
    }
  }
}

// The card's SMs, read once (0 while unread or where the read failed: the
// launch of no block then fails and reports it)
int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

bool aligned16(const void* p) {
  return p == nullptr || ((uintptr_t)p & 15u) == 0;
}

template <bool HAS_R, bool OUT_F, bool OUT_B>
void launch(const void* y, const float* r, const float* mean, const float* mul,
            const float* bias, float* out_f, void* out_b, long long n, int c,
            cudaStream_t stream) {
  const auto* yb = static_cast<const __nv_bfloat16*>(y);
  auto* ob = static_cast<__nv_bfloat16*>(out_b);
  const long long full = (long long)sm_count() * kBlocksPerSM;
  // blocks a multiple of `step`, so that the stride is one of c
  const long long per_block = (long long)kThreads / 32 * kChunk;
  const long long step = c / gcd(c, (int)per_block);
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > full) blocks = full;
  blocks = (blocks + step - 1) / step * step;
  bn_act_kernel<HAS_R, OUT_F, OUT_B><<<(unsigned)blocks, kThreads, 0, stream>>>(
      yb, r, mean, mul, bias, out_f, ob, n, c);
}

int dispatch(const void* y, const float* r, const float* mean,
             const float* mul, const float* bias, float* out_f, void* out_b,
             long long n, int c, cudaStream_t stream) {
  const int which = (r != nullptr) * 4 + (out_f != nullptr) * 2 +
                    (out_b != nullptr);
  switch (which) {
#define BN_ACT_CASE(R, F, B)                                          \
  case R * 4 + F * 2 + B:                                             \
    launch<(R) != 0, (F) != 0, (B) != 0>(y, r, mean, mul, bias, out_f, \
                                         out_b, n, c, stream);         \
    break;
    BN_ACT_CASE(0, 0, 1)
    BN_ACT_CASE(0, 1, 0)
    BN_ACT_CASE(0, 1, 1)
    BN_ACT_CASE(1, 0, 1)
    BN_ACT_CASE(1, 1, 0)
    BN_ACT_CASE(1, 1, 1)
#undef BN_ACT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// y bf16[n] (an [N, H, W, C] channels_last activation, C = c innermost, a
// multiple of 8), mean, mul, bias f32[c]; r f32[n] or null; out_f f32[n] or
// null, out_b bf16[n] or null, not both null. All on the device, 16-byte
// aligned.
// Launches one kernel on `stream`; returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int bn_act(const void* y, const float* r, const float* mean,
                      const float* mul, const float* bias, float* out_f,
                      void* out_b, long long n, int c, cudaStream_t stream) {
  if (y == nullptr || mean == nullptr || mul == nullptr || bias == nullptr ||
      c <= 0 || c % 8 != 0 || n <= 0 || n % c != 0 || !aligned16(y) ||
      !aligned16(r) || !aligned16(mean) || !aligned16(mul) ||
      !aligned16(bias) || !aligned16(out_f) || !aligned16(out_b))
    return (int)cudaErrorInvalidValue;
  return dispatch(y, r, mean, mul, bias, out_f, out_b, n, c, stream);
}
