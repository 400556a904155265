// SqueezeSegV3's attention convolution (SAC-ISK, Xu et al., ECCV 2020,
// arXiv:2004.01803) with its bias, in one pass: a SAC block's 7x7
// convolution from the three coordinate channels P to 9C channels,
//   out[n, j, h, w] = bf16_rn(float(bf16_rn(S)) + float(b[j])),
//   S = sum over dy, dx < 7, ci < 3 of P[n, h + dy - 3, w + dx - 3, ci]
//       * W[j, ci, dy, dx]   (float32),
// P zero outside the image (padding 3). The two roundings are the module
// forward's: cuDNN rounds its float32 sum to bfloat16, then ATen's bias add
// computes float(a) + float(b) and rounds once. Only the order of the
// 147-term sum differs from cuDNN's.
//
// It replaces no TPU kernel: the JAX package has no SqueezeSegV3. It replaces
// cuDNN's fprop and ATen's separate bias add (on an H100 ~0.28 and ~0.11 ms a
// call at 64x2048: a 3-channel input leaves the implicit GEMM a depth of 147,
// which it pads, and the add reads and writes the whole 9C tensor again).
//
// Bound on an H100: the bytes. A call writes out (9C.H.W bfloat16) once and
// reads the coordinates (<= 0.8 MB) and the weights (<= 0.7 MB): 75.5 MB at
// every stage of a 64x2048 SqueezeSegV3-53 forward (C.W = 65,536 at H = 64),
// ~23 us at 3.35 TB/s. Its 2 x 147 x 9C x H x W = 11.1 GFLOP are ~11 us of
// the tensor cores' bfloat16 peak; on mma.sync, with K padded to 168, the
// tensor pipes are busy ~19 us. Measured alone in a replayed graph: ~0.052
// ms a call, ~44% of the bytes bound (cuDNN and the bias add: 0.41-0.68 ms).
//
// Design, against that bound:
//  * The product is a GEMM of M = 9C channels, N = pixels and K = the taps,
//    on mma.sync (bfloat16 in, float32 sums). K is ordered as 21 chunks of 8
//    taps, chunk ci * 7 + dy holding dx = 0..7 (dx = 7 a zero weight): ten
//    k-steps of 16 and one of 8.
//  * A block of three warps owns 96 channels, a warp 32: its 32 x 168
//    weights stay in registers as A fragments (84) for the block's life, read
//    once from the [9C, 7, 7, 3] weight (the channels_last memory of
//    [9C, 3, 7, 7]). Four blocks an SM put three warps on each scheduler.
//  * The block walks over tiles of 64 pixels along one image row (a
//    persistent grid, as many blocks a channel slice as fill the card; the
//    next tile found by adding, not dividing). While it multiplies one
//    tile, 16-byte cp.async copies bring the next tile's seven coordinate
//    rows into shared memory as they lie, so no load waits. Per tile it
//    then stages them as four copies, [pixel pair][chunk]: pairs (x, x + 1)
//    and (x + 1, x + 2), and both with the second pixel zero. A lane's B
//    fragment, taps dx = 2q, 2q + 1 of pixel g, is one 32-bit word of the
//    copy of g's parity, and four chunks lie in one 16-byte load without
//    bank conflicts: no im2col is built. Lanes of q = 3 read the copies
//    whose dx = 7 half is zero, so that a coordinate outside the window
//    never enters the sum, even where it is not finite.
//  * Each warp multiplies 32 pixels at a time (eight accumulators), rounds,
//    adds the bias and rounds again in registers, and writes its 32
//    channels x 32 pixels transposed into one of its two shared-memory
//    boxes with stmatrix.trans, in the 64-byte swizzle (no bank conflicts).
//    One lane then hands the box to the tensor-memory accelerator, which
//    stores it (32 pixels x 64 contiguous bytes, clipped at the row's end
//    and at 9C) while the warp goes on: no store waits in the warps'
//    memory pipeline behind their shared-memory loads.
//  * Nothing is allocated: the caller hands in the output. One launch on the
//    caller's stream, no synchronisation; cudaGetLastError() is returned.
//  * It takes 9C a multiple of 8, any N, H and W; partial tiles and slices
//    are masked.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 3;
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSM = 4;
constexpr int kSlice = kWarps * 32;          // channels a block
constexpr int kTile = 64;                    // pixels a tile, along a row
constexpr int kTaps = 147;                   // 7 x 7 x 3
constexpr int kChunks = 21;                  // (ci, dy) rows of 8 dx taps
constexpr int kSteps = 10;                   // k-steps of 16; one of 8 more
constexpr int kRow = kTile + 8;              // staged pixels: -3 .. 68
constexpr int kPairs = kRow / 2;             // staged words a chunk
constexpr int kSeg = kRow / 4;               // pixels a staging thread
constexpr int kRawChunks = (3 * kRow + 14) / 8;   // a raw row, 16 bytes each
constexpr int kGroup = 4;                    // 8-pixel groups an iteration
constexpr int kStageBytes = kGroup * 8 * 64; // a warp's staged output box
constexpr int kMaxChannels = 9 * 2048;

// The staged copies: word [w][c] (c < 21 padded to 24) holds chunk c's
// pixels (2w, 2w + 1) in C0, (2w + 1, 2w + 2) in C1, (2w, 0) in Z0 and
// (2w + 1, 0) in Z1. C0 and Z0 start at bank 0, C1 and Z1 at bank 4: a
// quarter-warp's 16-byte loads then fall on 32 distinct banks.
constexpr int kChunkPad = 24;
constexpr int kCopyWords = kPairs * kChunkPad;
constexpr int after(int end, int bank) {
  return (end + 31 - bank) / 32 * 32 + bank;
}
constexpr int kC0 = 0;
constexpr int kZ0 = after(kC0 + kCopyWords, 0);
constexpr int kC1 = after(kZ0 + kCopyWords, 4);
constexpr int kZ1 = after(kC1 + kCopyWords, 4);
constexpr int kCopiesWords = kZ1 + kCopyWords;
static_assert(kRow % 8 == 0 && kTile % 16 == 0 && kSeg % 2 == 0 &&
                  kChunks * 4 <= kThreads && 3 * kRow + 7 <= 8 * kRawChunks,
              "tile shapes");

__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma1688(float* d, const uint32_t* a,
                                        uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0,
                                                  uint32_t r1, uint32_t r2,
                                                  uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
      "{%1, %2, %3, %4};\n"
      :
      : "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

// The tensor-memory accelerator's store of a box of `map` at (c0, c1, c2)
// from shared memory, and its bulk-group waits
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n"
      :
      : "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
        "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void tma_wait_read_all_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

__device__ __forceinline__ void tma_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// shared-memory writes of this thread made visible to the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// bf16_rn(float(bf16_rn(s)) + b) of a pair, packed (s0 in the low half)
__device__ __forceinline__ uint32_t round_bias_round(float s0, float s1,
                                                     float b) {
  const float2 a = __bfloat1622float2(__floats2bfloat162_rn(s0, s1));
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(__fadd_rn(a.x, b), __fadd_rn(a.y, b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// W[ch, tap (ci, dy, dx)] of the [cout, 7, 7, 3] weight, 0 past dx = 6 or
// past the channels. A volatile load: the compiler may not load it again
// inside the loop in place of holding it in a register.
__device__ __forceinline__ uint32_t weight(const uint16_t* __restrict__ wgt,
                                           int ch, int cout, int chunk,
                                           int dx) {
  if (ch >= cout || dx >= 7) return 0u;
  const int ci = chunk / 7;
  const int dy = chunk - ci * 7;
  unsigned short v;
  asm volatile("ld.global.nc.u16 %0, [%1];\n"
               : "=h"(v)
               : "l"(wgt + (long long)ch * kTaps + (dy * 7 + dx) * 3 + ci));
  return v;
}

// A tile: image row `row` of the n * height rows (h = row % height), pixels
// w0 .. w0 + kTile - 1 (w0 = tr * kTile); `start` is the element of
// coordinate row h - 3 at pixel w0 - 3 (negative before the tensor).
struct Tile {
  int row, tr, h, start;
};

// One block: channels [blockIdx.y * kSlice, + kSlice) of cout, over the
// tiles blockIdx.x, + gridDim.x, ... (tile t: row t / tiles_per_row, pixels
// from (t % tiles_per_row) * kTile). The coordinates have fewer than 2^31
// elements.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    attention7x7_kernel(const __grid_constant__ CUtensorMap out_map,
                        const uint16_t* __restrict__ p,
                        const uint16_t* __restrict__ wgt,
                        const uint16_t* __restrict__ bias,
                        int elems,
                        int height, int width, int cout, int tiles_per_row,
                        int tiles) {
  __shared__ __align__(16) uint32_t raw[2][7 * kRawChunks * 4];
  __shared__ __align__(16) uint32_t copies[kCopiesWords];
  // a warp's two output boxes, [8 kGroup pixels][32 channels] each in the
  // 64-byte swizzle of the output's tensor map (aligned to repeat it)
  __shared__ __align__(1024) unsigned char stage[kWarps][2][kStageBytes];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int wch = blockIdx.y * kSlice + warp * 32;   // the warp's channels
  const bool active = wch < cout;

  const int row3 = 3 * width;                // elements a coordinate row
  // the tile after `c`, gridDim.x on
  const int gdiv = gridDim.x / tiles_per_row;
  const int gmod = gridDim.x - gdiv * tiles_per_row;
  auto next = [&](Tile c) {
    c.tr += gmod;
    c.row += gdiv;
    c.h += gdiv;
    if (c.tr >= tiles_per_row) {
      c.tr -= tiles_per_row;
      ++c.row;
      ++c.h;
    }
    while (c.h >= height) c.h -= height;
    c.start = (c.row - 3) * row3 + (c.tr * kTile - 3) * 3;
    return c;
  };

  // tile c's raw coordinate rows h - 3 .. h + 3 into raw[b]: chunk i of
  // row dy holds elements 8i .. 8i + 7 from the multiple of 8 at or before
  // the row's first (rows outside the image are left as they are)
  auto fetch = [&](const Tile& c, int b) {
    const uint32_t base =
        static_cast<uint32_t>(__cvta_generic_to_shared(raw[b]));
#pragma unroll
    for (int k = 0; k < (7 * kRawChunks + kThreads - 1) / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int dy = i / kRawChunks;
      const int hh = c.h + dy - 3;
      const int e = ((c.start + dy * row3) & ~7) + 8 * (i - dy * kRawChunks);
      if (i < 7 * kRawChunks && hh >= 0 && hh < height && e >= 0 &&
          e < elems)
        cp_async16(base + 16 * i, p + e, min(16, 2 * (elems - e)));
    }
    cp_async_commit();
  };

  // the warp's weights as A fragments (rows: channels, columns: taps), k-step
  // ks holding chunks 2 ks and 2 ks + 1, the last chunk alone; its lane's
  // four biases
  uint32_t a[2][kSteps][4];
  uint32_t a_last[2][2];
  float bf[2][2];
  Tile cur;
  cur.row = blockIdx.x / tiles_per_row;
  cur.tr = blockIdx.x - cur.row * tiles_per_row;
  cur.h = cur.row % height;
  cur.start = (cur.row - 3) * row3 + (cur.tr * kTile - 3) * 3;
  if (blockIdx.x < tiles) fetch(cur, 0);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ch = wch + m * 16 + g + half * 8;
      bf[m][half] = ch < cout
          ? __bfloat162float(__ushort_as_bfloat16(__ldg(bias + ch)))
          : 0.f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          const int chunk = 2 * ks + kh;
          a[m][ks][kh * 2 + half] =
              weight(wgt, ch, cout, chunk, 2 * q) |
              (weight(wgt, ch, cout, chunk, 2 * q + 1) << 16);
        }
      }
      a_last[m][half] = weight(wgt, ch, cout, kChunks - 1, 2 * q) |
                        (weight(wgt, ch, cout, kChunks - 1, 2 * q + 1) << 16);
    }
  }

  // a lane's B words, taps dx = 2q, 2q + 1 of pixel g of an 8-pixel group:
  // pair g / 2 + q of the copy of g's parity, Z where q = 3
  const uint32_t* b_lane =
      copies + ((q == 3) ? ((g & 1) ? kZ1 : kZ0) : ((g & 1) ? kC1 : kC0)) +
      ((g >> 1) + q) * kChunkPad;
  const uint32_t stage_warp =
      static_cast<uint32_t>(__cvta_generic_to_shared(stage[warp]));
  // stmatrix: lane l gives row l % 8 (a pixel) of matrix l / 8 (8 channels);
  // chunk c of pixel r lies at r * 64 + 16 (c ^ (r / 2 % 4))
  const int sr = lane & 7;
  const uint32_t st_addr =
      stage_warp + sr * 64 + (((lane >> 3) ^ ((sr >> 1) & 3)) * 16);
  int box = 0;                                 // the warp's boxes so far

  // staging: thread 4 c + s (c < 21) takes pixels kSeg s .. kSeg (s + 1) of
  // chunk c = (ci, dy), and one more
  const int sc = threadIdx.x >> 2;
  const int sseg = threadIdx.x & 3;
  const int sci = sc / 7;
  const int sdy = sc - sci * 7;
  uint32_t* sdst = copies + sseg * (kSeg / 2) * kChunkPad + sc;

  int buf = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, buf ^= 1) {
    const Tile nxt = next(cur);
    const int w0 = cur.tr * kTile;

    // 1. this tile's raw rows have landed, and every warp is done with the
    // last tile's copies; the next tile's rows start on their way
    cp_async_wait_all();
    __syncthreads();
    if (t + (int)gridDim.x < tiles) fetch(nxt, buf ^ 1);
    if (sc < kChunks) {
      // staged pixels x in [lo, hi) lie in the image, none off its rows
      const int hh = cur.h + sdy - 3;
      const int lo = max(0, 3 - w0);
      const int hi = (hh >= 0 && hh < height) ? min(kRow, width - w0 + 3)
                                              : 0;
      const uint16_t* src = reinterpret_cast<const uint16_t*>(
                                raw[buf] + sdy * kRawChunks * 4) +
                            ((cur.start + sdy * row3) & 7) + sci;
      uint32_t v[kSeg + 1];
#pragma unroll
      for (int k = 0; k <= kSeg; ++k) {
        const int x = sseg * kSeg + k;
        v[k] = (x >= lo && x < hi) ? src[3 * x] : 0u;
      }
#pragma unroll
      for (int u = 0; u < kSeg / 2; ++u) {
        uint32_t* d = sdst + u * kChunkPad;
        d[kC0] = v[2 * u] | (v[2 * u + 1] << 16);
        d[kC1] = v[2 * u + 1] | (v[2 * u + 2] << 16);
        d[kZ0] = v[2 * u];
        d[kZ1] = v[2 * u + 1];
      }
    }
    __syncthreads();

    // 2. the warp's 32 channels x 64 pixels, 8 kGroup pixels at a time
    const int pixels = active ? min(kTile, width - w0) : 0;
    const int row = cur.row;
    cur = nxt;
#pragma unroll 1
    for (int j = 0; j * 8 < pixels; j += kGroup) {
      float acc[2][kGroup][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < kGroup; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[m][n][r] = 0.f;
      // each group's 21 chunks: 16-byte loads of four, then the last
      uint32_t b[kGroup][kChunks];
#pragma unroll
      for (int n = 0; n < kGroup; ++n) {
        const uint32_t* bn = b_lane + (j + n) * 4 * kChunkPad;
#pragma unroll
        for (int c4 = 0; c4 < kChunks / 4; ++c4) {
          const uint4 w4 = *reinterpret_cast<const uint4*>(bn + 4 * c4);
          b[n][4 * c4] = w4.x;
          b[n][4 * c4 + 1] = w4.y;
          b[n][4 * c4 + 2] = w4.z;
          b[n][4 * c4 + 3] = w4.w;
        }
        b[n][kChunks - 1] = bn[kChunks - 1];
      }
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < kGroup; ++n)
            mma16816(acc[m][n], a[m][ks], b[n][2 * ks], b[n][2 * ks + 1]);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < kGroup; ++n)
          mma1688(acc[m][n], a_last[m], b[n][kChunks - 1]);
      // 3. round, add the bias, round; transpose into one of the warp's
      // boxes (the store that last read it done); one lane stores the box
      const int sb = box++ & 1;
      if (lane == 0) tma_wait_read_all_but_one();
      __syncwarp();
#pragma unroll
      for (int n = 0; n < kGroup; ++n) {
        stmatrix_x4_trans(
            st_addr + sb * kStageBytes + n * 512,
            round_bias_round(acc[0][n][0], acc[0][n][1], bf[0][0]),
            round_bias_round(acc[0][n][2], acc[0][n][3], bf[0][1]),
            round_bias_round(acc[1][n][0], acc[1][n][1], bf[1][0]),
            round_bias_round(acc[1][n][2], acc[1][n][3], bf[1][1]));
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0)
        tma_store(&out_map, stage_warp + sb * kStageBytes, wch, w0 + j * 8,
                  row);
    }
  }
  if (lane == 0) tma_wait_all();
  cp_async_wait_all();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// The blocks an SM holds and the SMs of the current device, read once a
// device; a CUDA error code.
int residency(int* blocks_per_sm, int* sms) {
  constexpr int kMaxDevices = 64;
  static int blocks[kMaxDevices] = {0};
  static int count[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (blocks[dev] == 0) {
    rc = cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                                dev);
    int b = 0;
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &b, attention7x7_kernel, kThreads, 0);
    if (rc != cudaSuccess) return (int)rc;
    if (b == 0) return (int)cudaErrorInvalidConfiguration;
    blocks[dev] = b;
  }
  *blocks_per_sm = blocks[dev];
  *sms = count[dev];
  return (int)cudaSuccess;
}

// `map` describes out, bf16[rows][width][cout], to the tensor-memory
// accelerator in boxes of 32 channels x 8 kGroup pixels x 1 row; stores past
// a row's width or past cout are clipped. A CUDA error code.
int output_map(CUtensorMap* map, void* out, int rows, int width, int cout) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (rc != cudaSuccess) return (int)rc;
    if (fn == nullptr || found != cudaDriverEntryPointSuccess)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)cout, (cuuint64_t)width,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)cout * 2,
                                 (cuuint64_t)width * cout * 2};
  const cuuint32_t box[3] = {32, 8 * kGroup, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, out, dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

}  // namespace

// p bf16[n, height, width, 3] (the channels_last memory of an [N, 3, H, W]
// tensor), weight bf16[cout, 7, 7, 3] (channels_last [cout, 3, 7, 7]), bias
// bf16[cout], out bf16[n, height, width, cout] (channels_last [N, cout, H,
// W]). cout a multiple of 8, at most 9 x 2048, p under 2^31 elements; all on
// the device, 16-byte aligned. Launches one kernel on `stream`; returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take.
extern "C" int sac_attention(const void* p, const void* weight,
                             const void* bias, void* out, int n, int height,
                             int width, int cout, cudaStream_t stream) {
  if (p == nullptr || weight == nullptr || bias == nullptr ||
      out == nullptr || n <= 0 || height <= 0 || width <= 0 || cout <= 0 ||
      cout % 8 != 0 || cout > kMaxChannels || !aligned16(p) ||
      !aligned16(weight) || !aligned16(bias) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const int tiles_per_row = (width + kTile - 1) / kTile;
  const long long tiles = (long long)n * height * tiles_per_row;
  const long long elems = (long long)n * height * width * 3;
  if (elems > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int blocks_per_sm = 0, sms = 0;
  int rc = residency(&blocks_per_sm, &sms);
  if (rc != (int)cudaSuccess) return rc;
  CUtensorMap map;
  rc = output_map(&map, out, n * height, width, cout);
  if (rc != (int)cudaSuccess) return rc;
  const int slices = (cout + kSlice - 1) / kSlice;
  // the blocks the card holds at once, split over the slices
  long long per_slice = (long long)blocks_per_sm * sms / slices;
  if (per_slice > tiles) per_slice = tiles;
  if (per_slice < 1) per_slice = 1;
  attention7x7_kernel<<<dim3((unsigned)per_slice, (unsigned)slices),
                        kThreads, 0, stream>>>(
      map, static_cast<const uint16_t*>(p),
      static_cast<const uint16_t*>(weight),
      static_cast<const uint16_t*>(bias), (int)elems, height, width, cout,
      tiles_per_row, (int)tiles);
  return (int)cudaGetLastError();
}
