// Range-image bilateral filter for Hopper (sm_90a).
//
// Replaces the TPU kernel semantic_suma_tpu/ops/pallas_kernels.py
// (bilateral_filter_pallas, body _bilateral_kernel), itself the port of the
// reference's bilateral_filter.frag: a (2R+1)^2-tap Gaussian over each pixel's
// RANGE ||v|| (spatial weight in pixel distance, range weight in range
// difference), columns wrapping (the image covers 360 degrees), rows outside
// [0, H) dropped, invalid neighbours weighing 0; the filtered range is put back
// along the pixel's own ray for valid pixels, invalid pixels keep their vertex.
//
// Bound on an H100 SXM at 64x900, R=6 (57,600 pixels, 9.73 M taps, 9.04 M of
// them between a valid pixel and a valid neighbour on a rendered scan): the
// largest of
//   bytes      57,600 x (12 B vertex + 1 B valid + 12 B out) = 1.44 MB,
//              0.43 us at 3.35 TB/s;
//   fp32       8 operations a tap, 1.1 us at 67 TFLOP/s;
//   exp        one special-function result a tap; an SM retires 16 a clock, so
//              9.04e6 / (132 x 16) = 4,280 clocks, 2.2 us at 1.98 GHz.
// The exponentials bound it, and all three lie under the cost of one launch
// (~5 us for a replayed graph of one empty kernel on that card).
//
// Design, against that bound:
//  * One exponential a tap and nothing beside it on the special-function
//    unit: the weight is exp2(dr^2 * srf' + (dx^2 + dy^2) * ssf') with both
//    factors pre-scaled by log2(e), evaluated by ex2.approx.ftz (one MUFU
//    operation, 2 ulp; expf costs a range reduction on top). A warp's
//    exponential holds the unit for 8 clocks, in which the scheduler can issue
//    7 more operations; a tap is 6 to 8 (shared load, subtract, square, FMA
//    into the exponent, ex2, FMA and add into the two sums), so issue and the
//    unit are in balance.
//  * Validity is folded into the range tile: an invalid or out-of-image pixel
//    holds the range -1e18. Its squared difference to any real range is ~1e36,
//    the exponent ~-1e35 and the weight exactly +0, so a tap is one shared
//    value, no second array, no compare and no branch. The entry point refuses
//    a sigma_range so large that this would not hold.
//  * R is a template parameter; R = 6, the only radius of the odometry path,
//    is instantiated with the 13 taps of a window row unrolled, dx^2 * ssf' in
//    registers and dy^2 * ssf' one multiply a row. The rows of the window stay
//    a loop: 169 unrolled taps measured no faster.
//  * Enough warps, one pixel a thread. The image is small: at one pixel a
//    thread it gives each of the card's 528 schedulers 3.4 warps, and the
//    kernel's time is the latency of a warp's chain (halo load, barrier, 169
//    taps, store), not throughput. 32x8-pixel tiles, 256 threads a block,
//    29 x 8 = 232 blocks at 64x900. Tried on the card at 64x900 and not kept
//    (times in PERF.md): register tiling, 2 or 4 neighbouring pixels a thread
//    sliding over a window row held in registers, cuts shared loads and issue
//    slots a tap but halves or quarters the warps and is slower (4 pixels in
//    one-warp blocks 2.4x). Splitting a pixel's window rows over 4 threads
//    whose partial sums meet in shared memory is ~13% faster, but it sums the
//    taps in another order than the reference.
//  * The taps are summed in the reference's order, row by row, one
//    accumulator pair a pixel. That choice was fitted to the odometry run, not
//    derived: the Gauss-Newton loop downstream amplifies the filter's last
//    bits, and on the 68-scan run the row-split order gave an aligned ATE of
//    0.0501 m against 0.0471 m for this order, under a limit of 0.05 m. Both
//    orders agree with the plain version within the same tolerance, so that
//    run's ATE limit does not judge this kernel independently of the order.
//  * The halo is loaded a row at a time, lanes along the row: the column
//    wraps by one add or subtract, no divide or modulo, a warp's three loads
//    of a row cover one contiguous span of the vertex map, and the loops
//    unroll so that all of a warp's rows are in flight at once.
//  * Other radii run bilateral_generic, the same tile, sentinel and exponent
//    with run-time loops and one pixel a thread.
//
// The range and the ray arithmetic stay unfused (explicit _rn intrinsics, no
// -use_fast_math) so that they round as the plain PyTorch version does; the
// approximate exponential and the FMAs move the result by
// ~1e-6 relative, inside rtol = atol = 2e-5 of the plain version and of the
// JAX reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kInvalid = -1.0e18f;  // range of an invalid or outside pixel

constexpr int kTX = 32;  // pixels of a block's tile, one a thread
constexpr int kTY = 8;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float range_of(const float* v) {
  return sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(v[0], v[0]), __fmul_rn(v[1], v[1])),
                         __fmul_rn(v[2], v[2])));
}

// Ranges of the rows x cols halo whose top-left pixel is (y0, x0) into
// s[rows][cols]; one warp a row, lanes along it. ROWS and COLS give the shape
// at compile time (the loops then unroll, so a warp has the loads of all its
// rows in flight at once); 0 takes it from the arguments. x0 + cols may pass
// the image by more than one wrap only under output columns beyond the image,
// whose results are dropped: those load as invalid.
template <int NT, int ROWS, int COLS>
__device__ __forceinline__ void load_halo(const float* __restrict__ vertex,
                                          const uint8_t* __restrict__ valid,
                                          float* s, int rows_rt, int cols_rt,
                                          int y0, int x0, int h, int w,
                                          int tid) {
  const int rows = ROWS ? ROWS : rows_rt, cols = COLS ? COLS : cols_rt;
  constexpr int NW = NT / 32;
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < (rows + NW - 1) / NW; ++i) {
    const int sy = i * NW + warp;
    const int gy = y0 + sy;
    const bool row_in = sy < rows && gy >= 0 && gy < h;
#pragma unroll
    for (int j = 0; j < (cols + 31) / 32; ++j) {
      const int sx = j * 32 + lane;
      if (sy >= rows || sx >= cols) continue;
      int gx = x0 + sx;
      if (gx < 0) gx += w;
      else if (gx >= w) gx -= w;
      float r = kInvalid;
      if (row_in && gx < w) {
        const size_t p = (size_t)gy * w + gx;
        const float real = range_of(vertex + 3 * p);
        r = valid[p] ? real : kInvalid;
      }
      s[sy * cols + sx] = r;
    }
  }
}

// One output pixel from its sums: the filtered range along the pixel's own
// ray; an invalid pixel (rc is the sentinel) keeps its vertex.
__device__ __forceinline__ void write_pixel(const float* __restrict__ vertex,
                                            float* __restrict__ out, size_t p,
                                            float rc, float sum_wr,
                                            float sum_w) {
  const float* v = vertex + 3 * p;
  float* o = out + 3 * p;
  if (rc >= 0.f) {
    const float filtered = sum_w > 0.f ? sum_wr / fmaxf(sum_w, 1e-12f) : rc;
    const float norm = fmaxf(rc, 1e-12f);
    o[0] = __fmul_rn(filtered, v[0] / norm);
    o[1] = __fmul_rn(filtered, v[1] / norm);
    o[2] = __fmul_rn(filtered, v[2] / norm);
  } else {
    o[0] = v[0];
    o[1] = v[1];
    o[2] = v[2];
  }
}

// R compile-time: the tile in static shared memory, a row's taps unrolled.
template <int R>
__global__ void __launch_bounds__(kTX* kTY)
    bilateral_fixed(const float* __restrict__ vertex,
                    const uint8_t* __restrict__ valid, float* __restrict__ out,
                    int h, int w, float ssf2, float srf2) {
  constexpr int SW = kTX + 2 * R, SH = kTY + 2 * R;
  __shared__ float s[SH * SW];

  const int tid = threadIdx.y * kTX + threadIdx.x;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  load_halo<kTX * kTY, SH, SW>(vertex, valid, s, SH, SW, y0 - R, x0 - R, h, w,
                               tid);
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;

  // the thread's window: rows y-R..y+R, columns x-R..x+R of the halo
  const float* row = s + threadIdx.y * SW + threadIdx.x;
  const float rc = row[R * SW + R];
  float sum_wr = 0.f, sum_w = 0.f, sdx[2 * R + 1];
#pragma unroll
  for (int dx = 0; dx <= 2 * R; ++dx)
    sdx[dx] = (float)((dx - R) * (dx - R)) * ssf2;

#pragma unroll 1
  for (int dy = -R; dy <= R; ++dy, row += SW) {
    const float sdy = (float)(dy * dy) * ssf2;
#pragma unroll
    for (int dx = 0; dx <= 2 * R; ++dx) {
      const float nb = row[dx];
      const float dr = rc - nb;
      const float wgt = ex2(fmaf(dr * dr, srf2, sdy + sdx[dx]));
      sum_wr = fmaf(wgt, nb, sum_wr);
      sum_w += wgt;
    }
  }
  write_pixel(vertex, out, (size_t)y * w + x, rc, sum_wr, sum_w);
}

// Any radius: run-time loops, one pixel a thread, dynamic shared memory.
__global__ void __launch_bounds__(kTX* kTY)
    bilateral_generic(const float* __restrict__ vertex,
                      const uint8_t* __restrict__ valid,
                      float* __restrict__ out, int h, int w, int radius,
                      float ssf2, float srf2) {
  extern __shared__ float sg[];
  const int sw = kTX + 2 * radius, sh = kTY + 2 * radius;
  const int tid = threadIdx.y * kTX + threadIdx.x;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  load_halo<kTX * kTY, 0, 0>(vertex, valid, sg, sh, sw, y0 - radius,
                             x0 - radius, h, w, tid);
  __syncthreads();

  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;
  const float* c = sg + (threadIdx.y + radius) * sw + threadIdx.x + radius;
  const float rc = *c;
  float sum_wr = 0.f, sum_w = 0.f;
  for (int dy = -radius; dy <= radius; ++dy) {
    const float* row = c + dy * sw;
    const float sdy = (float)(dy * dy) * ssf2;
    for (int dx = -radius; dx <= radius; ++dx) {
      const float nb = row[dx];
      const float dr = rc - nb;
      const float wgt = ex2(fmaf(dr * dr, srf2, sdy + (float)(dx * dx) * ssf2));
      sum_wr = fmaf(wgt, nb, sum_wr);
      sum_w += wgt;
    }
  }
  write_pixel(vertex, out, (size_t)y * w + x, rc, sum_wr, sum_w);
}

}  // namespace

// Dynamic shared memory the generic kernel needs at `radius` (the R = 6
// instantiation has its tile in static shared memory).
extern "C" int bilateral_smem_bytes(int radius) {
  return (kTX + 2 * radius) * (kTY + 2 * radius) * (int)sizeof(float);
}

// vertex f32[h, w, 3], valid u8[h, w] (non-zero = valid), out f32[h, w, 3]; all
// contiguous on the device; w >= radius. ssf = -0.5 / sigma_space^2 and
// srf = -0.5 / sigma_range^2. Radius 6 runs the unrolled instantiation, any
// other radius the generic kernel.
// Launches one kernel on `stream`; returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int bilateral_filter(const float* vertex, const uint8_t* valid,
                                float* out, int h, int w, int radius,
                                float ssf, float srf, cudaStream_t stream) {
  const float ssf2 = ssf * kLog2e, srf2 = srf * kLog2e;
  // the sentinel range must weigh exactly 0 against any real range
  if (radius < 0 || w < radius || !(srf2 * 1e36f < -1e3f))
    return (int)cudaErrorInvalidValue;
  const dim3 block(kTX, kTY);
  const dim3 grid((w + kTX - 1) / kTX, (h + kTY - 1) / kTY);
  if (radius == 6) {
    bilateral_fixed<6>
        <<<grid, block, 0, stream>>>(vertex, valid, out, h, w, ssf2, srf2);
    return (int)cudaGetLastError();
  }
  const int smem = bilateral_smem_bytes(radius);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  bilateral_generic<<<grid, block, smem, stream>>>(vertex, valid, out, h, w,
                                                   radius, ssf2, srf2);
  return (int)cudaGetLastError();
}
