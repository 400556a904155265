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
// Design. The TPU kernel kept the whole image in VMEM and rolled it 169 times.
// Here each block owns one TILE_Y x TILE_X output tile: it loads the
// (TILE_Y+2R) x (TILE_X+2R) halo of range and validity into shared memory once
// (computing ||v|| on the load, columns wrapped mod W, rows outside the image
// loaded as invalid), then every thread runs the 169 taps out of shared memory
// and writes its three output floats. One read of the vertex map, one write.
//
// Bound on an H100 SXM at 64x900, R=6: bytes = 57,600 px x (12 B vertex + 1 B
// valid + 12 B out) = 1.44 MB, 0.43 us at 3.35 TB/s; operations = 57,600 x 169
// taps x ~8 fp32 ops (exp counted as one) = 78 MFLOP, 1.2 us at 67 TFLOP/s.
// Either is far below the launch latency (a few us), so at this size the
// kernel is launch-bound; the tile shape only has to give enough blocks
// (29 x 4 = 116) to spread over the SMs.
//
// expf (not __expf) and unfused range / ray arithmetic keep the result within
// rtol = atol = 2e-5 of the plain PyTorch version and the JAX reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_X = 32;
constexpr int TILE_Y = 16;

__device__ __forceinline__ float range_of(const float* v) {
  return sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(v[0], v[0]), __fmul_rn(v[1], v[1])),
                         __fmul_rn(v[2], v[2])));
}

__global__ void bilateral_kernel(const float* __restrict__ vertex,
                                 const uint8_t* __restrict__ valid,
                                 float* __restrict__ out, int h, int w,
                                 int radius, float ssf, float srf) {
  extern __shared__ float smem[];
  const int sw = TILE_X + 2 * radius;
  const int sh = TILE_Y + 2 * radius;
  float* s_rng = smem;
  float* s_ok = smem + sw * sh;

  const int x0 = blockIdx.x * TILE_X - radius;
  const int y0 = blockIdx.y * TILE_Y - radius;
  const int tid = threadIdx.y * TILE_X + threadIdx.x;
  for (int i = tid; i < sw * sh; i += TILE_X * TILE_Y) {
    const int sy = i / sw;
    const int sx = i - sy * sw;
    const int gy = y0 + sy;
    int gx = (x0 + sx) % w;
    if (gx < 0) gx += w;
    float r = 0.f, ok = 0.f;
    if (gy >= 0 && gy < h) {
      const size_t p = (size_t)gy * w + gx;
      r = range_of(vertex + 3 * p);
      ok = valid[p] ? 1.f : 0.f;
    }
    s_rng[i] = r;
    s_ok[i] = ok;
  }
  __syncthreads();

  const int x = blockIdx.x * TILE_X + threadIdx.x;
  const int y = blockIdx.y * TILE_Y + threadIdx.y;
  if (x >= w || y >= h) return;

  const int c = (threadIdx.y + radius) * sw + threadIdx.x + radius;
  const float rc = s_rng[c];
  float sum_wr = 0.f, sum_w = 0.f;
  for (int dy = -radius; dy <= radius; ++dy) {
    const float* row_r = s_rng + c + dy * sw;
    const float* row_ok = s_ok + c + dy * sw;
    for (int dx = -radius; dx <= radius; ++dx) {
      if (row_ok[dx] > 0.5f) {
        const float nb = row_r[dx];
        const float dr = rc - nb;
        const float wgt = expf((float)(dx * dx + dy * dy) * ssf + dr * dr * srf);
        sum_wr += wgt * nb;
        sum_w += wgt;
      }
    }
  }

  const size_t p = (size_t)y * w + x;
  const float* v = vertex + 3 * p;
  float* o = out + 3 * p;
  if (valid[p]) {
    const float filtered = sum_w > 0.f ? sum_wr / fmaxf(sum_w, 1e-12f) : rc;
    const float norm = fmaxf(rc, 1e-12f);
    o[0] = filtered * (v[0] / norm);
    o[1] = filtered * (v[1] / norm);
    o[2] = filtered * (v[2] / norm);
  } else {
    o[0] = v[0];
    o[1] = v[1];
    o[2] = v[2];
  }
}

}  // namespace

extern "C" int bilateral_smem_bytes(int radius) {
  return 2 * (TILE_X + 2 * radius) * (TILE_Y + 2 * radius) * (int)sizeof(float);
}

// vertex f32[h, w, 3], valid u8[h, w], out f32[h, w, 3]; all contiguous on the
// device. Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int bilateral_filter(const float* vertex, const uint8_t* valid,
                                float* out, int h, int w, int radius,
                                float ssf, float srf, cudaStream_t stream) {
  const dim3 block(TILE_X, TILE_Y);
  const dim3 grid((w + TILE_X - 1) / TILE_X, (h + TILE_Y - 1) / TILE_Y);
  const int smem = bilateral_smem_bytes(radius);
  bilateral_kernel<<<grid, block, smem, stream>>>(vertex, valid, out, h, w,
                                                  radius, ssf, srf);
  return (int)cudaGetLastError();
}
