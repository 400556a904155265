// Kernel F's designs and parts, for tools/gn_loop_designs.py: the kernel of
// csrc/icp.cu with switches (MODE bits), built from the same device code.
//   1  slot-major partials [2, slots, 33] (F's first layout)
//   2  one load in flight a lane (F's first reduction loop)
//   4  block 0 alone sums and solves, a second barrier, the other blocks
//      read the state (the design that needs no redundant reduction)
// and, for timing only (the results are not the loop's):
//   8  no reduction (the sums stay 0)
//   16 no solve (k counts up, the pose stays)
//   32 no slot work
#include "../csrc/icp.cu"

namespace {

// E's order as sum_partials, one load in flight a lane
__device__ __forceinline__ void sum_one_load(const float* partials,
                                             int nslots, int sb, int sc,
                                             double* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < NPART; c += WARPS) {
    double s = 0.0;
    for (int b = lane; b < nslots; b += 32)
      s += (double)__ldcg(partials + b * sb + c * sc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) sums[c] = s;
  }
  __syncthreads();
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
design_kernel(const DParams q, int nslots, int max_iter, float* state_f,
              int* state_i, float delta_thr, float stop_thr, float* shared) {
  __shared__ float sf[SF];
  __shared__ int si[SI];
  __shared__ float warp_sums[WARPS][NPART];
  __shared__ double sums[NPART];
  cg::grid_group grid = cg::this_grid();
  const int sb = (MODE & 1) ? NPART : 1, sc = (MODE & 1) ? 1 : nslots;
  if (threadIdx.x < SF) sf[threadIdx.x] = state_f[threadIdx.x];
  if (threadIdx.x < SI) si[threadIdx.x] = state_i[threadIdx.x];
  if (threadIdx.x < NPART) sums[threadIdx.x] = 0.0;
  __syncthreads();
  for (int t = 0; t < max_iter && !si[SI_DONE]; ++t) {
    float* half = q.partials + (size_t)(t & 1) * nslots * NPART;
    const int k = si[SI_K];
    if (!(MODE & 32)) {
      for (int s = blockIdx.x; s < nslots; s += gridDim.x) {
        slot_sums(q, s, nslots, sf, k, warp_sums, half + s * sb, sc);
        __syncthreads();
      }
    }
    grid.sync();
    if (!(MODE & 4) || blockIdx.x == 0) {
      if (MODE & 8) {
      } else if (MODE & 2) {
        sum_one_load(half, nslots, sb, sc, sums);
      } else {
        sum_partials(half, nslots, sb, sc, sums);
      }
      if (threadIdx.x == 0) {
        if (MODE & 16) si[SI_K] += 1;
        else gn_step(sums, sf, si, delta_thr, stop_thr);
      }
      __syncthreads();
    }
    if (MODE & 4) {
      int* shared_i = reinterpret_cast<int*>(shared + SF);
      if (blockIdx.x == 0) {
        if (threadIdx.x < SF) shared[threadIdx.x] = sf[threadIdx.x];
        if (threadIdx.x < SI) shared_i[threadIdx.x] = si[threadIdx.x];
      }
      grid.sync();
      if (blockIdx.x != 0) {
        if (threadIdx.x < SF) sf[threadIdx.x] = __ldcg(shared + threadIdx.x);
        if (threadIdx.x < SI) si[threadIdx.x] = __ldcg(shared_i + threadIdx.x);
      }
      __syncthreads();
    }
  }
  if (blockIdx.x == 0) {
    if (threadIdx.x < SF) state_f[threadIdx.x] = sf[threadIdx.x];
    if (threadIdx.x < SI) state_i[threadIdx.x] = si[threadIdx.x];
  }
}

template <int MODE>
int launch(DParams q, int nslots, int max_iter, float* sf, int* si,
           float delta_thr, float stop_thr, float* shared, int grid,
           cudaStream_t stream) {
  void* args[] = {&q, &nslots, &max_iter, &sf, &si, &delta_thr, &stop_thr,
                  &shared};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(design_kernel<MODE>), dim3(grid),
      dim3(THREADS), args, 0, stream);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(rc != cudaSuccess ? rc : last);
}

}  // namespace

// gn_loop's arguments after `mode`, then 28 floats of scratch for the
// state that mode 4 passes between blocks; -1 for a mode not built
extern "C" int gn_loop_design(
    int mode, const void* vertex, const void* normal, const void* vvalid,
    const void* nvalid, const void* label, const void* prob,
    const void* model, void* state_f, void* state_i, void* partials, int p,
    int mh, int mw, int nslots, int weighting, int bilinear, int semantic,
    unsigned long long movable, float fov_up, float inv_fov, float deg,
    float inv_pi, float max_dist, float angle_thr, float factor,
    float inv_factor, int grid, int max_iter, float delta_thr,
    float stop_thr, void* shared, void* stream) {
  const DParams q = make_params(
      vertex, normal, vvalid, nvalid, label, prob, model, nullptr, nullptr,
      partials, p, mh, mw, weighting, bilinear, semantic, movable, fov_up,
      inv_fov, deg, inv_pi, max_dist, angle_thr, factor, inv_factor);
  float* sf = static_cast<float*>(state_f);
  int* si = static_cast<int*>(state_i);
  float* sh = static_cast<float*>(shared);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
#define MODE_CASE(m)                                                     \
  case m:                                                                \
    return launch<m>(q, nslots, max_iter, sf, si, delta_thr, stop_thr, sh, \
                     grid, s);
    MODE_CASE(0) MODE_CASE(3) MODE_CASE(4) MODE_CASE(16) MODE_CASE(24)
    MODE_CASE(56)
#undef MODE_CASE
  }
  return -1;
}
