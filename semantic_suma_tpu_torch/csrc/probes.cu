// Two measuring probes for the card, used by chip_smoke.py to state the
// bounds of the kernels beside them; no module of the package calls them.
//
//  * empty_launch: a kernel that does nothing. Its time in a replayed CUDA
//    graph is the floor under every kernel's time.
//  * atomic_probe: n 64-bit atomicMin operations, each on its own cell,
//    neighbouring threads on neighbouring cells: the best case for the L2
//    atomic unit, so n over its time is the rate a z-buffer's unavoidable
//    atomics are held against.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

__global__ void atomic_kernel(long long* cells, long long n, long long key) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n) atomicMin(cells + j, key + j);
}

}  // namespace

extern "C" int empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}

// cells i64[n] on the device; every cell is offered `key + its index`.
extern "C" int atomic_probe(long long* cells, long long n, long long key,
                            cudaStream_t stream) {
  atomic_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(cells, n, key);
  return (int)cudaGetLastError();
}
