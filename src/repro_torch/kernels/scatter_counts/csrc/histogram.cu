// Dense float32 histogram of request ids over [0, n): the OGB gradient step.
//
// Replaces the Pallas TPU kernel src/repro/kernels/scatter_counts/kernel.py
// (histogram_kernel, launched by _grid_histogram through ops.scatter_counts).
// The TPU has no fast scatter, so that kernel compares every id against every
// catalog slot of a block (O(B * N) work).  Hopper has fast atomics in L2, so
// this is a scatter: one thread per id, atomicAdd(1.0f) into its slot.
//
// Bound on an H100 (3.35 TB/s): bytes.  The dense output is rewritten every
// chunk, so the call moves 4 B per catalog slot (the zero fill) plus 4 B per
// id: 4.004 MB, 1.2 us, at n = 1e6 and B = 1000.  The fill is a grid-stride
// store of zeros; the scatter is B threads.  Counts are integers below 2^24,
// so float adds are exact and the result does not depend on their order.
// Ids outside [0, n) are skipped, as the TPU kernel never matches them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void fill_zero_kernel(float* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    out[i] = 0.0f;
  }
}

__global__ void scatter_kernel(const int* __restrict__ ids, long long b,
                               float* __restrict__ counts, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const long long id = ids[i];
  if (id >= 0 && id < n) atomicAdd(counts + id, 1.0f);
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

extern "C" int repro_histogram(const void* ids, long long b, void* counts, long long n,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(counts);
  if (n > 0) {
    const long long blocks = cdiv(n, kThreads) < 4096 ? cdiv(n, kThreads) : 4096;
    fill_zero_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(out, n);
  }
  if (b > 0) {
    scatter_kernel<<<(unsigned)cdiv(b, kThreads), kThreads, 0, s>>>(
        static_cast<const int*>(ids), b, out, n);
  }
  return (int)cudaGetLastError();
}
