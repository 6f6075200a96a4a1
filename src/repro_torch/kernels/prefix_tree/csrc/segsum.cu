// One level of a packed radix tree: out[g] = sum of values[g*radix .. g*radix + radix - 1].
//
// Replaces the Pallas TPU kernel src/repro/kernels/prefix_tree/kernel.py
// (segsum_kernel, launched by block_segment_sums).  That kernel pads the
// child level on the host to whole (block_rows, radix) tiles; here the ragged
// last group is zero-padded inside the kernel: a child index at or past n
// reads as 0.
//
// One warp per output node: lane l sums children l, l + 32, ... in order,
// then the warp reduces by shuffles in a fixed pattern, so the result is the
// same on every run (and exact for integer-valued inputs below 2^24).
// Bound on an H100 (3.35 TB/s): bytes, 4 B per child read and 4 B per node
// written: 4.06 MB, 1.2 us, at 1e6 children -> 15 625 nodes (radix 64).
// Adjacent lanes read adjacent children, so each warp's loads are coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
segsum_kernel(const float* __restrict__ values, long long n, int radix,
              float* __restrict__ out, long long out_size) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); g < out_size;
       g += stride) {
    const long long base = g * radix;
    float s = 0.0f;
    for (int j = lane; j < radix; j += 32) {
      const long long i = base + j;
      s += i < n ? values[i] : 0.0f;
    }
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) out[g] = s;
  }
}

}  // namespace

extern "C" int repro_segsum(const void* values, long long n, int radix, void* out,
                            long long out_size, void* stream) {
  if (out_size > 0) {
    long long blocks = (out_size + kWarps - 1) / kWarps;
    if (blocks > 65535) blocks = 65535;
    segsum_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(values), n, radix, static_cast<float*>(out), out_size);
  }
  return (int)cudaGetLastError();
}
