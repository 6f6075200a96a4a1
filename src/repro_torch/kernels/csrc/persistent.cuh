// Building blocks of the persistent kernels, shared by
// capped_simplex/csrc/mass.cu (the warm projection),
// prefix_tree/csrc/bucket_mass.cu (the bucket threshold solve) and
// scatter_counts/csrc/histogram.cu (the id-slices histogram).
//
// A persistent kernel is one launch whose blocks all stay resident for the
// whole call: each step of a solve reduces over every block, then every
// block reads the same partials, so a barrier across the grid separates the
// steps.  The launch is cooperative, so the runtime refuses it (and the C
// entry point returns the error) unless every block fits on the card at once.
//
// The barrier is cooperative_groups' grid sync (CUDA >= 11 needs no -rdc).
// A hand-written arrive counter (one red.add a block and an acquire spin)
// measured no faster on an H100 (PERF.md), so it is not kept.
// A block reads other blocks' partials only after the barrier and through
// ld.global.cg (__ldcg), which skips the SM's L1: a line of the partials
// buffer that an earlier step brought into L1 is never read stale.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace persistent {

// Butterfly sums: every lane ends with the same value, bit for bit (each
// step adds the same two operands in every lane of a pair).
__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Every block of the grid reaches this point before any goes on.
__device__ __forceinline__ void grid_barrier() { cooperative_groups::this_grid().sync(); }

// Launch `kernel` with all `blocks` resident, each with `smem` bytes of
// dynamic shared memory; returns the launch's error.
inline int launch(const void* kernel, int blocks, int threads, void** args, cudaStream_t s,
                  size_t smem = 0) {
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)blocks),
                                                    dim3((unsigned)threads), args, smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace persistent
