// Dense float32 histogram of request ids over [0, n): the OGB gradient step.
//
// Replaces the Pallas TPU kernel src/repro/kernels/scatter_counts/kernel.py
// (histogram_kernel, launched by _grid_histogram through ops.scatter_counts).
// The TPU has no fast scatter, so that kernel compares every id against every
// catalog slot of a block (O(B * N) work).  Hopper has fast atomics in
// shared memory, so this counts each id once, into a block's private counters.
//
// Bound on an H100 (3.35 TB/s): bytes.  The dense output is written once and
// each id read once: 4B + 4n bytes, 1.195 us at the chunk's B = 1000,
// n = 1e6 and 4.26 MB (1.27 us) at a re-anchor's B = 1e6, n = 65 536.
//
// One launch in each of two plans (scatter_counts/ops.py::design picks one by
// the shapes alone):
//   * bin tiles (B small against n: the chunk's gradient).  A block owns a
//     tile of kTileBins bins in shared memory and zeroes it, reads all B ids
//     (from L2: 4 KB at the chunk's shape) and counts those in its tile with
//     shared-memory atomics, then writes the tile out once with 16-byte
//     stores.  No zero pass over device memory and no global atomic; tiles
//     loop with a grid stride when n exceeds the grid.
//   * id slices (B large against n: a re-anchor's bucket ids, most of them
//     in one bucket).  One persistent cooperative launch
//     (../../csrc/persistent.cuh).  Each block zeroes its share of the
//     output and counts a contiguous slice of the ids into a private
//     histogram of kSliceBins bins in shared memory: 16-bit counters, two to
//     a 32-bit word (128 KB), which hold a count only while a block's slice
//     has fewer than 65 536 ids, so a slice is counted kPieceIds ids at a
//     time.  After one grid barrier (every zero stored) each block adds its
//     non-zero bins to the output, one global atomic a non-zero bin.  Past
//     kSliceBins bins the ids are counted a window of kSliceBins at a time.
// In both plans each thread loads kIdsInFlight ids before it counts any (a
// block's loads overlap, not one round trip an id), and a warp adds equal
// ids once: __match_any_sync groups the lanes holding the same bin and the
// group's first lane adds __popc of the group, so the skewed re-anchor ids
// cost one shared atomic a warp, not 32.
// Counts are integers below 2^24, so the float adds are exact and the result
// equals the plain version's whatever their order.  Ids outside [0, n) are
// skipped, as the TPU kernel never matches them.
//
// A fleet's rows: R rows of B ids each (a tenant's chunk) give R rows of n
// counts in one bin-tiles launch, the grid's y axis the row.  Block (x, r)
// reads row r's ids and writes row r's counts with the same code as a
// one-row call, so each row equals its own call.

#include <cstdint>

#include <cuda_runtime.h>

#include "../../csrc/persistent.cuh"

namespace {

constexpr int kTileThreads = 512;
constexpr int kTileBins = 8192;  // 32 KB of 32-bit counters a block
constexpr int kIdsInFlight = 8;  // ids a thread loads before counting them
constexpr int kSliceThreads = 1024;
constexpr int kSliceBins = 65536;  // a window: 32 768 words of two 16-bit counters
constexpr int kPieceIds = 64512;   // 63 * 1024 ids: no 16-bit counter can overflow
constexpr int kSliceSmem = kSliceBins / 2 * 4;

// One add of the warp's lanes that hold `key` (a bin of the block's counters,
// or -1 for none); every lane of the warp calls it.
__device__ __forceinline__ unsigned leader_count(int key, bool& leads) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  leads = key >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1;
  return (unsigned)__popc(peers);
}

// The bin of `id` in [w0, w0 + bins), or -1.
__device__ __forceinline__ int bin_of(long long id, long long w0, int bins) {
  const long long local = id - w0;
  return local >= 0 && local < bins ? (int)local : -1;
}

__global__ void __launch_bounds__(kTileThreads)
bin_tiles_kernel(const int* __restrict__ ids, long long b, float* __restrict__ out, long long n) {
  __shared__ __align__(16) unsigned cnt[kTileBins];
  ids += (long long)blockIdx.y * b;  // this block's row (0 for one row)
  out += (long long)blockIdx.y * n;
  // a row's counts start 16-byte aligned where n is a multiple of 4
  const bool vec = (reinterpret_cast<std::uintptr_t>(out) & 15) == 0;
  uint4* cnt4 = reinterpret_cast<uint4*>(cnt);
  const long long tiles = (n + kTileBins - 1) / kTileBins;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long t0 = tile * kTileBins;
    const int bins = (int)min((long long)kTileBins, n - t0);
    for (int i = threadIdx.x; i < kTileBins / 4; i += kTileThreads) {
      cnt4[i] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
    for (long long base = 0; base < b; base += (long long)kTileThreads * kIdsInFlight) {
      int key[kIdsInFlight];
#pragma unroll
      for (int u = 0; u < kIdsInFlight; ++u) {
        const long long i = base + u * kTileThreads + threadIdx.x;
        key[u] = i < b ? bin_of(__ldg(ids + i), t0, bins) : -1;
      }
#pragma unroll
      for (int u = 0; u < kIdsInFlight; ++u) {
        bool leads;
        const unsigned add = leader_count(key[u], leads);
        if (leads) atomicAdd(cnt + key[u], add);
      }
    }
    __syncthreads();
    // t0 is a multiple of kTileBins, so out + t0 is as aligned as out
    float* o = out + t0;
    const int body = vec ? bins / 4 : 0;
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int i = threadIdx.x; i < body; i += kTileThreads) {
      const uint4 v = cnt4[i];
      o4[i] = make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
    }
    for (int i = body * 4 + threadIdx.x; i < bins; i += kTileThreads) o[i] = (float)cnt[i];
    __syncthreads();  // the tile is read out before the next one is zeroed
  }
}

__global__ void __launch_bounds__(kSliceThreads, 1)
id_slices_kernel(const int* __restrict__ ids, long long b, float* __restrict__ out, long long n) {
  extern __shared__ unsigned pairs[];  // bin 2w in the low half of word w, 2w + 1 in the high
  const long long blocks = gridDim.x;
  const long long first = (long long)blockIdx.x * kSliceThreads + threadIdx.x;
  const long long stride = blocks * kSliceThreads;
  float4* out4 = reinterpret_cast<float4*>(out);
  for (long long i = first; i < n / 4; i += stride) out4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long i = n / 4 * 4 + first; i < n; i += stride) out[i] = 0.0f;

  const long long lo = b * blockIdx.x / blocks, hi = b * (blockIdx.x + 1) / blocks;
  bool zeroed = false;  // past the grid barrier: every block's zeros are stored
  for (long long p0 = lo; p0 < hi; p0 += kPieceIds) {
    const long long p1 = min(hi, p0 + kPieceIds);
    for (long long w0 = 0; w0 < n; w0 += kSliceBins) {
      const int bins = (int)min((long long)kSliceBins, n - w0);
      const int words = (bins + 1) / 2;
      for (int i = threadIdx.x; i < words; i += kSliceThreads) pairs[i] = 0u;
      __syncthreads();
      for (long long base = p0; base < p1; base += (long long)kSliceThreads * kIdsInFlight) {
        int key[kIdsInFlight];
#pragma unroll
        for (int u = 0; u < kIdsInFlight; ++u) {
          const long long i = base + u * kSliceThreads + threadIdx.x;
          key[u] = i < p1 ? bin_of(__ldg(ids + i), w0, bins) : -1;
        }
#pragma unroll
        for (int u = 0; u < kIdsInFlight; ++u) {
          bool leads;
          const unsigned add = leader_count(key[u], leads);
          if (leads) atomicAdd(pairs + (key[u] >> 1), add << ((key[u] & 1) * 16));
        }
      }
      __syncthreads();
      if (!zeroed) {
        persistent::grid_barrier();
        zeroed = true;
      }
      float* o = out + w0;
      for (int i = threadIdx.x; i < words; i += kSliceThreads) {
        const unsigned v = pairs[i];
        if (v & 0xffffu) atomicAdd(o + 2 * i, (float)(v & 0xffffu));
        if (v >> 16) atomicAdd(o + 2 * i + 1, (float)(v >> 16));
      }
      __syncthreads();  // the window is read out before it is zeroed again
    }
  }
  if (!zeroed) persistent::grid_barrier();  // a block with no ids still meets it
}

int allow_slice_smem() {
  return (int)cudaFuncSetAttribute(id_slices_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kSliceSmem);
}

}  // namespace

// Blocks of the id-slices kernel that one SM holds at once (`variant` unused).
extern "C" int repro_histogram_slices_occupancy(int variant, int* blocks_per_sm) {
  (void)variant;
  const int e = allow_slice_smem();
  if (e != 0) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, id_slices_kernel,
                                                            kSliceThreads, kSliceSmem);
}

// counts (rows * n floats, 16-byte aligned) is written whole; slices: the
// id-slices plan on `blocks` resident blocks (one row), else bin tiles on
// `blocks` blocks a row, row r's b ids at ids + r * b and its n counts at
// counts + r * n.
extern "C" int repro_histogram(const void* ids, long long b, void* counts, long long n, int rows,
                               int slices, int blocks, void* stream) {
  if (n < 1 || b < 0 || blocks < 1 || rows < 1 || rows > 65535 || (slices && rows != 1) ||
      (reinterpret_cast<std::uintptr_t>(counts) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slices) {
    const int e = allow_slice_smem();
    if (e != 0) return e;
    void* args[] = {&ids, &b, &counts, &n};
    return persistent::launch((const void*)id_slices_kernel, blocks, kSliceThreads, args, s,
                              kSliceSmem);
  }
  bin_tiles_kernel<<<dim3((unsigned)blocks, (unsigned)rows), kTileThreads, 0, s>>>(
      static_cast<const int*>(ids), b, static_cast<float*>(counts), n);
  return (int)cudaGetLastError();
}
