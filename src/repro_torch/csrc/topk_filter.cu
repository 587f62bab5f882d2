// Top-k message filter by histogram select (Algorithm 2, lines 7-9; Table I).
//
// Replaces the TPU kernel src/repro/kernels/topk_filter.py::topk_filter_pallas
// (bodies _histogram_kernel and _emit_kernel). The TPU runs its grid in order
// on one core and carries counts and the running band admission in scratch
// across grid steps; on Hopper the tiles run in parallel, so the carried
// state becomes explicit passes:
//
//   topk_histogram   counts[j] += #{ |x| >= edges[j] } over a 64-edge ladder.
//                    Each warp counts with ballots, each block sums into a
//                    shared histogram and adds it to the global one with
//                    atomics. Counts are integers, so the order of the atomics
//                    does not change the result.
//   topk_band_count  per tile of 1024 elements, the number of band elements
//                    t_lo <= |x| < t_hi.
//   topk_tile_scan   one block: exclusive scan of the per-tile band counts.
//   topk_emit        keep |x| >= t_hi outright, admit a band element when its
//                    index-order rank among band elements (tile offset + rank
//                    inside the tile) is below the quota; write sent,
//                    residual and mask.
//
// The ladder edges and [t_lo, t_hi, quota] are device tensors computed by
// the PyTorch glue between the passes; no value comes back to the host.
// Magnitudes are compared in float32 for float32 and bfloat16 input.
//
// What bounds it: device memory. The function reads dw and writes sent,
// residual and mask once; the passes read dw four times (twice for the
// histograms, once for the band count, once for the emit), from L2 at the
// main path's d = 47,236.
//
// C interface, launched on the caller's stream; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBuckets = 64;
constexpr int kTile = 1024;  // elements per block; also the emit block size
constexpr int kHistThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float magnitude(float x) { return fabsf(x); }
__device__ __forceinline__ float magnitude(__nv_bfloat16 x) {
  return fabsf(__bfloat162float(x));
}
template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

template <typename T>
__global__ void __launch_bounds__(kHistThreads)
topk_histogram(const T* __restrict__ x, int d, const float* __restrict__ edges,
               int* __restrict__ counts) {
  __shared__ float e[kBuckets];
  __shared__ int hist[kBuckets];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid < kBuckets) {
    e[tid] = edges[tid];
    hist[tid] = 0;
  }
  __syncthreads();
  // Lane l accumulates the counts of edges l and l + 32.
  unsigned lo = 0, hi = 0;
  const int base = blockIdx.x * kTile;
  for (int off = tid; off < kTile; off += kHistThreads) {
    const int i = base + off;
    const bool valid = i < d;
    const float m = valid ? magnitude(x[i]) : 0.f;
#pragma unroll
    for (int j = 0; j < kBuckets; ++j) {
      const unsigned ballot = __ballot_sync(kFull, valid && m >= e[j]);
      if (lane == (j & 31)) {
        if (j < 32) lo += __popc(ballot); else hi += __popc(ballot);
      }
    }
  }
  atomicAdd(&hist[lane], (int)lo);
  atomicAdd(&hist[lane + 32], (int)hi);
  __syncthreads();
  if (tid < kBuckets && hist[tid] != 0) atomicAdd(&counts[tid], hist[tid]);
}

template <typename T>
__global__ void __launch_bounds__(kTile)
topk_band_count(const T* __restrict__ x, int d, const float* __restrict__ thresh,
                int* __restrict__ tile_counts) {
  const int i = blockIdx.x * kTile + threadIdx.x;
  const float t_lo = thresh[0], t_hi = thresh[1];
  bool band = false;
  if (i < d) {
    const float m = magnitude(x[i]);
    band = m >= t_lo && m < t_hi;
  }
  const int count = __syncthreads_count(band);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = count;
}

// Exclusive prefix of `v` over the block in thread order; `total` gets the sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int s = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, s, o);
    if (lane >= o) s += t;
  }
  if (lane == 31) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    const int ws = warp_sums[lane];  // blockDim == 1024: 32 warps
    int t = ws;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t += u;
    }
    warp_sums[lane] = t - ws;  // exclusive over warps
    if (lane == 31) *total = t;
  }
  __syncthreads();
  const int excl = warp_sums[warp] + s - v;
  __syncthreads();  // warp_sums may be reused by the caller's next call
  return excl;
}

__global__ void __launch_bounds__(kTile)
topk_tile_scan(const int* __restrict__ tile_counts, int n_tiles,
               int* __restrict__ tile_offsets) {
  __shared__ int warp_sums[32];
  __shared__ int chunk_total;
  int carry = 0;
  for (int base = 0; base < n_tiles; base += kTile) {
    const int i = base + threadIdx.x;
    const int v = i < n_tiles ? tile_counts[i] : 0;
    const int excl = block_exclusive_scan(v, warp_sums, &chunk_total);
    if (i < n_tiles) tile_offsets[i] = carry + excl;
    carry += chunk_total;  // read after the scan's barriers
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kTile)
topk_emit(const T* __restrict__ x, int d, const float* __restrict__ thresh,
          const int* __restrict__ tile_offsets, T* __restrict__ sent,
          T* __restrict__ residual, uint8_t* __restrict__ mask) {
  __shared__ int warp_sums[32];
  __shared__ int tile_total;
  const int i = blockIdx.x * kTile + threadIdx.x;
  const float t_lo = thresh[0], t_hi = thresh[1];
  const int quota = (int)thresh[2];
  T xv = zero_of<T>();
  bool strong = false, band = false;
  if (i < d) {
    xv = x[i];
    const float m = magnitude(xv);
    strong = m >= t_hi;
    band = m >= t_lo && m < t_hi;
  }
  const int rank = tile_offsets[blockIdx.x] +
                   block_exclusive_scan(band ? 1 : 0, warp_sums, &tile_total);
  const bool keep = strong || (band && rank < quota);
  if (i < d) {
    sent[i] = keep ? xv : zero_of<T>();
    residual[i] = keep ? zero_of<T>() : xv;
    mask[i] = keep ? 1 : 0;
  }
}

template <typename T>
int histogram_impl(const void* x, int d, const void* edges, void* counts, void* stream) {
  const int n_tiles = (d + kTile - 1) / kTile;
  topk_histogram<T><<<n_tiles, kHistThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, d, (const float*)edges, (int*)counts);
  return (int)cudaGetLastError();
}

template <typename T>
int emit_impl(const void* x, int d, const void* thresh, void* tile_counts,
              void* tile_offsets, void* sent, void* residual, void* mask,
              void* stream) {
  const int n_tiles = (d + kTile - 1) / kTile;
  cudaStream_t s = (cudaStream_t)stream;
  topk_band_count<T><<<n_tiles, kTile, 0, s>>>((const T*)x, d, (const float*)thresh,
                                              (int*)tile_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_tile_scan<<<1, kTile, 0, s>>>((const int*)tile_counts, n_tiles, (int*)tile_offsets);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_emit<T><<<n_tiles, kTile, 0, s>>>((const T*)x, d, (const float*)thresh,
                                        (const int*)tile_offsets, (T*)sent,
                                        (T*)residual, (uint8_t*)mask);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int topk_filter_tile() { return kTile; }

// dtype: 0 = float32, 1 = bfloat16. counts (64 int32) must be zeroed.
int topk_filter_histogram(const void* x, int d, int dtype, const void* edges,
                          void* counts, void* stream) {
  return dtype == 0 ? histogram_impl<float>(x, d, edges, counts, stream)
                    : histogram_impl<__nv_bfloat16>(x, d, edges, counts, stream);
}

// thresh: [t_lo, t_hi, quota] float32; tile_counts, tile_offsets: n_tiles int32.
int topk_filter_emit(const void* x, int d, int dtype, const void* thresh,
                     void* tile_counts, void* tile_offsets, void* sent,
                     void* residual, void* mask, void* stream) {
  return dtype == 0
             ? emit_impl<float>(x, d, thresh, tile_counts, tile_offsets, sent,
                                residual, mask, stream)
             : emit_impl<__nv_bfloat16>(x, d, thresh, tile_counts, tile_offsets,
                                        sent, residual, mask, stream);
}

const char* topk_filter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
