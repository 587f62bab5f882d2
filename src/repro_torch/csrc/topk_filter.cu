// Top-k message filter by histogram select (Algorithm 2, lines 7-9; Table I).
//
// Replaces the TPU kernel src/repro/kernels/topk_filter.py::topk_filter_pallas
// (bodies _histogram_kernel and _emit_kernel, host glue _bucket_edges and
// _select_band). The TPU runs its grid in order on one core and carries
// counts and the running band admission in scratch across grid steps; on
// Hopper the blocks run in parallel, so the carried state becomes four
// launches on one stream, with no host work between them:
//
//   topk_max    each block: max |x| over its chunk -> partial[b]. Block 0
//               also zeroes the global counts of the next two passes.
//   topk_hist1  each block: max|x| = max of the partials, the first ladder
//               (64 edges from max|x| down to max|x| * 2^-22), and
//               #{ |x| >= edge_j } over its chunk, added to counts1.
//   topk_hist2  each block: the band [t_lo, t_hi) that counts1 selects, the
//               refined ladder inside it, and its chunk's counts on that
//               ladder (plus #{ |x| >= 3.4e38 }), stored as its row and
//               added to counts2.
//   topk_emit   each block: the final band and quota from counts2, its
//               chunk's offset among band elements (the sum of the band
//               counts in the rows of the blocks before it), then keep
//               |x| >= t_hi outright and admit a band element when its
//               index-order rank is below the quota; write sent, residual
//               and mask.
//
// The glue between passes (max, ladders, band selection, quota, the inf
// rule) runs in device code at the head of the next pass, computed by every
// block from the counts the previous pass left. Every block gets the same
// values from the same inputs, so no block waits on another and no ticket
// counter has to be zeroed before the first launch; the wrapper's scratch
// comes from torch.empty. Counts are integers, so the order of the atomics
// does not change them, and the filter repeats bit for bit.
//
// Blocks own contiguous chunks of whole 1024-element tiles, at most
// kMaxBlocks of them, so one design serves d = 1 and d in the millions.
//
// The float32 decisions equal topk_filter_plain's on the card: the ladder is
// evaluated as torch evaluates it there, one rounding per op in the same
// order (t = j * (1/63) as torch divides by a scalar, __fmul_rn / __fadd_rn
// so no multiply-add is contracted, full-precision logf / expf, the clamps
// clamp_min(hi, 1e-37) and maximum(lo, hi * 1e-37)). Magnitudes are compared
// in float32 for float32 and bfloat16 input.
//
// What bounds it: device memory. The function reads dw and writes sent,
// residual and mask once; the passes read dw four times, from L2 at the main
// path's d = 47,236. At that size the four launches, not the bytes, set the
// time.
//
// C interface, launched on the caller's stream; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBuckets = 64;
constexpr int kRowWords = kBuckets + 1;  // a block's counts on ladder 2, then #{>= kHuge}
constexpr int kTile = 1024;              // elements per step; the block size
constexpr int kMaxBlocks = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kFloor = 0x1p-22f;  // FLOOR = 2**-22 in kernels/topk_filter.py
constexpr float kHuge = 3.4e38f;    // what an infinite t_hi becomes

// Scratch, in 32-bit words: partial maxima, the two global histograms, and
// the per-block rows of the second histogram.
constexpr int kPartial = 0;
constexpr int kCounts1 = kPartial + kMaxBlocks;
constexpr int kCounts2 = kCounts1 + kBuckets;
constexpr int kRows = kCounts2 + kBuckets;
constexpr int kScratchWords = kRows + kMaxBlocks * kRowWords;

__device__ __forceinline__ float magnitude(float x) { return fabsf(x); }
__device__ __forceinline__ float magnitude(__nv_bfloat16 x) {
  return fabsf(__bfloat162float(x));
}
template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// torch.maximum / torch.minimum / clamp_min: NaN propagates.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

// Edge j of _bucket_edges(hi, lo), as torch computes it on the card.
__device__ __forceinline__ float ladder_edge(float hi, float lo, int j) {
  hi = nan_max(hi, 1e-37f);
  lo = nan_max(lo, __fmul_rn(hi, 1e-37f));
  const float t = __fmul_rn((float)j, 1.0f / (float)(kBuckets - 1));
  return expf(__fadd_rn(__fmul_rn(logf(hi), __fsub_rn(1.f, t)), __fmul_rn(logf(lo), t)));
}

// The block's chunk: whole tiles, the same in every pass.
struct Chunk {
  int begin, end;
};
__device__ __forceinline__ Chunk chunk_of(int d, int tiles_per_block) {
  const long long b = (long long)blockIdx.x * tiles_per_block * kTile;
  const long long e = b + (long long)tiles_per_block * kTile;
  return {(int)min(b, (long long)d), (int)min(e, (long long)d)};
}

__device__ __forceinline__ float block_max(float v, float* warp_vals) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  if (lane == 0) warp_vals[warp] = v;
  __syncthreads();
  v = warp_vals[lane];  // blockDim == 1024: 32 warps
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  __syncthreads();  // warp_vals may be reused
  return v;
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

// The glue of kernels/topk_filter.py::_thresholds, computed by every block.
struct Glue {
  float edges[kBuckets];
  float warp_vals[32];
  float mag_max;
  float t_lo, t_hi;
  int count_hi;
  int j;  // the band's index on its ladder
};

// max|x| from the partials, then the first ladder.
__device__ void glue_ladder1(const float* partial, int nb, Glue& g) {
  const float v = threadIdx.x < nb ? partial[threadIdx.x] : 0.f;
  const float mx = block_max(v, g.warp_vals);
  if (threadIdx.x == 0) g.mag_max = mx;
  if (threadIdx.x < kBuckets)
    g.edges[threadIdx.x] = ladder_edge(mx, __fmul_rn(mx, kFloor), threadIdx.x);
  __syncthreads();
}

// _select_band(counts, g.edges, k) by one thread.
__device__ void glue_select(const int* counts, int k, Glue& g) {
  if (threadIdx.x == 0) {
    int j = kBuckets - 1;
    for (int i = 0; i < kBuckets; ++i)
      if (counts[i] >= k) {
        j = i;
        break;
      }
    g.j = j;
    g.t_lo = g.edges[j];
    g.t_hi = j > 0 ? g.edges[j - 1] : INFINITY;
    g.count_hi = j > 0 ? counts[j - 1] : 0;
  }
  __syncthreads();
}

// The refined ladder inside the first band.
__device__ void glue_ladder2(Glue& g) {
  const float hi = nan_min(g.t_hi, g.mag_max), lo = g.t_lo;
  __syncthreads();  // every thread has read the band before edges change
  if (threadIdx.x < kBuckets) g.edges[threadIdx.x] = ladder_edge(hi, lo, threadIdx.x);
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kTile)
topk_max(const T* __restrict__ x, int d, int tiles_per_block, int* __restrict__ scratch) {
  __shared__ float warp_vals[32];
  const Chunk c = chunk_of(d, tiles_per_block);
  float m = 0.f;
  for (int i = c.begin + threadIdx.x; i < c.end; i += kTile) m = fmaxf(m, magnitude(x[i]));
  m = block_max(m, warp_vals);
  if (threadIdx.x == 0) reinterpret_cast<float*>(scratch)[kPartial + blockIdx.x] = m;
  if (blockIdx.x == 0 && threadIdx.x < 2 * kBuckets) scratch[kCounts1 + threadIdx.x] = 0;
}

// Adds #{ |x| >= edges[j] } over the chunk into hist[j] (shared, zeroed),
// and #{ |x| >= kHuge } into hist[kBuckets] when `huge` is set.
template <typename T>
__device__ void count_chunk(const T* __restrict__ x, Chunk c, const float* edges, int* hist,
                            bool huge) {
  const int lane = threadIdx.x & 31;
  unsigned lo = 0, hi = 0, big = 0;  // lane l counts edges l and l + 32
  for (int base = c.begin; base < c.end; base += kTile) {
    const int i = base + threadIdx.x;
    const bool valid = i < c.end;
    const float m = valid ? magnitude(x[i]) : 0.f;
#pragma unroll
    for (int j = 0; j < kBuckets; ++j) {
      const unsigned ballot = __ballot_sync(kFull, valid && m >= edges[j]);
      if (lane == (j & 31)) {
        if (j < 32) lo += __popc(ballot); else hi += __popc(ballot);
      }
    }
    if (huge) big += __popc(__ballot_sync(kFull, valid && m >= kHuge));
  }
  atomicAdd(&hist[lane], (int)lo);
  atomicAdd(&hist[lane + 32], (int)hi);
  if (huge && lane == 0) atomicAdd(&hist[kBuckets], (int)big);
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kTile)
topk_hist1(const T* __restrict__ x, int d, int tiles_per_block, int* __restrict__ scratch) {
  __shared__ Glue g;
  __shared__ int hist[kBuckets];
  if (threadIdx.x < kBuckets) hist[threadIdx.x] = 0;
  glue_ladder1(reinterpret_cast<const float*>(scratch) + kPartial, gridDim.x, g);
  count_chunk(x, chunk_of(d, tiles_per_block), g.edges, hist, false);
  if (threadIdx.x < kBuckets && hist[threadIdx.x] != 0)
    atomicAdd(&scratch[kCounts1 + threadIdx.x], hist[threadIdx.x]);
}

template <typename T>
__global__ void __launch_bounds__(kTile)
topk_hist2(const T* __restrict__ x, int d, int k, int tiles_per_block,
           int* __restrict__ scratch) {
  __shared__ Glue g;
  __shared__ int hist[kRowWords];
  if (threadIdx.x < kRowWords) hist[threadIdx.x] = 0;
  glue_ladder1(reinterpret_cast<const float*>(scratch) + kPartial, gridDim.x, g);
  glue_select(scratch + kCounts1, k, g);
  glue_ladder2(g);
  count_chunk(x, chunk_of(d, tiles_per_block), g.edges, hist, true);
  if (threadIdx.x < kRowWords) {
    scratch[kRows + blockIdx.x * kRowWords + threadIdx.x] = hist[threadIdx.x];
    if (threadIdx.x < kBuckets && hist[threadIdx.x] != 0)
      atomicAdd(&scratch[kCounts2 + threadIdx.x], hist[threadIdx.x]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kTile)
topk_emit(const T* __restrict__ x, int d, int k, int tiles_per_block,
          const int* __restrict__ scratch, T* __restrict__ sent, T* __restrict__ residual,
          uint8_t* __restrict__ mask) {
  __shared__ Glue g;
  __shared__ int warp_sums[32];
  __shared__ int total;
  glue_ladder1(reinterpret_cast<const float*>(scratch) + kPartial, gridDim.x, g);
  glue_select(scratch + kCounts1, k, g);
  glue_ladder2(g);
  glue_select(scratch + kCounts2, k, g);
  const float t_lo = g.t_lo;
  // The inf rule: an infinite t_hi becomes kHuge, whose counts are the
  // rows' last word.
  const bool hi_inf = isinf(g.t_hi);
  const float t_hi = hi_inf ? kHuge : g.t_hi;
  const int quota = max(k - g.count_hi, 0);
  const int col_lo = g.j, col_hi = hi_inf ? kBuckets : g.j - 1;

  // #{t_lo <= |x| < t_hi} in block r is #{>= t_lo} - #{>= t_hi}, or 0 when
  // t_lo > t_hi makes the band empty.
  int before = 0;
  if ((int)threadIdx.x < (int)blockIdx.x) {
    const int* row = scratch + kRows + threadIdx.x * kRowWords;
    before = max(row[col_lo] - row[col_hi], 0);
  }
  block_exclusive_scan(before, warp_sums, &total);
  int offset = total;  // band elements in the chunks before this one

  const Chunk c = chunk_of(d, tiles_per_block);
  for (int base = c.begin; base < c.end; base += kTile) {
    const int i = base + threadIdx.x;
    T xv = zero_of<T>();
    bool strong = false, band = false;
    if (i < c.end) {
      xv = x[i];
      const float m = magnitude(xv);
      strong = m >= t_hi;
      band = m >= t_lo && m < t_hi;
    }
    const int rank = offset + block_exclusive_scan(band ? 1 : 0, warp_sums, &total);
    offset += total;  // read after the scan's barriers
    const bool keep = strong || (band && rank < quota);
    if (i < c.end) {
      sent[i] = keep ? xv : zero_of<T>();
      residual[i] = keep ? zero_of<T>() : xv;
      mask[i] = keep ? 1 : 0;
    }
  }
}

template <typename T>
int filter_impl(const void* xp, int d, int k, void* scratch_p, void* sent, void* residual,
                void* mask, cudaStream_t s) {
  const T* x = (const T*)xp;
  int* scratch = (int*)scratch_p;
  const int tiles = (d + kTile - 1) / kTile;
  const int tiles_per_block = (tiles + kMaxBlocks - 1) / kMaxBlocks;
  const int nb = (tiles + tiles_per_block - 1) / tiles_per_block;
  // A refused launch never runs: stop before a later pass reads what it left.
  topk_max<T><<<nb, kTile, 0, s>>>(x, d, tiles_per_block, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_hist1<T><<<nb, kTile, 0, s>>>(x, d, tiles_per_block, scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  topk_hist2<T><<<nb, kTile, 0, s>>>(x, d, k, tiles_per_block, scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  topk_emit<T><<<nb, kTile, 0, s>>>(x, d, k, tiles_per_block, scratch, (T*)sent,
                                    (T*)residual, (uint8_t*)mask);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 32-bit words of scratch one call needs; the wrapper allocates them uninitialized.
int topk_filter_scratch_words() { return kScratchWords; }

// dtype: 0 = float32, 1 = bfloat16; 1 <= k <= d (checked by the wrapper).
int topk_filter_launch(const void* x, int d, int dtype, int k, void* scratch, void* sent,
                       void* residual, void* mask, void* stream) {
  if (d < 1 || k < 1 || k > d) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return filter_impl<float>(x, d, k, scratch, sent, residual, mask, s);
  if (dtype == 1)
    return filter_impl<__nv_bfloat16>(x, d, k, scratch, sent, residual, mask, s);
  return (int)cudaErrorInvalidValue;
}

const char* topk_filter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
