// The exchange's histogram threshold (core/compress.py threshold_for_topk) on the card.
//
// Replaces no TPU kernel: the JAX counterpart (src/repro/core/compress.py
// threshold_for_topk and _round) is jnp. It was added because the plain
// version, run on the card, writes five full-size temporaries a round and
// syncs with the host three times a round (torch.bincount reads its input's
// min and max; a constant is copied from pageable memory), once for each
// group and leaf of every exchange step.
//
// The same two-round log-bucket threshold, in three launches on one stream
// with no host work between them and no full-size temporary:
//
//   exchange_threshold_max       each block: max |x| over its elements ->
//                                partial[b]. Block 0 also zeroes the counts
//                                of the next passes and the ticket.
//   exchange_threshold_round<1>  each block: max|x| = max of the partials
//                                (NaN if one is), the round's hi, lo and
//                                ratio, and the bucket of each element,
//                                counted into counts1.
//   exchange_threshold_round<2>  each block: round 1's band j from counts1,
//                                its edges, the refined range, and the
//                                buckets again into counts2.
//
// The last round's last block to finish (a ticket counter) selects the band
// from its counts and writes t_lo to the one-element output; without refine
// that is round 1, and round 2 is not launched. The glue between passes
// runs in device code at the head of the next pass, computed by every block
// from what the previous pass left, so no block waits on another.
//
// The float32 decisions equal the plain version's on the card
// (kernels/exchange_threshold.py _round), one rounding per op in torch's
// order: full-precision logf and expf; a true division where torch divides
// by a 0-dim CUDA tensor (lo / hi, |x| / hi, the log / ratio: __fdiv_rn); a
// multiply by the reciprocal where it divides by the Python scalar 63 (torch
// computes 1.0f / 63 on the host and multiplies); __fmul_rn so that no
// multiply-add is contracted; .to(int32) as cvt.rzi (truncating, NaN to 0,
// saturating); and the NaN rules of clamp, maximum and minimum. The counts
// are integers, so the threshold is the plain version's bit for bit on
// finite input, whatever order the blocks run in.
//
// What bounds it: device memory. A call reads x once a pass (three passes
// with refine), 12 B a coordinate; at the exchange's 183.5 M-coordinate leaf
// that is 2.2 GB, 0.66 ms at 3.35 TB/s. Loads are float4 (a scalar head and
// tail around the aligned body), four in flight a thread, over a grid of up
// to four blocks an SM. Each warp counts into its own 65 bins in shared
// memory with shared atomics, so a crowded bucket serialises one warp, not
// the block; a block merges its warps' counts into the grid's once, with one
// atomic a bin.
//
// C interface, launched on the caller's stream; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBuckets = 64;             // _NUM_BUCKETS; bin kBuckets holds |x| < lo
constexpr int kBins = kBuckets + 1;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 4;
constexpr int kMaxBlocks = 1024;
constexpr int kPerThread = 16;           // least elements a thread, where n allows
constexpr unsigned kFull = 0xffffffffu;
constexpr float kFloor = 0x1p-22f;       // _FLOOR
// torch turns the Python float 1e-37 into float32 by way of double.
#define kTiny ((float)1e-37)
// torch divides by the Python scalar 63 as a multiply by 1.0f / 63.0f.
#define kInv63 (1.0f / (float)(kBuckets - 1))

// Scratch, in 32-bit words: partial maxima, the two rounds' counts, the ticket.
constexpr int kPartial = 0;
constexpr int kCounts1 = kPartial + kMaxBlocks;
constexpr int kCounts2 = kCounts1 + kBins;
constexpr int kTicket = kCounts2 + kBins;
constexpr int kScratchWords = kTicket + 1;

// torch.maximum / torch.minimum / clamp: NaN propagates.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

// One round's range, as _round computes it from its hi and lo.
struct Ladder {
  float hi, lo, ratio;
};

__device__ __forceinline__ Ladder ladder(float hi, float lo) {
  hi = nan_max(hi, kTiny);                           // torch.clamp(hi, min=1e-37)
  lo = nan_min(nan_max(lo, __fmul_rn(hi, kTiny)), hi);
  return {hi, lo, __fmul_rn(logf(__fdiv_rn(lo, hi)), kInv63)};  // negative
}

// The bucket of one magnitude; bucket 0 holds the largest.
__device__ __forceinline__ int bucket(float m, const Ladder& r) {
  if (!(m >= r.lo)) return kBuckets;
  const float v = __fdiv_rn(logf(__fdiv_rn(nan_max(m, kTiny), r.hi)), r.ratio);
  return min(max(__float2int_rz(v), 0), kBuckets);
}

// _round's edge(i): the lower edge of bucket i - 1.
__device__ __forceinline__ float edge(const Ladder& r, int i) {
  return __fmul_rn(r.hi, expf(__fmul_rn(r.ratio, (float)i)));
}

// The first bucket whose running count reaches k, else the last one.
__device__ int select_bucket(const int* counts, long long k) {
  long long csum = 0;
  for (int i = 0; i < kBuckets; ++i) {
    csum += __ldcg(counts + i);  // written by other blocks' atomics
    if (csum >= k) return i;
  }
  return kBuckets - 1;
}

// f(v) for every element, each once over the grid: a float4 body and a
// scalar head (up to 16-byte alignment) and tail.
template <typename F>
__device__ __forceinline__ void each_element(const float* __restrict__ x, int n, int head,
                                             int n4, F&& f) {
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x + head);
  int i = tid;
  for (; i + 3 * stride < n4; i += 4 * stride) {
    const float4 a = x4[i], b = x4[i + stride], c = x4[i + 2 * stride], d = x4[i + 3 * stride];
    f(a.x); f(a.y); f(a.z); f(a.w);
    f(b.x); f(b.y); f(b.z); f(b.w);
    f(c.x); f(c.y); f(c.z); f(c.w);
    f(d.x); f(d.y); f(d.z); f(d.w);
  }
  for (; i < n4; i += stride) {
    const float4 a = x4[i];
    f(a.x); f(a.y); f(a.z); f(a.w);
  }
  const int tail = head + 4 * n4;
  if (tid < head) f(x[tid]);
  if (tid < n - tail) f(x[tail + tid]);
}

// max over the block, every thread gets it; NaN if `nan` is set anywhere.
__device__ float block_max(float v, bool nan, float* warp_vals) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  if (lane == 0) warp_vals[warp] = v;
  const bool any_nan = __syncthreads_or(nan);
  v = lane < kWarps ? warp_vals[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  __syncthreads();  // warp_vals may be reused
  return any_nan ? __int_as_float(0x7fffffff) : v;
}

__global__ void __launch_bounds__(kThreads)
exchange_threshold_max(const float* __restrict__ x, int n, int head, int n4,
                       int* __restrict__ scratch) {
  __shared__ float warp_vals[32];
  float m = 0.f;
  bool nan = false;
  each_element(x, n, head, n4, [&](float v) {
    const float a = fabsf(v);
    nan |= a != a;
    m = fmaxf(m, a);
  });
  m = block_max(m, nan, warp_vals);
  if (threadIdx.x == 0) reinterpret_cast<float*>(scratch)[kPartial + blockIdx.x] = m;
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < kScratchWords - kCounts1; i += kThreads)
      scratch[kCounts1 + i] = 0;
}

template <int kRound>
__global__ void __launch_bounds__(kThreads)
exchange_threshold_round(const float* __restrict__ x, int n, int head, int n4, long long k,
                         int last, int* __restrict__ scratch, float* __restrict__ out) {
  __shared__ int hist[kWarps][kBins];  // each warp's counts
  __shared__ float warp_vals[32];
  __shared__ Ladder range;
  __shared__ int is_last;
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) (&hist[0][0])[i] = 0;

  // max|x| = torch.max(mag) from the partials, then this round's range.
  const float* partial = reinterpret_cast<const float*>(scratch) + kPartial;
  float m = 0.f;
  bool nan = false;
  for (int i = threadIdx.x; i < gridDim.x; i += kThreads) {
    const float p = __ldcg(partial + i);
    nan |= p != p;
    m = fmaxf(m, p);
  }
  const float mag_max = block_max(m, nan, warp_vals);
  if (threadIdx.x == 0) {
    const Ladder r1 = ladder(mag_max, __fmul_rn(mag_max, kFloor));
    if (kRound == 1) {
      range = r1;
    } else {
      const int j = select_bucket(scratch + kCounts1, k);
      const float t_lo = edge(r1, j + 1);
      const float t_hi = j > 0 ? edge(r1, j) : INFINITY;
      range = ladder(isinf(t_hi) ? mag_max : t_hi, t_lo);
    }
  }
  __syncthreads();
  const Ladder r = range;

  int* mine = hist[threadIdx.x >> 5];
  each_element(x, n, head, n4, [&](float v) { atomicAdd(mine + bucket(fabsf(v), r), 1); });
  __syncthreads();

  // The block's counts into the grid's, one atomic a bin.
  int* counts = scratch + (kRound == 1 ? kCounts1 : kCounts2);
  if (threadIdx.x < kBins) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += hist[w][threadIdx.x];
    if (c) atomicAdd(counts + threadIdx.x, c);
  }
  if (!last) return;

  // The last block to finish selects the band and writes its lower edge.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(scratch + kTicket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (is_last && threadIdx.x == 0) {
    __threadfence();
    out[0] = edge(r, select_bucket(counts, k) + 1);
  }
}

// Blocks: enough that each thread has kPerThread elements, at most
// kBlocksPerSM an SM (and kMaxBlocks).
int grid_blocks(int n) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const long long want = ((long long)n + kThreads * kPerThread - 1) / (kThreads * kPerThread);
  const long long cap = sms * kBlocksPerSM < kMaxBlocks ? sms * kBlocksPerSM : kMaxBlocks;
  return (int)(want < cap ? want : cap);
}

}  // namespace

extern "C" {

// 32-bit words of scratch one call needs; the wrapper allocates them uninitialized.
int exchange_threshold_scratch_words() { return kScratchWords; }

// x: n float32 (n >= 1, 4-byte aligned); out: one float32. Three launches
// (two without refine) on `stream`.
int exchange_threshold_launch(const void* xp, int n, long long k, int refine, void* scratch_p,
                              void* out_p, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const float* x = (const float*)xp;
  int* scratch = (int*)scratch_p;
  float* out = (float*)out_p;
  const cudaStream_t s = (cudaStream_t)stream;
  int head = (int)(((16u - ((uintptr_t)x & 15u)) & 15u) / 4u);
  if (head > n) head = n;
  const int n4 = (n - head) / 4;
  const int nb = grid_blocks(n);
  if (nb < 1) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  // A refused launch never runs: stop before a later pass reads what it left.
  exchange_threshold_max<<<nb, kThreads, 0, s>>>(x, n, head, n4, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  exchange_threshold_round<1><<<nb, kThreads, 0, s>>>(x, n, head, n4, k, !refine, scratch, out);
  if ((err = cudaGetLastError()) != cudaSuccess || !refine) return (int)err;
  exchange_threshold_round<2><<<nb, kThreads, 0, s>>>(x, n, head, n4, k, 1, scratch, out);
  return (int)cudaGetLastError();
}

const char* exchange_threshold_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
