// The exchange's elementwise split (core/exchange.py exchange_sequential) on the card.
//
// Replaces no TPU kernel: the JAX counterpart is the jnp split of
// src/repro/core/exchange.py (its exchange_sequential, lines 127-149). It was
// added because the same split in plain PyTorch launches ~25 kernels for each
// leaf and worker group (the float32 copy of the gradient, the residual add,
// abs, the mask, zeros, three where's, the products, the sums and copies,
// ~8 ops on 0-dim tensors) and moves ~115 B of device memory a coordinate,
// where the work needs 10 + 16. Two launches a leaf and group, around the
// unchanged threshold kernel (csrc/exchange_threshold.cu):
//
//   exchange_apply_add<T>   pass 1, in place: res += float(grad), the
//                           residual add of Alg. 2 line 6. res then holds dw.
//   exchange_apply_split    pass 2, from the 0-dim device values thresh, p_g
//                           and dense_step (never read to the host):
//                             keep = dense || |d| >= thresh,  s = keep ? d : +0
//                             acc += p_g * s;  res = p_g > 0 ? d - s : d
//                           and the group's accounting: kept, then in the last
//                           block sent_count += p_g * kept and byte_count +=
//                           p_g * bytes(kept), in float32 as torch computes them.
//                           In always-dense mode (a leaf under min_leaf_size)
//                           keep is true everywhere and bytes are the dense ones.
//
// Bit for bit the plain sequence (kernels/exchange_apply.py), non-finite
// values included: every float op is the one torch runs, rounded once
// (__fadd_rn, __fmul_rn, __fsub_rn, so that nothing is contracted into an
// FMA; int64 to float32 as cvt.rn). Pass 2 skips only the stores that change
// no bit: a coordinate that is not kept has s = +0, so res = d - 0 = d (the
// store is made anyway where d is NaN, whose payload the subtraction may
// change), and acc + p_g * s is written only where p_g * s is not a zero (at
// p_g = 0 only a kept +-inf gives 0 * inf = NaN). acc + 0 == acc for every acc
// but -0, and the accumulator never holds -0: it starts at +0, and a float
// sum that starts at +0 never rounds to -0.
//
// What bounds it: device memory. Pass 1 reads the gradient (2 B a coordinate
// in bf16) and reads and writes the residual: 10 B. Pass 2 reads the residual
// (4 B), and reads and writes acc and writes the residual only in the chunks
// of four that hold a kept coordinate (48 B a chunk): 16 B on the dense step,
// 4 B at p_g = 0, and on a sparse step 4 B plus 12 B a kept coordinate. Kept
// coordinates that scatter uniformly (6 % of the chunks at rho 1/64) still
// send a 16-byte access to nearly every DRAM page, so there an H100 takes ~90 %
// of a dense pass's time; clustered ones cost less. Loads and stores are 16 B
// a thread (float4; four bf16 as 8 B beside them, so that each load
// instruction of a warp covers one contiguous span), two chunks in flight a
// thread, a grid-stride loop over a grid sized to fill every SM, and a scalar
// head (up to 16-byte alignment) and tail. The count is a warp reduction and one int64
// atomic a block; a ticket finds the last block.
//
// C interface, launched on the caller's stream; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;  // least coordinates a thread, where n allows
constexpr unsigned kFull = 0xffffffffu;

// Scratch, in 64-bit words: the kept count and the ticket. Zeroed by the wrapper.
constexpr int kScratchWords = 2;

// Four gradient values as float32, from 4-aligned storage.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

__device__ __forceinline__ float4 add4(float4 r, float4 g) {
  return make_float4(__fadd_rn(r.x, g.x), __fadd_rn(r.y, g.y), __fadd_rn(r.z, g.z),
                     __fadd_rn(r.w, g.w));
}

// Pass 1. The body is n4 chunks of four from `head`, where res and grad are
// both aligned; the rest goes one coordinate at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
exchange_apply_add(float* __restrict__ res, const T* __restrict__ grad, long long n, int head,
                   long long n4) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  float4* __restrict__ r4 = reinterpret_cast<float4*>(res + head);
  const T* __restrict__ g = grad + head;
  for (long long i = tid; i < n4; i += 2 * stride) {
    const long long j = i + stride;
    const float4 r0 = r4[i], g0 = load4(g + 4 * i);
    float4 r1, g1;
    if (j < n4) r1 = r4[j], g1 = load4(g + 4 * j);
    r4[i] = add4(r0, g0);
    if (j < n4) r4[j] = add4(r1, g1);
  }
  for (long long i = tid; i < head; i += stride) res[i] = __fadd_rn(res[i], to_float(grad[i]));
  for (long long i = head + 4 * n4 + tid; i < n; i += stride)
    res[i] = __fadd_rn(res[i], to_float(grad[i]));
}

// Pass 2's decisions for one coordinate.
struct Split {
  float t, pg;
  bool dense, pg_pos;

  // s, p_g * s, and whether acc and res change; counts a kept coordinate.
  __device__ __forceinline__ void at(float d, float& s, float& prod, bool& put_acc,
                                     bool& put_res, int& kept) const {
    const bool keep = dense || fabsf(d) >= t;
    s = keep ? d : 0.f;
    prod = __fmul_rn(pg, s);
    put_acc = !(prod == 0.f);  // non-zero or NaN
    put_res = pg_pos && (keep || d != d);
    kept += keep;
  }
};

__device__ __forceinline__ void split4(float4* __restrict__ r4, float4* __restrict__ a4,
                                       long long i, float4 d, const Split& sp, int& kept) {
  float s[4], prod[4];
  bool pa[4], pr[4];
  const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) sp.at(dv[c], s[c], prod[c], pa[c], pr[c], kept);
  if (pa[0] || pa[1] || pa[2] || pa[3]) {
    float4 a = a4[i];
    float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (pa[c]) av[c] = __fadd_rn(av[c], prod[c]);
    a4[i] = make_float4(av[0], av[1], av[2], av[3]);
  }
  if (pr[0] || pr[1] || pr[2] || pr[3]) {
    float rv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) rv[c] = pr[c] ? __fsub_rn(dv[c], s[c]) : dv[c];
    r4[i] = make_float4(rv[0], rv[1], rv[2], rv[3]);
  }
}

__device__ __forceinline__ void split1(float* __restrict__ res, float* __restrict__ acc,
                                       long long i, const Split& sp, int& kept) {
  const float d = res[i];
  float s, prod;
  bool pa, pr;
  sp.at(d, s, prod, pa, pr, kept);
  if (pa) acc[i] = __fadd_rn(acc[i], prod);
  if (pr) res[i] = __fsub_rn(d, s);
}

// Pass 2. `thresh` is read only where `always_dense` is 0.
__global__ void __launch_bounds__(kThreads)
exchange_apply_split(float* __restrict__ res, float* __restrict__ acc, long long n, int head,
                     long long n4, const float* __restrict__ thresh,
                     const float* __restrict__ pg_p, const bool* __restrict__ dense_p,
                     int always_dense, unsigned long long* __restrict__ scratch,
                     float* __restrict__ sent_count, float* __restrict__ byte_count,
                     long long dense_entry, long long dense_over, long long sparse_entry,
                     long long sparse_over) {
  __shared__ int warp_kept[kWarps];
  __shared__ bool is_last;
  Split sp;
  sp.pg = *pg_p;
  sp.pg_pos = sp.pg > 0.f;
  sp.dense = always_dense || *dense_p;
  sp.t = always_dense ? 0.f : *thresh;

  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  float4* __restrict__ r4 = reinterpret_cast<float4*>(res + head);
  float4* __restrict__ a4 = reinterpret_cast<float4*>(acc + head);
  int kept = 0;
  for (long long i = tid; i < n4; i += 2 * stride) {
    const long long j = i + stride;
    const float4 d0 = r4[i];
    float4 d1;
    if (j < n4) d1 = r4[j];
    split4(r4, a4, i, d0, sp, kept);
    if (j < n4) split4(r4, a4, j, d1, sp, kept);
  }
  for (long long i = tid; i < head; i += stride) split1(res, acc, i, sp, kept);
  for (long long i = head + 4 * n4 + tid; i < n; i += stride) split1(res, acc, i, sp, kept);

  // The block's count, then one atomic.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) kept += __shfl_xor_sync(kFull, kept, o);
  if ((threadIdx.x & 31) == 0) warp_kept[threadIdx.x >> 5] = kept;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long block = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) block += warp_kept[w];
    atomicAdd(scratch, (unsigned long long)block);
    __threadfence();
    is_last = atomicAdd(scratch + 1, 1ull) == (unsigned long long)gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last || threadIdx.x != 0) return;

  // The last block: the group's accounting, as exchange_sequential's 0-dim ops.
  __threadfence();
  const long long total = (long long)atomicAdd(scratch, 0ull);
  const long long nbytes = sp.dense ? total * dense_entry + dense_over
                                    : total * sparse_entry + sparse_over;
  *sent_count = __fadd_rn(*sent_count, __fmul_rn(sp.pg, __ll2float_rn(total)));
  *byte_count = __fadd_rn(*byte_count, __fmul_rn(sp.pg, __ll2float_rn(nbytes)));
}

// Blocks of `kernel` resident at once on one SM (asked once a kernel).
template <typename K>
int resident_blocks(K kernel) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) !=
      cudaSuccess)
    return -1;
  return per_sm > 0 ? per_sm : 1;
}

// Blocks: enough that each thread has kPerThread coordinates, at most as many
// as are resident at once on every SM.
int grid_blocks(int per_sm, long long n) {
  int dev = 0, sms = 0;
  if (per_sm < 1 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const long long want = (n + kThreads * kPerThread - 1) / (kThreads * kPerThread);
  const long long cap = (long long)sms * per_sm;
  return (int)(want < 1 ? 1 : want < cap ? want : cap);
}

// Coordinates before the first 16-byte-aligned one of `a`, and whether `b`
// (`b_size` bytes a value) is 4-value-aligned there too; else no body.
void plan(const void* a, const void* b, int b_size, long long n, int* head, long long* n4) {
  int h = (int)(((16u - ((uintptr_t)a & 15u)) & 15u) / 4u);
  if (h > n) h = (int)n;
  if (((uintptr_t)b + (uintptr_t)h * b_size) % (uintptr_t)(4 * b_size) != 0) {
    *head = 0;
    *n4 = 0;
    return;
  }
  *head = h;
  *n4 = (n - h) / 4;
}

int launch_error(int blocks) {
  if (blocks >= 1) return (int)cudaGetLastError();
  const cudaError_t err = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
}

template <typename T>
int add_launch(float* res, const T* grad, long long n, cudaStream_t s) {
  int head;
  long long n4;
  plan(res, grad, (int)sizeof(T), n, &head, &n4);
  static const int per_sm = resident_blocks(exchange_apply_add<T>);
  const int nb = grid_blocks(per_sm, n);
  if (nb < 1) return launch_error(nb);
  exchange_apply_add<T><<<nb, kThreads, 0, s>>>(res, grad, n, head, n4);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 64-bit words of zeroed scratch one split needs.
int exchange_apply_scratch_words() { return kScratchWords; }

// res: n float32; grad: n values of grad_dtype (0 float32, 1 bfloat16, 2 float16).
int exchange_apply_add_launch(void* res, const void* grad, long long n, int grad_dtype,
                              void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* r = (float*)res;
  switch (grad_dtype) {
    case 0: return add_launch(r, (const float*)grad, n, s);
    case 1: return add_launch(r, (const __nv_bfloat16*)grad, n, s);
    case 2: return add_launch(r, (const __half*)grad, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// res, acc: n float32; thresh, pg: one float32 (thresh unused with always_dense);
// dense_step: one bool; scratch: kScratchWords zeroed words; sent_count,
// byte_count: one float32 each, updated in place.
int exchange_apply_split_launch(void* res, void* acc, long long n, const void* thresh,
                                const void* pg, const void* dense_step, int always_dense,
                                void* scratch, void* sent_count, void* byte_count,
                                long long dense_entry, long long dense_over,
                                long long sparse_entry, long long sparse_over, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  int head;
  long long n4;
  plan(res, acc, 4, n, &head, &n4);
  static const int per_sm = resident_blocks(exchange_apply_split);
  const int nb = grid_blocks(per_sm, n);
  if (nb < 1) return launch_error(nb);
  exchange_apply_split<<<nb, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)res, (float*)acc, n, head, n4, (const float*)thresh, (const float*)pg,
      (const bool*)dense_step, always_dense, (unsigned long long*)scratch, (float*)sent_count,
      (float*)byte_count, dense_entry, dense_over, sparse_entry, sparse_over);
  return (int)cudaGetLastError();
}

const char* exchange_apply_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
