// GQA flash-attention forward for Hopper, causal or not.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::
// flash_attention_fwd_pallas (body _flash_fwd_kernel). For q (B, S, KV, G, hd)
// and k, v (B, S, KV, hd), in float32 or bfloat16:
//
//     out[b, s, h, g] = softmax_t(sm_scale * q[b, s, h, g] . k[b, t, h]) v[b, t, h]
//
// over t < S (and t <= s when causal), computed in float32 and written in
// q's dtype. Masked scores are -1e30, not -inf, as on the TPU.
//
// Design: one block per (query tile, b, kv head); blockIdx.x is the query
// tile, taken in reverse so that the long causal tiles start first. A tile
// holds the 64 / G query positions of all G query heads of one KV head (64
// rows), so each K/V tile is read once for the whole group: the GPU form of
// the TPU index maps that ignore g. The Q tile, scaled by sm_scale in
// float32, sits in shared memory for the whole loop; K/V tiles of BK rows
// (64, or 32 at hd = 128) are staged in shared memory as float32. 256
// threads form 16 row groups of 4 rows by 16 column lanes; each thread keeps
// the online-softmax state (m, l) and its 4 x hd/16 slice of acc in
// registers:
//
//     m_new = max(m, rowmax s); corr = exp(m - m_new)
//     l = l corr + sum p;        acc = acc corr + p v
//
// and the tile ends with acc / max(l, 1e-30). Row maxima and sums are
// reduced over the 16 lanes of a row group by warp shuffles. KV tiles that
// lie wholly above the diagonal are skipped: the loop stops at the tile
// holding the tile's last query position. Layouts are read in place with
// their strides; ragged S is handled by bounds checks (K/V rows at or
// beyond S load as 0 and are masked; query rows at or beyond S are never
// written), so there is no padding or transpose copy.
//
// What bounds it: at the serve shape (B 4, S 2048, KV 8, G 5, hd 128) the
// work is ~1.7e11 FLOP against ~0.2 GB of traffic, so it is bound by
// operations. This first version runs both products on the CUDA cores in
// float32 (expf, no fast math), fed from shared memory, far below the
// tensor cores' bf16 rate; wgmma/TMA tiles are the way up.
//
// C interface, launched on the caller's stream; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kRows = 64;      // query rows (position, group) per block
constexpr int kRowsPerThread = kRows / 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int HD>
struct Tile {
  static constexpr int BK = HD >= 128 ? 32 : 64;  // K/V rows per tile
  static constexpr int kStride = HD + 1;          // padded: no bank conflicts
  static constexpr int pStride = BK + 1;
  static constexpr size_t floats =
      (size_t)kRows * kStride + (size_t)BK * kStride + (size_t)BK * HD +
      (size_t)kRows * pStride;
  static constexpr size_t bytes = floats * sizeof(float);
};

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int KV,
                 int G, int causal, float sm_scale) {
  using L = Tile<HD>;
  constexpr int BK = L::BK;
  constexpr int CPT = BK / 16;  // score columns per thread: tx + 16 j
  constexpr int OPT = HD / 16;  // output columns per thread: tx + 16 j
  extern __shared__ float smem[];
  float* sQ = smem;                    // kRows x (HD + 1)
  float* sK = sQ + kRows * L::kStride;  // BK x (HD + 1)
  float* sV = sK + BK * L::kStride;     // BK x HD
  float* sP = sV + BK * HD;             // kRows x (BK + 1)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bq = kRows / G;  // query positions per tile
  const int rows = bq * G;   // rows in use, <= kRows
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;
  const int b = blockIdx.y / KV;
  const int h = blockIdx.y % KV;
  const size_t q_tok = (size_t)KV * G * HD;  // q/out stride between positions
  const size_t kv_tok = (size_t)KV * HD;
  const T* qb = q + ((size_t)b * S * KV + h) * G * HD;
  const T* kb = k + ((size_t)b * S * KV + h) * HD;
  const T* vb = v + ((size_t)b * S * KV + h) * HD;
  T* ob = out + ((size_t)b * S * KV + h) * G * HD;

  // Q tile: row r is (position q0 + r / G, group r % G), scaled in float32.
  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int pos = q0 + r / G;
    float x = 0.f;
    if (r < rows && pos < S) x = to_float(qb[(size_t)pos * q_tok + (r % G) * HD + d]) * sm_scale;
    sQ[r * L::kStride + d] = x;
  }

  float m[kRowsPerThread], l[kRowsPerThread], acc[kRowsPerThread][OPT];
  int qpos[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    qpos[i] = q0 + (ty * kRowsPerThread + i) / G;
#pragma unroll
    for (int j = 0; j < OPT; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + bq - 1, S - 1);
  int nk = (S + BK - 1) / BK;
  if (causal) nk = min(nk, q_last / BK + 1);  // skip tiles above the diagonal

  for (int t = 0; t < nk; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the last tile's readers are done (and Q is stored)
    for (int i = tid; i < BK * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      const int pos = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (pos < S) {
        const size_t off = (size_t)pos * kv_tok + d;
        kx = to_float(kb[off]);
        vx = to_float(vb[off]);
      }
      sK[c * L::kStride + d] = kx;
      sV[c * HD + d] = vx;
    }
    __syncthreads();

    // s = (sm_scale q) k^T for 4 rows x CPT columns.
    float s[kRowsPerThread][CPT];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRowsPerThread], kv[CPT];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = sQ[(ty * kRowsPerThread + i) * L::kStride + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = sK[(tx + 16 * j) * L::kStride + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Mask, then the online-softmax update; p goes to shared memory.
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < S && (!causal || kp <= qpos[i]);
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty * kRowsPerThread + i) * L::pStride + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OPT; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc += p v for 4 rows x OPT output columns.
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[kRowsPerThread], vv[OPT];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = sP[(ty * kRowsPerThread + i) * L::pStride + c];
#pragma unroll
      for (int j = 0; j < OPT; ++j) vv[j] = sV[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < OPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = ty * kRowsPerThread + i;
    if (r >= rows || qpos[i] >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = ob + (size_t)qpos[i] * q_tok + (r % G) * HD;
#pragma unroll
    for (int j = 0; j < OPT; ++j) o[tx + 16 * j] = from_float<T>(acc[i][j] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S,
           int KV, int G, int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = Tile<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int bq = kRows / G;
  const dim3 grid((S + bq - 1) / bq, B * KV);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, KV, G, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B, int S,
              int KV, int G, int hd, int causal, float sm_scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, KV, G, causal, sm_scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, S, KV, G, causal, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, KV, G, causal, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, KV, G, causal, sm_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. The wrapper checks every argument first.
int flash_attn_launch(const void* q, const void* k, const void* v, void* out,
                      int B, int S, int KV, int G, int hd, int dtype, int causal,
                      float sm_scale, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || G < 1 || G > kRows || B * KV > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_hd<float>(q, k, v, out, B, S, KV, G, hd, causal, sm_scale, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, out, B, S, KV, G, hd, causal, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
