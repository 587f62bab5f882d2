// GQA flash-attention forward for Hopper, causal or not, with or without a
// sliding window, with or without a logit softcap.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::
// flash_attention_fwd_pallas (body _flash_fwd_kernel). For q (B, S, KV, G, hd)
// and k, v (B, S, KV, hd):
//
//     out[b, s, h, g] = softmax_t(cap(sm_scale * q[b, s, h, g] . k[b, t, h])) v[b, t, h]
//
// over t < S (and t <= s when causal, and s - t < window when a window is
// given), with the softmax in float32, written in q's dtype. The window is the
// JAX package's windowed flash_attention (src/repro/models/flash.py, _mask),
// one-sided also when not causal; its Pallas kernel has none. cap(x) is x
// without a softcap and softcap * tanh(x / softcap) with one (the JAX
// package's _scores, applied to the scaled float32 score before the mask);
// the cap is a template argument, so a launch without it runs the code it ran
// before the cap existed. Masked scores are -1e30, not -inf, as on the TPU.
//
// Full-range launches (full_range = 1, the model's exploit_window=False): the
// window still masks each row, but no tile below it is skipped; every tile
// from 0 to the diagonal is loaded. A row's tiles wholly below its window
// then come before its first real key. With the finite -1e30 each of their
// scores adds exp(-1e30 - (-1e30)) = 1 to l and its value row to O, and the
// first real key's correction exp(-1e30 - m) = 0 multiplies both by exactly
// 0 (they are finite: at most S ones and S value rows), so from there the row
// holds what the windowed launch holds, and the two launches agree bit for
// bit (up to the sign of an exact zero). One source, two kernels, chosen by
// dtype:
//
// bfloat16: flash_fwd_bf16, both products on the tensor cores.
//   One block per (128 query positions, b, query head). Warpgroups 0 and 1
//   are consumers of 64 query rows each; warpgroup 2 is the producer, whose
//   one thread loads by TMA (cp.async.bulk.tensor) straight from the
//   layouts as they are, described as rank-4 tensor maps: q as
//   (hd, KV*G, S, B), k and v as (hd, KV, S, B). The producer warpgroup
//   drops to 24 registers and the consumers ask for 240 (setmaxnreg). The
//   Q tile is loaded once; K/V tiles of 128 rows go through a ring of 2
//   stages behind mbarriers (full: the TMA's byte count; empty: all 256
//   consumer threads). A row of the tile is cut into boxes of 64, 32 or 16
//   columns (the widest of them that divides hd), each swizzled by its width
//   (128, 64 or 32 bytes) and stored box after box: hd = 128 takes two boxes
//   of 64, hd = 80 five of 16. Each consumer warpgroup, per K/V tile:
//
//     S = Q K^T        wgmma m64n128k16, Q and K K-major from shared memory
//     online softmax   in float32 on S's accumulator registers (exp2 of
//                      scores pre-multiplied by sm_scale log2 e)
//     O += P V         wgmma m64n{hd}k16, P rounded to bf16 in registers
//                      as the A operand (S's accumulator layout is the A
//                      fragment), V read MN-major through the transpose bit
//
//   and ends with O / max(l, 1e-30), stored from registers with the rows
//   at or past S skipped. TMA fills rows past S with zeros and the kp < S
//   mask drops them. KV tiles above the diagonal, and (unless full_range)
//   those wholly below the window of the block's first query, are never
//   loaded; only the diagonal
//   tile, the tiles that cross the window's lower edge and the ragged last
//   tile are masked, each consumer warpgroup judging its own 64 rows. The
//   producer and both consumers walk the same tiles k_lo .. k_hi - 1 and
//   count the ring's stages and mbarrier phases by the iteration, not by the
//   tile index, so a window that starts past tile 0 keeps them in step. A
//   row whose first tiles are wholly masked (the second warpgroup's, below
//   its window) takes p = exp(0) = 1 on them; its first real key brings a
//   correction of exp(-1e30 - m) = 0 that wipes l and O, as in the jnp
//   online softmax, and every row meets its own key. Blocks with the most
//   KV tiles (the last query tiles) are launched first, and the G query heads
//   of a KV head are neighbours in the grid, so they read K/V from L2.
//   Without split-KV or atomics the result repeats bit for bit.
//
//   Within a warpgroup the two products and the softmax run one after the
//   other; only the two warpgroups overlap each other. Registers set that:
//   ptxas fixes 168 a thread at entry (65,536 / 384) and, with setmaxnreg in
//   the code, still keeps the consumers' code within them, so S (64), O (64)
//   and P (32) cannot all be live at once as FA3's overlaps need. The first
//   k16 step of S writes its accumulators without reading them (mma_first):
//   with "+f" the last tile's scores stay live across P V, and ptxas then
//   serializes the wgmma chain at hd = 128 (ptxas C7512).
//
//   Numerics: P is rounded to bf16 before P V, as in every tensor-core
//   flash kernel; the TPU reference computes p v in float32
//   (flash_attn.py:75). Against the float32 plain version it holds atol 3e-2.
//   The softcap is taken with tanhf (CUDA's float32 tanh, within 2 ulp), not
//   tanh.approx.f32 (relative error 2^-11: at a cap of 50 up to 0.02 on a
//   capped score), on the accumulator of Q K^T: x = cap log2 e *
//   tanhf(s sm_scale / cap), then the mask.
//
// float32: flash_fwd_f32, on the CUDA cores (TF32 would miss the 1e-5 that
//   the float32 callers hold). One block per (query tile, b, kv head),
//   holding the 64 / G query positions of all G heads of one KV head, float32
//   tiles in shared memory, 256 threads in 16 row groups of 4 rows by 16
//   column lanes, the online softmax in registers, row reductions by warp
//   shuffles, causal tiles and tiles below the window skipped, ragged S by
//   bounds checks.
//
// What bounds it: at the serve shape (B 4, S 2048, KV 8, G 5, hd 128, bf16,
// causal) the work is 1.72e11 FLOP; at 989 TFLOP/s that takes 0.174 ms, and
// its 201 MB of traffic 0.060 ms, so operations bound it: the bf16 kernel's
// design is about keeping the tensor cores fed. A window of W keys cuts the
// work to about 4 S W hd FLOP a head (gemma3-27b's local layers: W = 1,024 of
// S = 2,048).
//
// Log-sum-exp: given a non-null lse pointer (float32, laid out (B, KV, G, S)),
// each kernel also writes every query row's m + log(l), the log of the sum
// of the exponentials of the row's scaled scores, in natural-log units, which
// is what a backward pass recomputes the probabilities from. m and l are the
// row's running maximum and sum, which the online softmax holds anyway at the
// end of the row, so this costs one float a row. Rows at or past S write
// nothing. A null pointer writes nothing and leaves the kernels as they were.
//
// C interface, launched on the caller's stream; returns cudaGetLastError().
// The tensor maps are encoded on the host through the runtime's driver entry
// point, so the library needs no link against libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel.

constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kRows = 64;      // query rows (position, group) per block
constexpr int kRowsPerThread = kRows / 16;

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

template <int HD, bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int S, int KV, int G, int causal, int window,
              int full_range, float sm_scale, float cap) {
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
  const float* qb = q + ((size_t)b * S * KV + h) * G * HD;
  const float* kb = k + ((size_t)b * S * KV + h) * HD;
  const float* vb = v + ((size_t)b * S * KV + h) * HD;
  float* ob = out + ((size_t)b * S * KV + h) * G * HD;

  // Q tile: row r is (position q0 + r / G, group r % G), scaled in float32.
  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int pos = q0 + r / G;
    float x = 0.f;
    if (r < rows && pos < S) x = qb[(size_t)pos * q_tok + (r % G) * HD + d] * sm_scale;
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
  // Skip tiles wholly below the window of the tile's first query, unless
  // the launch is full-range.
  const int t_lo = window > 0 && !full_range ? max(0, q0 - window + 1) / BK : 0;

  for (int t = t_lo; t < nk; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the last tile's readers are done (and Q is stored)
    for (int i = tid; i < BK * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      const int pos = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (pos < S) {
        const size_t off = (size_t)pos * kv_tok + d;
        kx = kb[off];
        vx = vb[off];
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

    // Cap, mask, then the online-softmax update; p goes to shared memory.
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        if (kCap) s[i][j] = cap * tanhf(s[i][j] / cap);
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < S && (!causal || kp <= qpos[i]) &&
                        (window <= 0 || qpos[i] - kp < window);
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
    float* o = ob + (size_t)qpos[i] * q_tok + (r % G) * HD;
#pragma unroll
    for (int j = 0; j < OPT; ++j) o[tx + 16 * j] = acc[i][j] / denom;
    // m and l are the same in the row's 16 lanes (the shuffles above).
    if (lse != nullptr && tx == 0)
      lse[((size_t)blockIdx.y * G + r % G) * S + qpos[i]] = m[i] + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the wgmma + TMA kernel.

constexpr int kBQ = 128;      // query positions per block: two warpgroups of 64
constexpr int kBK = 128;      // key positions per K/V tile
constexpr int kStages = 2;    // K/V ring
constexpr int kConsumers = 256;
constexpr int kThreadsBf16 = kConsumers + 128;  // + the producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the barrier's phase of the given parity has completed. A wait
// that cannot end (a lost arrival) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1ll << 28)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers written by an asynchronous wgmma: keep the compiler from moving
// their reads above the wait, or their writes below the next issue.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared-memory matrix descriptor: start, leading and stride byte offsets in
// 16-byte units, and the swizzle (1: 128 B, 2: 64 B, 3: 32 B), which equals
// the tile's row width in bytes.
template <int kSwizzleBytes>
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t layout = kSwizzleBytes == 128 ? 1 : kSwizzleBytes == 64 ? 2 : 3;
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// S += A B for A (64 x 16) and B (16 x N) both K-major in shared memory.
template <int N> struct WgmmaSS;
// D += A B for A (64 x 16) in registers and B (16 x N) MN-major in shared memory.
template <int N> struct WgmmaRS;
template <> struct WgmmaSS<128> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
  }
  // The first k16 step: D = A B, D written only.
  static __device__ __forceinline__ void mma_first(float* d, uint64_t da, uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
  }
};
template <> struct WgmmaRS<16> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};
template <> struct WgmmaRS<32> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};
template <> struct WgmmaRS<64> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};
template <> struct WgmmaRS<80> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};
template <> struct WgmmaRS<128> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <int HD>
struct Bf16Tile {
  // Columns per TMA box: the widest swizzle span (64, 32 or 16 columns) that
  // divides hd, so that the boxes cover the row exactly (hd = 80: 5 x 16).
  static constexpr int kBoxCols = HD % 64 == 0 ? 64 : HD % 32 == 0 ? 32 : 16;
  static_assert(HD % kBoxCols == 0 && HD % 16 == 0, "boxes must cover the head");
  static constexpr int kRowBytes = kBoxCols * 2;       // = the swizzle span
  static constexpr int kBoxes = HD / kBoxCols;
  static constexpr int kStepsPerBox = kRowBytes / 32;  // k16 steps along hd
  static constexpr uint32_t kQBytes = kBQ * HD * 2;
  static constexpr uint32_t kKVBytes = kBK * HD * 2;  // one of K or V
  static constexpr size_t kSmem = 1024 /* alignment */ + kQBytes + 2 * kStages * kKVBytes +
                                  (2 * kStages + 1) * sizeof(uint64_t);
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;

  // K-major operand (Q or K): rows `row0..` of a tile of `rows` rows, k16 step kk.
  static __device__ __forceinline__ uint64_t k_major(const uint8_t* tile, int rows, int row0,
                                                     int kk) {
    const uint8_t* p = tile + (kk / kStepsPerBox) * rows * kRowBytes + row0 * kRowBytes +
                       (kk % kStepsPerBox) * 32;
    return smem_desc<kRowBytes>(p, 16, 8 * kRowBytes);
  }
  // MN-major operand (V): key rows 16 kk .. 16 kk + 15, all hd columns. The
  // leading offset is the step from one swizzle atom of columns (one box) to
  // the next, kBK rows apart; the stride offset that from 8 key rows to the
  // next.
  static __device__ __forceinline__ uint64_t mn_major(const uint8_t* tile, int kk) {
    return smem_desc<kRowBytes>(tile + kk * 16 * kRowBytes, kBK * kRowBytes, 8 * kRowBytes);
  }
};

// scale_log2 = sm_scale log2 e; with kCap, cap_log2 = cap log2 e and
// scale_over_cap = sm_scale / cap.
template <int HD, bool kCap>
__global__ void __launch_bounds__(kThreadsBf16, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
               float* __restrict__ lse, int S, int H, int G, int causal, int window,
               int full_range, float scale_log2, float cap_log2, float scale_over_cap) {
  using L = Bf16Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = base;
  uint8_t* sK = sQ + L::kQBytes;
  uint8_t* sV = sK + kStages * L::kKVBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + kStages * L::kKVBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int head = blockIdx.x % H;  // = kv head * G + g
  const int kvh = head / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest causal tiles first
  const int q_last = min(q0 + kBQ, S) - 1;
  // K/V tiles k_lo .. k_hi - 1: none above the diagonal and, unless the
  // launch is full-range, none wholly below the window of the block's first
  // query (q0 - window + 1 is its first key).
  const int k_hi = causal ? q_last / kBK + 1 : (S + kBK - 1) / kBK;
  const int k_lo = window > 0 && !full_range ? max(0, q0 - window + 1) / kBK : 0;
  const int n_tiles = k_hi - k_lo;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The two roles never meet again (setmaxnreg needs paths that do not
  // reconverge), and ptxas fixes the registers at entry at 168 (65,536 / 384),
  // so 128 x (168 - 24) given up cover 256 x (240 - 168) asked for.
  if (tid >= kConsumers) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load_4d(sQ + c * kBQ * L::kRowBytes, &q_map, q_full, c * L::kBoxCols, head, q0, b);
      // Stage and phase by the iteration i, as the consumers count them.
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const int k0 = (k_lo + i) * kBK;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * L::kKVBytes);
        uint8_t* kt = sK + s * L::kKVBytes;
        uint8_t* vt = sV + s * L::kKVBytes;
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load_4d(kt + c * kBK * L::kRowBytes, &k_map, &full[s], c * L::kBoxCols, kvh, k0,
                      b);
          tma_load_4d(vt + c * kBK * L::kRowBytes, &v_map, &full[s], c * L::kBoxCols, kvh, k0,
                      b);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows q0 + 64 wg .. q0 + 64 wg + 63.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;  // and row0 + 8
  const int col0 = 2 * (lane % 4);                        // + 8 c + {0, 1}

  float o[HD / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) o[j] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // The keys each of this thread's two rows sees, kp_min .. kp_max: the
  // mask as two compares a score, whatever of S, causal and the window is in
  // play (tested per score, the window's term cost the windowless launches
  // ~4 %, scripts/flash_ab.py).
  int kp_min[2], kp_max[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = row0 + 8 * i;
    kp_max[i] = causal ? min(qp, S - 1) : S - 1;
    kp_min[i] = window > 0 ? qp - window + 1 : 0;
  }

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int k0 = (k_lo + i) * kBK;
    mbar_wait(&full[s], (i / kStages) & 1);
    const uint8_t* kt = sK + s * L::kKVBytes;
    const uint8_t* vt = sV + s * L::kKVBytes;

    float sc[kBK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint64_t dq = L::k_major(sQ, kBQ, wg * 64, kk), dk = L::k_major(kt, kBK, 0, kk);
      if (kk == 0)
        WgmmaSS<kBK>::mma_first(sc, dq, dk);
      else
        WgmmaSS<kBK>::mma(sc, dq, dk, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kBK / 2>(sc);

    // Scale (and cap) into the log2 domain; mask only the diagonal, ragged
    // and window edge tiles of this warpgroup's rows r_lo .. r_lo + 63 (a
    // full-range launch's tiles below the window are edge tiles too).
    const int r_lo = q0 + wg * 64;
    const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > r_lo) ||
                      (window > 0 && r_lo + 63 - k0 >= window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      float x = kCap ? cap_log2 * tanhf(sc[j] * scale_over_cap) : sc[j] * scale_log2;
      if (edge) {
        const int kp = k0 + 8 * (j / 4) + col0 + (j & 1);
        if (kp > kp_max[(j >> 1) & 1] || kp < kp_min[(j >> 1) & 1]) x = kNegInf;
      }
      sc[j] = x;
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], x);
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= corr[i];  // this thread's share of the row sum; the quad adds up at the end
    }
    // P in bf16, laid out as the A fragments of the k16 steps over the tile.
    uint32_t p[kBK / 4];
#pragma unroll
    for (int c = 0; c < kBK / 16; ++c) {
      float e[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) e[u] = exp2f(sc[8 * c + u] - m[(u >> 1) & 1]);
      l[0] += (e[0] + e[1]) + (e[4] + e[5]);
      l[1] += (e[2] + e[3]) + (e[6] + e[7]);
      p[4 * c + 0] = pack_bf16(e[0], e[1]);
      p[4 * c + 1] = pack_bf16(e[2], e[3]);
      p[4 * c + 2] = pack_bf16(e[4], e[5]);
      p[4 * c + 3] = pack_bf16(e[6], e[7]);
    }
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) o[j] *= corr[(j >> 1) & 1];

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      WgmmaRS<HD>::mma(o, &p[4 * kk], L::mn_major(vt, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<HD / 2>(o);
    mbar_arrive(&empty[s]);  // this thread is done with stage s
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = row0 + 8 * i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    // m is in log2 units of the scaled scores (exp2 above): back to natural.
    if (lse != nullptr && lane % 4 == 0)
      lse[((size_t)b * H + head) * S + qp] = m[i] * kLn2 + logf(denom);
    __nv_bfloat16* orow = out + ((size_t)(b * S + qp) * H + head) * HD + col0;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const float lo = o[4 * c + 2 * i] / denom, hi = o[4 * c + 2 * i + 1] / denom;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) = __floats2bfloat162_rn(lo, hi);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A rank-4 map (hd, heads, S, B) over a contiguous bf16 tensor, boxes of
// (box_cols, 1, box_rows, 1).
bool encode_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, int hd, int heads,
                int S, int B, int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool kCap>
int launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                int S, int KV, int G, int causal, int window, int full_range, float sm_scale,
                float cap, cudaStream_t stream) {
  using L = Bf16Tile<HD>;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_map(encode, &q_map, q, HD, KV * G, S, B, L::kBoxCols, kBQ, L::kSwizzle) ||
      !encode_map(encode, &k_map, k, HD, KV, S, B, L::kBoxCols, kBK, L::kSwizzle) ||
      !encode_map(encode, &v_map, v, HD, KV, S, B, L::kBoxCols, kBK, L::kSwizzle))
    return (int)cudaErrorInvalidValue;
  // setmaxnreg only moves registers within the block's pool: refuse to
  // launch (rather than hang) if the build left the pool smaller than the
  // 24 + 240 split needs.
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, flash_fwd_bf16<HD, kCap>);
  if (err != cudaSuccess) return (int)err;
  if (attr.numRegs * kThreadsBf16 < 128 * 24 + kConsumers * 240)
    return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(flash_fwd_bf16<HD, kCap>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * KV * G, (S + kBQ - 1) / kBQ);
  flash_fwd_bf16<HD, kCap><<<grid, kThreadsBf16, L::kSmem, stream>>>(
      q_map, k_map, v_map, (__nv_bfloat16*)out, lse, S, KV * G, G, causal, window,
      full_range, sm_scale * kLog2e, kCap ? cap * kLog2e : 0.f, kCap ? sm_scale / cap : 0.f);
  return (int)cudaGetLastError();
}

template <int HD, bool kCap>
int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int B,
               int S, int KV, int G, int causal, int window, int full_range, float sm_scale,
               float cap, cudaStream_t stream) {
  const size_t smem = Tile<HD>::bytes;
  if (B * KV > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<HD, kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int bq = kRows / G;
  const dim3 grid((S + bq - 1) / bq, B * KV);
  flash_fwd_f32<HD, kCap><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, lse, S, KV, G, causal,
      window, full_range, sm_scale, cap);
  return (int)cudaGetLastError();
}

template <int HD, bool kCap>
int launch_typed(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                 int S, int KV, int G, int dtype, int causal, int window, int full_range,
                 float sm_scale, float cap, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<HD, kCap>(q, k, v, out, lse, B, S, KV, G, causal, window, full_range,
                                sm_scale, cap, stream);
  if (dtype == 1)
    return launch_bf16<HD, kCap>(q, k, v, out, lse, B, S, KV, G, causal, window, full_range,
                                 sm_scale, cap, stream);
  return (int)cudaErrorInvalidValue;
}

// softcap 0: none (the capless instantiations).
template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int S,
           int KV, int G, int dtype, int causal, int window, int full_range, float sm_scale,
           float softcap, cudaStream_t stream) {
  if (softcap > 0.f)
    return launch_typed<HD, true>(q, k, v, out, lse, B, S, KV, G, dtype, causal, window,
                                  full_range, sm_scale, softcap, stream);
  return launch_typed<HD, false>(q, k, v, out, lse, B, S, KV, G, dtype, causal, window,
                                 full_range, sm_scale, 0.f, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32 (CUDA-core kernel), 1 bfloat16 (wgmma + TMA kernel). window:
// 0 for none, else query s sees key t only if s - t < window; full_range 1
// loads the tiles below the window too (the mask alone applies it). softcap:
// 0 for none, else scores s become softcap * tanh(s / softcap). lse may be
// null (no log-sum-exp written). The wrapper checks every argument first.
int flash_attn_launch(const void* q, const void* k, const void* v, void* out, void* lse,
                      int B, int S, int KV, int G, int hd, int dtype, int causal, int window,
                      int full_range, float sm_scale, float softcap, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || G < 1 || G > kRows || window < 0 || !(softcap >= 0.f))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* f = (float*)lse;
  const int c = causal, w = window, fr = full_range;
  const float sc = sm_scale, cap = softcap;
  switch (hd) {
    case 16: return launch<16>(q, k, v, out, f, B, S, KV, G, dtype, c, w, fr, sc, cap, st);
    case 32: return launch<32>(q, k, v, out, f, B, S, KV, G, dtype, c, w, fr, sc, cap, st);
    case 64: return launch<64>(q, k, v, out, f, B, S, KV, G, dtype, c, w, fr, sc, cap, st);
    case 80: return launch<80>(q, k, v, out, f, B, S, KV, G, dtype, c, w, fr, sc, cap, st);
    case 128: return launch<128>(q, k, v, out, f, B, S, KV, G, dtype, c, w, fr, sc, cap, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
