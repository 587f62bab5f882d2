// Worker SDCA inner loop (Algorithm 2, line 4) for Hopper: ridge, smoothed
// hinge and logistic loss.
//
// Replaces the TPU kernel src/repro/kernels/sdca_inner.py::sdca_inner_pallas
// (body _sdca_kernel), which computes one SDCA epoch per worker, H
// sequential steps
//
//     i      = idx[k, h]                    (steps with i outside [0, n_k) skipped)
//     z      = w_eff . x_i + sigma' (v . x_i)
//     delta  = delta_loss(alpha_i + dalpha_i, z, y_i, sigma' ||x_i||^2 / (lambda n))
//     dalpha[i] += delta ;  v += delta / (lambda n) * x_i
//
// with delta_loss the coordinate maximiser of src/repro/core/sdca.py
// (_coordinate_delta), written here operation for operation in torch's
// order and roundings (every product and sum an explicit _rn intrinsic, so
// nvcc contracts nothing into an FMA; log1pf and logf, not __logf).
//
// What bounds it: the H steps are a serial chain. Each step reads one row
// (d * 4 bytes, 189 KB at RCV1's d = 47,236), so the bytes alone would take
// H * 189 KB / 3.35 TB/s; but the chain's latency (the dot products, their
// reduction across SMs, delta) sets the time, not the card's bandwidth.
//
// Design: one thread-block cluster of C CTAs per worker (C up to 16, chosen
// on the host from the device, K and d). CTA r owns one contiguous slice of
// d (chunk floats, a multiple of 4). Each CTA has three roles:
//  - 8 vector warps. Thread t owns the elements 4 (t + 256 g) + u (u < 4,
//    g < M / 4) and keeps them of w_eff, of v and of the last two rows in
//    registers for the whole epoch, so w_eff is read from device memory once
//    and each row slice once from shared memory.
//  - 1 producer warp. The visit order is known at launch, so the rows are off
//    the chain: it keeps a ring of S row slices in shared memory filled
//    ahead, the 16-byte-aligned body of each by one TMA bulk copy, the
//    ragged head and tail (up to 3 floats each, so any d works) and the
//    step's scalars by 4-byte cp.async, all completing on the slot's "full"
//    mbarrier; it refills a slot once its "empty" mbarrier says that both
//    readers are done. It drops the steps whose index lies outside [0, n_k),
//    so the others see only steps that run.
//  - 1 scalar warp: delta, and the CTA's copy of dalpha (n_k floats in shared
//    memory; rank 0 writes it out at the end).
// With c_s = delta_s / (lambda n) and v^(s) the sum over r < s of c_r x_r,
// step s needs z_s = w.x_s + sigma' v^(s).x_s, and
//     v^(s).x_s = v^(s-1).x_s + c_{s-1} (x_{s-1}.x_s).
// So the vector warps compute step s's partials from c_{s-2} alone: they add
// c_{s-2} x_{s-2} to v (making v^(s-1)) and take w.x_s, v^(s-1).x_s and
// x_{s-1}.x_s in one pass over their elements; each warp sums its three over
// its lanes and sends them by st.async to slot [s % 4][rank * 8 + warp] of
// every CTA of the cluster, whose bytes complete on that CTA's mbarrier for
// the slot. The scalar warp waits for the C * 8 partials, sums them in a fixed
// order (so there are no atomics and a run repeats bit for bit), adds
// c_{s-1} times the last, computes delta_s by the loss and hands c_s to the
// vector warps through a named barrier. Step s + 1's partials are thus
// computed and exchanged while delta_s is computed: one step's exchange and
// the previous step's delta overlap, and there is no cluster-wide barrier.
// Four exchange slots suffice: a CTA sends into slot s % 4 again at step
// s + 4 only after its c_{s+2}, which needs every CTA's step s + 2 partials;
// a CTA sends those only after its c_s, and its scalar warp publishes c_s
// after it has read slot s % 4 and re-armed its mbarrier (bytes that arrive
// early only run the transaction count below zero).
//
// Worker map: a launch of B clusters may take an int32 map workers[B];
// cluster b then reads the rows of X, alpha, y and norms of worker
// workers[b] and takes w_eff, idx, dalpha and v at row b. Without the map
// (nullptr) cluster b is worker b. A group of workers that all solve
// against their own fixed rows thus runs in one launch without copying its
// rows of X. The map may be device data that the host never saw (a device
// sort's arrival order): a cluster whose entry lies outside [0, K) writes
// nothing and records itself in the error word map_error[2] = {1 + b, entry}
// (the first such cluster wins), which the caller reads with its results.
// Two more options let a launch run several independent problems over one
// shared X (the variants of a sweep): alpha_rows reads alpha at batch row b
// (alpha is then (B, n_k)), not at the worker, and sigma_rows, when given,
// is sigma' for each batch row.
//
// C interface, launched on the caller's stream; every entry returns a
// cudaError_t (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;            // the vector warps
constexpr int kWarps = kThreads / 32;
constexpr int kScalarWarp = kWarps;      // delta and dalpha
constexpr int kProducerWarp = kWarps + 1;  // the ring
constexpr int kBlock = kThreads + 64;
constexpr int kXch = 4;                  // exchange slots
constexpr int kMaxCluster = 16;
constexpr int kMaxStages = 8;  // ring slots
constexpr int kMinStages = 4;  // ring slots: rows a few steps ahead
constexpr int kMinSlice = 32;  // a CTA's slice holds at least one warp's worth
constexpr int kPerThread[] = {12, 24};  // instances by elements a thread (M)
constexpr int kCopyLanes = 9;  // lanes 1-9 of the producer: head, tail, scalars
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStaticSmem = kXch * kMaxCluster * kWarps * (int)sizeof(float4) +
                            (2 * kMaxStages + kXch) * (int)sizeof(uint64_t) +
                            2 * (int)sizeof(float);

enum Loss { kRidge = 0, kSmoothedHinge = 1, kLogistic = 2 };

// src/repro/core/objectives.py::_HINGE_SMOOTHING and the logistic clip.
constexpr float kHingeSmoothing = 1.0f;
constexpr float kEps = 1e-6f;
constexpr float kOneMinusEps = (float)(1.0 - 1e-6);

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// _coordinate_delta, in torch's order of operations.
template <int L>
__device__ __forceinline__ float coordinate_delta(float a, float z, float y, float q) {
  if constexpr (L == kRidge) {
    return __fdiv_rn(__fsub_rn(__fsub_rn(y, a), z), __fadd_rn(1.0f, q));
  } else if constexpr (L == kSmoothedHinge) {
    const float a_y = __fmul_rn(y, a);
    const float num = __fadd_rn(__fsub_rn(1.0f, __fmul_rn(y, z)), __fmul_rn(q, a_y));
    const float b = clampf(__fdiv_rn(num, __fadd_rn(kHingeSmoothing, q)), 0.0f, 1.0f);
    return __fmul_rn(y, __fsub_rn(b, a_y));
  } else {
    const float a_y = clampf(__fmul_rn(y, a), kEps, kOneMinusEps);
    const float yz = __fmul_rn(y, z);
    float b = a_y;
#pragma unroll 1
    for (int t = 0; t < 8; ++t) {
      const float fp = __fsub_rn(__fsub_rn(__fsub_rn(log1pf(-b), logf(b)), yz),
                                 __fmul_rn(q, __fsub_rn(b, a_y)));
      // -1.0 / t is torch's reciprocal(t) * -1.0.
      const float fpp = __fsub_rn(-__fdiv_rn(1.0f, __fmul_rn(b, __fsub_rn(1.0f, b))), q);
      b = clampf(__fsub_rn(b, __fdiv_rn(fp, fpp)), kEps, kOneMinusEps);
    }
    return __fmul_rn(y, __fsub_rn(b, a_y));
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}

// The barrier receives one arrival once this thread's earlier cp.async land.
__device__ __forceinline__ void cp_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Waits until the barrier's phase of the given parity has completed. A wait
// that cannot end (a lost arrival) traps after about 10 s instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > 20000000000ll) __trap();
  }
}

__device__ __forceinline__ void cluster_barrier() {
  __syncwarp();  // .aligned: the whole warp arrives together
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of p in the shared memory of the cluster's CTA of that rank.
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}

// Store v at a cluster address; its 16 bytes complete on the barrier at bar
// (a cluster address in the same CTA).
__device__ __forceinline__ void st_async(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar) : "memory");
}

// Floats between src and the 16-byte boundary at or below it: slice element
// j is stored at slot[misalign + j], so 16-byte-aligned global addresses
// land on 16-byte-aligned shared ones.
__device__ __forceinline__ int misalign(const float* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

// Per-step scalars of a ring slot: alpha_i, y_i, ||x_i||^2 and i (kEnd after
// the last step).
struct __align__(16) StepScalars {
  float alpha, y, norm;
  int i;
};
constexpr int kEnd = -1;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Named barrier 1 + (s & 1) hands c_s from the scalar warp (which arrives)
// to the vector warps (which wait).
constexpr int kBarStep = 1;
constexpr int kBarStepCount = kThreads + 32;

template <int L, int M>
__global__ void __launch_bounds__(kBlock, 1)
sdca_cluster_kernel(const float* __restrict__ w_eff, const float* __restrict__ alpha,
                    const float* __restrict__ X, const float* __restrict__ y,
                    const float* __restrict__ norms, const int32_t* __restrict__ idx,
                    const int32_t* __restrict__ workers, int K, int alpha_rows,
                    const float* __restrict__ sigma_rows, int* __restrict__ map_error,
                    float* __restrict__ dalpha, float* __restrict__ v_out, int n_k,
                    int d, int H, int chunk, int stages, float lam_n, float sigma_arg) {
  extern __shared__ __align__(16) float smem[];
  // A step's partials (w.x, v.x, x'.x) from each vector warp of each CTA of
  // the cluster, at [rank * kWarps + warp].
  __shared__ float4 xch[kXch][kMaxCluster * kWarps];
  __shared__ uint64_t full[kMaxStages];      // a ring slot has landed
  __shared__ uint64_t empty[kMaxStages];     // a ring slot has been read
  __shared__ uint64_t xbar[kXch];            // one per exchange slot
  __shared__ float c_s[2];                   // delta / (lambda n) of a step, by parity

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;                 // the batch row: w_eff, idx, outputs
  const int k = workers ? workers[b] : b;       // its worker: X, y, norms (and alpha)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if ((unsigned)k >= (unsigned)K) {  // a bad map entry: the whole cluster leaves
    if (map_error != nullptr && rank == 0 && tid == 0 && atomicCAS(map_error, 0, b + 1) == 0)
      atomicExch(map_error + 1, k);
    return;
  }
  const float sigma_p = sigma_rows ? sigma_rows[b] : sigma_arg;
  const int lo = rank * chunk;
  const int len = max(0, min(chunk, d - lo));
  // A slot holds the slice shifted by misalign() and room for every thread's
  // M elements. The slots start zeroed, and each issue zeroes the 3 floats
  // past its slice, the most an unaligned row can write past len, so every
  // element past len reads 0 and needs no mask.
  constexpr int pitch = M * kThreads + 8;
  constexpr int G = M / 4;  // vector thread t owns elements 4 (t + 256 g) + u, u < 4

  float* ring = smem;                                                         // stages * pitch
  StepScalars* scal = reinterpret_cast<StepScalars*>(ring + stages * pitch);  // stages
  float* da_s = reinterpret_cast<float*>(scal + stages);                      // n_k

  const float* Xk = X + (size_t)k * n_k * d + lo;
  const float* alpha_k = alpha + (size_t)(alpha_rows ? b : k) * n_k;
  const float* y_k = y + (size_t)k * n_k;
  const float* norms_k = norms + (size_t)k * n_k;
  const int32_t* idx_k = idx + (size_t)b * H;

  // The producer warp fills the ring with the steps whose index lies in
  // [0, n_k), in order, then one kEnd item. Item t goes to slot t % stages:
  // lane 0 copies the row's 16-byte-aligned body by TMA, lanes 1-9 the head,
  // the tail and the scalars by cp.async; the slot's barrier completes when
  // all have landed. cand is idx[pos], loaded one issue ahead.
  int item = 0, pos = 0, cand = 0;
  bool ended = false;
  auto issue = [&]() {
    if (ended) return;
    while (pos < H && (unsigned)cand >= (unsigned)n_k) cand = ++pos < H ? idx_k[pos] : 0;
    const int i = pos < H ? cand : kEnd;
    ended = i == kEnd;
    const int slot = item++ % stages;
    const float* row = Xk + (size_t)(ended ? 0 : i) * d;
    const int off = misalign(row);
    const int head = min((4 - off) & 3, len);
    const int nvec = (len - head) >> 2;
    const int tail = len - head - 4 * nvec;
    float* dst = ring + slot * pitch + off;
    if (lane == 0) {
      scal[slot].i = i;
      dst[len] = dst[len + 1] = dst[len + 2] = 0.f;
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // before any TMA here
      const uint32_t bytes = ended ? 0u : 16u * nvec;
      mbar_expect_tx(&full[slot], bytes);
      if (bytes) bulk_copy(dst + head, row + head, bytes, &full[slot]);
    } else if (lane <= kCopyLanes) {
      const int t = lane - 1;
      if (!ended) {
        if (t < 3) {
          if (t < head) cp4(dst + t, row + t);
        } else if (t < 6) {
          const int j = head + 4 * nvec + (t - 3);
          if (t - 3 < tail) cp4(dst + j, row + j);
        } else {
          const float* src = t == 6 ? alpha_k : t == 7 ? y_k : norms_k;
          cp4(&(&scal[slot].alpha)[t - 6], src + i);
        }
      }
      cp_arrive(&full[slot]);
    }
    ++pos;
    cand = pos < H ? idx_k[pos] : 0;
  };

  for (int j = tid; j < n_k; j += kBlock) da_s[j] = 0.f;
  for (int j = tid; j < stages * pitch; j += kBlock) ring[j] = 0.f;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1 + kCopyLanes);
      mbar_init(&empty[s], kWarps + 1);  // the vector warps and the scalar warp
    }
    for (int s = 0; s < kXch; ++s) {
      mbar_init(&xbar[s], 1);
      mbar_expect_tx(&xbar[s], C * kWarps * sizeof(float4));  // steps 0 to kXch - 1
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The zeroed ring before the async proxy writes it.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  cluster.sync();  // every CTA has started and armed its barriers

  // Step s needs z_s = w.x_s + sigma' v^(s).x_s, where v^(s) = sum over r < s
  // of c_r x_r. The vector warps compute step s's partials before c_{s-1} is
  // known, from v^(s-1) = v^(s-2) + c_{s-2} x_{s-2}:
  //     v^(s).x_s = v^(s-1).x_s + c_{s-1} (x_{s-1}.x_s),
  // so they send (w.x_s, v^(s-1).x_s, x_{s-1}.x_s) and the scalar warp adds
  // c_{s-1} times the last. Step s's exchange and reductions then run while
  // the scalar warp computes delta_{s-1}.
  float w_r[M], v_r[M], x1_r[M], x2_r[M];  // x1 = x_{s-1}, x2 = x_{s-2}
  if (warp < kWarps) {
    // -- the vector warps ------------------------------------------------------
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * (tid + g * kThreads) + u;
        w_r[4 * g + u] = j < len ? w_eff[(size_t)b * d + lo + j] : 0.f;
        v_r[4 * g + u] = x1_r[4 * g + u] = x2_r[4 * g + u] = 0.f;
      }
    int slot = 0, s = 0;
    uint32_t phase = 0;
    for (;; ++s) {
      mbar_wait(&full[slot], phase);
      const int i = scal[slot].i;
      if (i == kEnd) break;
      float c = 0.f;  // c_{s-2}
      if (s >= 2) {
        bar_sync(kBarStep + (s & 1), kBarStepCount);
        c = c_s[s & 1];
      }
      const int off = misalign(Xk + (size_t)i * d);
      const float* x = ring + slot * pitch + off;
      if (++slot == stages) {
        slot = 0;
        phase ^= 1u;
      }
      float a2[2] = {0.f, 0.f}, b2[2] = {0.f, 0.f}, g2[2] = {0.f, 0.f};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int e0 = 4 * (tid + g * kThreads);
        const float4 xv = off == 0 ? *reinterpret_cast<const float4*>(x + e0)
                                   : make_float4(x[e0], x[e0 + 1], x[e0 + 2], x[e0 + 3]);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int m = 4 * g + u;
          v_r[m] = __fadd_rn(v_r[m], __fmul_rn(c, x2_r[m]));  // v^(s-1)
          a2[g & 1] = fmaf(w_r[m], xs[u], a2[g & 1]);
          b2[g & 1] = fmaf(v_r[m], xs[u], b2[g & 1]);
          g2[g & 1] = fmaf(x1_r[m], xs[u], g2[g & 1]);
          x2_r[m] = x1_r[m];
          x1_r[m] = xs[u];
        }
      }
      if (lane == 0) mbar_arrive(&empty[(slot + stages - 1) % stages]);  // step s's slot
      float a = a2[0] + a2[1], b = b2[0] + b2[1], gg = g2[0] + g2[1];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {  // xor butterfly: every lane holds the sums
        a += __shfl_xor_sync(kFull, a, o);
        b += __shfl_xor_sync(kFull, b, o);
        gg += __shfl_xor_sync(kFull, gg, o);
      }
      // Each warp sends its partials to every CTA of the cluster itself: no
      // block barrier and no second reduction on the vector warps' path.
      if (lane < C)
        st_async(map_rank(&xch[s % kXch][rank * kWarps + warp], lane),
                 make_float4(a, b, gg, 0.f), map_rank(&xbar[s % kXch], lane));
    }
    // The updates of the last two steps: v^(S) = v^(S-2) + c_{S-2} x_{S-2}
    // + c_{S-1} x_{S-1}. Step r < 0 does not exist, but its shift of the
    // rows still runs: with S = 1, x2 holds x_{-1} = 0 and x1 holds x_0.
    for (int r = s - 2; r < s; ++r) {
      if (r >= 0) {
        bar_sync(kBarStep + (r & 1), kBarStepCount);
        const float c = c_s[r & 1];
#pragma unroll
        for (int m = 0; m < M; ++m) v_r[m] = __fadd_rn(v_r[m], __fmul_rn(c, x2_r[m]));
      }
#pragma unroll
      for (int m = 0; m < M; ++m) x2_r[m] = x1_r[m];
    }
  } else if (warp == kScalarWarp) {
    // -- the scalar warp: delta and dalpha -------------------------------------
    int slot = 0;
    uint32_t phase = 0;
    float c_prev = 0.f;  // c_{s-1}
    for (int s = 0;; ++s) {
      mbar_wait(&full[slot], phase);
      const StepScalars sc = scal[slot];
      if (sc.i == kEnd) break;
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (++slot == stages) {
        slot = 0;
        phase ^= 1u;
      }
      const float q = __fdiv_rn(__fmul_rn(sigma_p, sc.norm), lam_n);
      const float da_i = da_s[sc.i];
      mbar_wait(&xbar[s % kXch], (s / kXch) & 1);
      // The C * 8 partials in a fixed order: lane l takes entries l, l + 32,
      // ..., then the warp's xor butterfly, so every lane holds the same sums.
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = lane; r < C * kWarps; r += 32) {
        const float4 p = xch[s % kXch][r];
        t.x += p.x;
        t.y += p.y;
        t.z += p.z;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        t.x += __shfl_xor_sync(kFull, t.x, o);
        t.y += __shfl_xor_sync(kFull, t.y, o);
        t.z += __shfl_xor_sync(kFull, t.z, o);
      }
      __syncwarp();  // every lane has read the slot before it is re-armed
      if (lane == 0) mbar_expect_tx(&xbar[s % kXch], C * kWarps * sizeof(float4));  // s + kXch
      const float vx = __fadd_rn(t.y, __fmul_rn(c_prev, t.z));  // v^(s).x_s
      const float z = __fadd_rn(t.x, __fmul_rn(sigma_p, vx));
      const float delta = coordinate_delta<L>(__fadd_rn(sc.alpha, da_i), z, sc.y, q);
      c_prev = __fdiv_rn(delta, lam_n);
      if (lane == 0) {
        da_s[sc.i] = __fadd_rn(da_i, delta);
        c_s[s & 1] = c_prev;
      }
      __syncwarp();  // lane 0's writes before any lane reads da_s again
      bar_arrive(kBarStep + (s & 1), kBarStepCount);
    }
  } else {
    // -- the producer warp: item t refills slot t % stages once both readers
    // of item t - stages have let it go --------------------------------------
    cand = H > 0 ? idx_k[0] : 0;
    for (int t = 0; !ended; ++t) {
      if (t >= stages) mbar_wait(&empty[t % stages], (t / stages - 1) & 1);
      issue();
    }
  }
  cluster.sync();  // no CTA exits while another may still write to it
  if (warp < kWarps) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * (tid + g * kThreads) + u;
        if (j < len) v_out[(size_t)b * d + lo + j] = v_r[4 * g + u];
      }
  }
  if (rank == 0)
    for (int j = tid; j < n_k; j += kBlock) dalpha[(size_t)b * n_k + j] = da_s[j];
}

// The serial floor: H round trips of the kernel's exchange, each depending
// on the last, with nothing else in a step. Each of the 8 warps sends one
// float4 to every CTA of the cluster, warp 0 waits for the C * 8 of them and
// sums them as the scalar warp does, and a block barrier hands the sum on.
// kAsync is the kernel's exchange (st.async completing on the receiver's
// mbarrier); otherwise plain DSMEM stores and barrier.cluster, for
// comparison.
template <bool kAsync>
__global__ void __launch_bounds__(kThreads, 1) cluster_probe_kernel(int H, float* out) {
  __shared__ float4 xch[kXch][kMaxCluster * kWarps];
  __shared__ uint64_t xbar[kXch];
  __shared__ float acc_s;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t bytes = C * kWarps * sizeof(float4);
  if (kAsync && tid == 0) {
    for (int s = 0; s < kXch; ++s) {
      mbar_init(&xbar[s], 1);
      mbar_expect_tx(&xbar[s], bytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float acc = 0.f;
  cluster.sync();
  for (int h = 0; h < H; ++h) {
    const int x = h % kXch;
    const float4 mine = make_float4(acc, 1.f, 0.f, 0.f);
    float4* dst = &xch[x][rank * kWarps + warp];
    if (kAsync) {
      if (lane < C) st_async(map_rank(dst, lane), mine, map_rank(&xbar[x], lane));
    } else {
      if (lane < C) *cluster.map_shared_rank(dst, lane) = mine;
      cluster_barrier();
    }
    if (warp == 0) {
      if (kAsync) mbar_wait(&xbar[x], (h / kXch) & 1);
      float t = 0.f;
      for (int r = lane; r < C * kWarps; r += 32) t += xch[x][r].x + xch[x][r].y;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
      __syncwarp();
      if (kAsync && lane == 0) mbar_expect_tx(&xbar[x], bytes);
      if (lane == 0) acc_s = t * 1e-3f;
    }
    __syncthreads();
    acc = acc_s;
  }
  cluster.sync();
  if (tid == 0 && rank == 0) out[blockIdx.x / C] = acc;
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*,
                          const float*, const int32_t*, const int32_t*, int, int,
                          const float*, int*, float*, float*, int, int, int, int, int, float,
                          float);

template <int L>
KernelFn instance(int per_thread) {
  switch (per_thread) {
    case kPerThread[0]: return sdca_cluster_kernel<L, kPerThread[0]>;
    case kPerThread[1]: return sdca_cluster_kernel<L, kPerThread[1]>;
    default: return nullptr;
  }
}

KernelFn kernel_for(int loss, int per_thread) {
  switch (loss) {
    case kRidge: return instance<kRidge>(per_thread);
    case kSmoothedHinge: return instance<kSmoothedHinge>(per_thread);
    case kLogistic: return instance<kLogistic>(per_thread);
    default: return nullptr;
  }
}

int slice_floats(int d, int C) { return 4 * ((d + 4 * C - 1) / (4 * C)); }

// The smallest instance whose threads hold a slice of chunk floats; 0 if none.
int per_thread_for(int chunk) {
  for (int m : kPerThread)
    if (chunk <= m * kThreads) return m;
  return 0;
}

// Dynamic shared memory of an instance with per_thread elements a thread.
size_t smem_bytes(int per_thread, int stages, int n_k) {
  return sizeof(float) * ((size_t)stages * (per_thread * kThreads + 8) + 4 * stages +
                          (size_t)n_k);
}

int optin_smem() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin - kStaticSmem;
}

cudaLaunchConfig_t config(int K, int C, int threads, size_t smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t set_attributes_now(KernelFn fn, int C, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// The attributes a launch needs, set once for each instance, device and
// size: what set them is remembered, so a launch recorded into a CUDA graph
// (after a first launch or sdca_inner_prepare) makes no cudaFuncSetAttribute
// call while the stream is being captured.
constexpr int kMaxDevices = 16;
constexpr int kInstances = 6;  // 3 losses x 2 sizes
KernelFn set_fn[kMaxDevices][kInstances];
size_t set_smem[kMaxDevices][kInstances];
bool set_nonportable[kMaxDevices][kInstances];

cudaError_t set_attributes(KernelFn fn, int C, size_t smem) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) return set_attributes_now(fn, C, smem);
  int slot = 0;
  while (slot < kInstances && set_fn[dev][slot] != nullptr && set_fn[dev][slot] != fn) ++slot;
  if (slot == kInstances) return set_attributes_now(fn, C, smem);
  if (set_fn[dev][slot] == fn && set_smem[dev][slot] >= smem &&
      (C <= 8 || set_nonportable[dev][slot]))
    return cudaSuccess;
  const size_t want = set_fn[dev][slot] == fn && set_smem[dev][slot] > smem
                          ? set_smem[dev][slot] : smem;
  cudaError_t err = set_attributes_now(fn, C, want);
  if (err != cudaSuccess) return err;
  set_fn[dev][slot] = fn;
  set_smem[dev][slot] = want;
  set_nonportable[dev][slot] = set_nonportable[dev][slot] || C > 8;
  return cudaSuccess;
}

// Drops what set_attributes remembers of fn on the current device.
void forget_attributes(KernelFn fn) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) return;
  for (int slot = 0; slot < kInstances; ++slot)
    if (set_fn[dev][slot] == fn) {
      set_smem[dev][slot] = 0;
      set_nonportable[dev][slot] = false;
    }
}

// Clusters of C CTAs with smem bytes each that the device holds at once
// (with the attributes set to exactly these sizes, as the query needs).
cudaError_t active_clusters(KernelFn fn, int K, int C, size_t smem, int* out) {
  forget_attributes(fn);
  cudaError_t err = set_attributes_now(fn, C, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(K, C, kBlock, smem, 0, attr);
  return cudaOccupancyMaxActiveClusters(out, fn, &cfg);
}

}  // namespace

extern "C" {

// The launch plan for K workers, n_k rows each, width d: out = {C, stages,
// dynamic smem bytes, clusters resident at once, elements a thread}. C is
// the largest of 16, 8, 4, 2, 1 whose slices hold >= 32 floats (C = 1
// always qualifies), fit the registers of an instance and the shared memory
// with at least 4 ring slots, and keep all K clusters resident; if none
// keeps K resident, the one that runs them in the fewest waves of resident
// clusters, the larger on a tie. The instances differ only in code, so the
// ridge one decides. cluster > 0 asks for that C (for measurements);
// out[0] = 0 if nothing fits.
int sdca_inner_plan(int K, int n_k, int d, int cluster, int* out) {
  for (int n = 0; n < 5; ++n) out[n] = 0;
  const int avail = optin_smem();
  int best_waves = 0;
  for (int C = kMaxCluster; C >= 1; C >>= 1) {
    if (cluster > 0 && C != cluster) continue;
    if (C > 1 && d < kMinSlice * C) continue;
    const int chunk = slice_floats(d, C);
    const int per_thread = per_thread_for(chunk);
    if (per_thread == 0) continue;
    int stages = kMaxStages;
    while (stages >= kMinStages && smem_bytes(per_thread, stages, n_k) > (size_t)avail)
      --stages;
    if (stages < kMinStages) continue;
    const size_t smem = smem_bytes(per_thread, stages, n_k);
    int active = 0;
    if (active_clusters(kernel_for(kRidge, per_thread), K, C, smem, &active) != cudaSuccess) {
      cudaGetLastError();  // clear: an unsupported cluster size is not a fault
      continue;
    }
    if (active < 1) continue;
    const int waves = (K + active - 1) / active;
    if (out[0] == 0 || waves < best_waves) {
      out[0] = C;
      out[1] = stages;
      out[2] = (int)smem;
      out[3] = active;
      out[4] = per_thread;
      best_waves = waves;
    }
    if (waves == 1) break;
  }
  return 0;
}

// Largest d the kernel takes for n_k rows a worker: C times the slice of the
// largest instance whose 4 ring slots and dalpha fit one CTA's shared
// memory, for the largest C the device launches.
int sdca_inner_max_d(int n_k) {
  const int avail = optin_smem();
  for (int b = 1; b >= 0; --b) {
    const int per_thread = kPerThread[b];
    const size_t smem = smem_bytes(per_thread, kMinStages, n_k);
    if (smem > (size_t)avail) continue;
    for (int C = kMaxCluster; C >= 1; C >>= 1) {
      int active = 0;
      if (active_clusters(kernel_for(kRidge, per_thread), 1, C, smem, &active) != cudaSuccess) {
        cudaGetLastError();
        continue;
      }
      if (active >= 1) return C * per_thread * kThreads;
    }
  }
  return 0;
}

// Sets the attributes of the instance a launch of this plan uses, so that
// later launches (inside a stream capture too) set none.
int sdca_inner_prepare(int loss, int C, int stages, int per_thread, int n_k) {
  KernelFn fn = kernel_for(loss, per_thread);
  if (fn == nullptr || C < 1 || C > kMaxCluster) return (int)cudaErrorInvalidValue;
  return (int)set_attributes(fn, C, smem_bytes(per_thread, stages, n_k));
}

// One SDCA epoch for B batch rows (B clusters of C CTAs) over K workers;
// workers is the int32 map of batch rows to workers, or nullptr for batch
// row b = worker b; map_error (2 ints, or nullptr for a map checked on the
// host) takes a device map's bad entry;
// alpha_rows != 0 reads alpha at batch row b; sigma_rows (B floats) or
// nullptr for sigma_p on every row.
int sdca_inner_launch(const void* w_eff, const void* alpha, const void* X, const void* y,
                      const void* norms, const void* idx, const void* workers, int K,
                      int alpha_rows, const void* sigma_rows, void* map_error, void* dalpha,
                      void* v, int B, int n_k, int d, int H, float lam_n, float sigma_p,
                      int loss, int C, int stages, int per_thread, void* stream) {
  KernelFn fn = kernel_for(loss, per_thread);
  const int chunk = slice_floats(d, C);
  if (fn == nullptr || C < 1 || C > kMaxCluster || stages < kMinStages || stages > kMaxStages ||
      chunk > per_thread * kThreads)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(per_thread, stages, n_k);
  cudaError_t err = set_attributes(fn, C, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(B, C, kBlock, smem, (cudaStream_t)stream, attr);
  err = cudaLaunchKernelEx(&cfg, fn, (const float*)w_eff, (const float*)alpha,
                           (const float*)X, (const float*)y, (const float*)norms,
                           (const int32_t*)idx, (const int32_t*)workers, K, alpha_rows,
                           (const float*)sigma_rows, (int*)map_error, (float*)dalpha,
                           (float*)v, n_k, d, H, chunk, stages, lam_n, sigma_p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K clusters of C CTAs run H exchange round trips, by st.async (kind 1, the
// kernel's) or by a DSMEM store and barrier.cluster (kind 0); out (K floats).
int sdca_inner_probe_launch(int K, int C, int H, int kind, void* out, void* stream) {
  void (*fn)(int, float*) = kind ? cluster_probe_kernel<true> : cluster_probe_kernel<false>;
  cudaError_t err = cudaSuccess;
  if (C > 8) err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(K, C, kThreads, 0, (cudaStream_t)stream, attr);
  err = cudaLaunchKernelEx(&cfg, fn, H, (float*)out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* sdca_inner_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
