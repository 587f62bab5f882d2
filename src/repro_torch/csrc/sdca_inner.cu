// Worker SDCA inner loop (Algorithm 2, line 4) for Hopper, ridge loss.
//
// Replaces the TPU kernel src/repro/kernels/sdca_inner.py::sdca_inner_pallas
// (body _sdca_kernel): one ridge-SDCA epoch per worker, H sequential steps
//
//     i     = idx[k, h]
//     z     = (w_eff + sigma' v) . x_i
//     delta = (y_i - a_i - z) / (1 + sigma' ||x_i||^2 / (lambda n))
//     dalpha[i] += delta ;  v += delta / (lambda n) * x_i
//
// Design: one block per worker (grid = K), 1024 threads strided over d.
// v lives in shared memory for the whole epoch (d floats: 189 KB at RCV1's
// d = 47,236, inside the 227 KB a block may use), w_eff and the rows x_i
// are read from device memory / L2. Each step fuses the two dot products
// into one block reduction in a fixed order, with no atomics, so repeated
// runs agree bit for bit. Thread 0 computes delta, updates dalpha in place
// and broadcasts delta / (lambda n) through shared memory; every thread then
// updates its own slice of v.
//
// What bounds it: the loop is sequential in h, so one step's latency (a row
// read, a block reduction, two barriers) times H sets the time. Each step
// reads one row, d * 4 bytes; one block pulls far less than the card's
// 3.35 TB/s. Splitting d over a thread-block cluster with a distributed
// shared-memory reduction is the way to cut the per-step latency.
//
// C interface, launched on the caller's stream; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Sum of (a, b) over the block; the result is valid in thread 0.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = make_float2(a, b);
  __syncthreads();
  float2 r = make_float2(0.f, 0.f);
  if (warp == 0) {
    r = scratch[lane];  // kWarps == 32: one partial per lane
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      r.x += __shfl_xor_sync(kFull, r.x, o);
      r.y += __shfl_xor_sync(kFull, r.y, o);
    }
  }
  return r;
}

__global__ void __launch_bounds__(kThreads)
sdca_inner_kernel(const float* __restrict__ w_eff, const float* __restrict__ alpha,
                  const float* __restrict__ X, const float* __restrict__ y,
                  const float* __restrict__ norms, const int32_t* __restrict__ idx,
                  float* __restrict__ dalpha, float* __restrict__ v_out,
                  int n_k, int d, int H, float lam_n, float sigma_p) {
  extern __shared__ float v[];  // d floats
  __shared__ float2 scratch[kWarps];
  __shared__ float step;  // delta / (lambda n) of the current step

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const float* w = w_eff + (size_t)k * d;
  const float* Xk = X + (size_t)k * n_k * d;
  const float* alpha_k = alpha + (size_t)k * n_k;
  const float* y_k = y + (size_t)k * n_k;
  const float* norms_k = norms + (size_t)k * n_k;
  const int32_t* idx_k = idx + (size_t)k * H;
  float* dalpha_k = dalpha + (size_t)k * n_k;

  for (int j = tid; j < d; j += kThreads) v[j] = 0.f;
  for (int j = tid; j < n_k; j += kThreads) dalpha_k[j] = 0.f;
  __syncthreads();

  for (int h = 0; h < H; ++h) {
    const int i = idx_k[h];
    if (i < 0 || i >= n_k) continue;  // uniform across the block
    const float* x = Xk + (size_t)i * d;
    float a = 0.f, b = 0.f;
    for (int j = tid; j < d; j += kThreads) {
      const float xj = x[j];
      a = fmaf(w[j], xj, a);
      b = fmaf(v[j], xj, b);
    }
    const float2 s = block_sum2(a, b, scratch);
    if (tid == 0) {
      const float z = s.x + sigma_p * s.y;
      const float a_i = alpha_k[i] + dalpha_k[i];
      const float q = sigma_p * norms_k[i] / lam_n;
      const float delta = (y_k[i] - a_i - z) / (1.0f + q);
      dalpha_k[i] += delta;
      step = delta / lam_n;
    }
    __syncthreads();
    const float c = step;
    // Each thread updates the same j it read above, so v needs no barrier
    // here; the next write of `step` comes after the next reduction's one.
    for (int j = tid; j < d; j += kThreads) v[j] = __fadd_rn(v[j], __fmul_rn(c, x[j]));
  }
  __syncthreads();
  for (int j = tid; j < d; j += kThreads) v_out[(size_t)k * d + j] = v[j];
}

}  // namespace

extern "C" {

// Largest d whose v fits the dynamic shared memory of one block.
int sdca_inner_max_d() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int static_bytes = kWarps * (int)sizeof(float2) + (int)sizeof(float);
  return (optin - static_bytes) / (int)sizeof(float);
}

int sdca_inner_launch(const void* w_eff, const void* alpha, const void* X,
                      const void* y, const void* norms, const void* idx,
                      void* dalpha, void* v, int K, int n_k, int d, int H,
                      float lam_n, float sigma_p, void* stream) {
  const size_t smem = (size_t)d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sdca_inner_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sdca_inner_kernel<<<K, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)w_eff, (const float*)alpha, (const float*)X, (const float*)y,
      (const float*)norms, (const int32_t*)idx, (float*)dalpha, (float*)v, n_k, d,
      H, lam_n, sigma_p);
  return (int)cudaGetLastError();
}

const char* sdca_inner_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
