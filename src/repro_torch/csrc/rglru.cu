// RG-LRU recurrence for Hopper (sm_90a), with the gate math fused in:
//
//   log_a_t = -8 softplus(a_param) r_t
//   u_t     = sqrt(max(1 - exp(2 log_a_t), 1e-12)) i_t x_t
//   h_t     = exp(log_a_t) h_{t-1} + u_t,    y_t = h_t in x's dtype
//
// Replaces _rglru_kernel of the JAX package
// (src/repro/kernels/rglru/rglru.py:27, launched at :64), and the gate math
// its public op runs before it (src/repro/kernels/rglru/ops.py:21-28).  That
// kernel walks (BLOCK_S, 128-lane) tiles of precomputed (log_a, u), rounded to
// x's dtype, with the carried state in VMEM across a sequential grid axis.
// Here one thread owns one (b, n) channel and walks time in a register: it
// reads x, r and i in the model's dtype plus a_param and h0 in f32, keeps
// log_a, u and h in f32 (as the model's layer does: nothing is rounded to
// bf16 but y), writes y, and writes h_last in f32.  Neighbouring threads take
// neighbouring n, so every load and store of a time step is coalesced.  The
// time loop is unrolled so that the loads of several steps are in flight
// while the multiply-add chain through h runs.
//
// Bound on this card: bytes.  Each element of (B, S, N) is read three times
// and written once, 8 bytes in bf16, at 3.35 TB/s.  Known weakness: only B·N
// threads are live (32,768 at recurrentgemma-9b's B = 8, N = 4096; 4,096 at
// B = 1), too few to hide memory latency on 132 SMs.  A two-level scan over
// time blocks would give more parallelism; it is left for later work.
//
// C interface, loaded with ctypes: pointers and the stream are void*.  The
// launcher returns cudaGetLastError() right after the launch; it never
// synchronises and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;
constexpr float kC = 8.0f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ i,
             const float* __restrict__ a_param, const float* __restrict__ h0,
             T* __restrict__ y, float* __restrict__ h_last, int batch, int seq, int width) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (n >= width || b >= batch) return;
  const float a = a_param[n];
  // softplus(a) = log1p(exp(-|a|)) + max(a, 0), as jax.nn.softplus.
  const float sp = log1pf(expf(-fabsf(a))) + fmaxf(a, 0.f);
  const float c = -kC * sp;
  float h = h0 != nullptr ? h0[(int64_t)b * width + n] : 0.f;
  const int64_t base = (int64_t)b * seq * width + n;
  const T* xp = x + base;
  const T* rp = r + base;
  const T* ip = i + base;
  T* yp = y + base;

  int t = 0;
  for (; t + kUnroll <= seq; t += kUnroll) {
    float xs[kUnroll], rs[kUnroll], is[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t off = (int64_t)(t + j) * width;
      xs[j] = to_f32(xp[off]);
      rs[j] = to_f32(rp[off]);
      is[j] = to_f32(ip[off]);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const float log_a = c * rs[j];
      const float beta = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f));
      h = expf(log_a) * h + beta * (is[j] * xs[j]);
      store(yp + (int64_t)(t + j) * width, h);
    }
  }
  for (; t < seq; ++t) {
    const int64_t off = (int64_t)t * width;
    const float log_a = c * to_f32(rp[off]);
    const float beta = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f));
    h = expf(log_a) * h + beta * (to_f32(ip[off]) * to_f32(xp[off]));
    store(yp + off, h);
  }
  h_last[(int64_t)b * width + n] = h;
}

template <typename T>
int launch(const void* x, const void* r, const void* i, const void* a_param,
           const void* h0, void* y, void* h_last, int batch, int seq, int width,
           cudaStream_t stream) {
  const dim3 grid((width + kThreads - 1) / kThreads, batch);
  rglru_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)r, (const T*)i, (const float*)a_param, (const float*)h0,
      (T*)y, (float*)h_last, batch, seq, width);
  return (int)cudaGetLastError();
}

}  // namespace

// x, r, i, y: contiguous (B, S, N) of one dtype (bf16 when is_bf16, else
// f32); a_param (N,) f32; h0 (B, N) f32 or null (zeros); h_last (B, N) f32.
extern "C" int rglru_scan(const void* x, const void* r, const void* i, const void* a_param,
                          const void* h0, void* y, void* h_last, int batch, int seq,
                          int width, int is_bf16, void* stream) {
  if (batch <= 0 || width <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(x, r, i, a_param, h0, y, h_last, batch, seq, width, s);
  return launch<float>(x, r, i, a_param, h0, y, h_last, batch, seq, width, s);
}

extern "C" const char* rglru_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
