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
//
// Here time is split as the JAX layer splits it (src/repro/layers/rglru.py:
// an associative scan with combine((a1, u1), (a2, u2)) = (a1 a2, a2 u1 + u2)),
// in one pass with no scratch in device memory.  A block owns (b, 32
// channels), one channel per lane, and walks time in chunks of kChunk = 128
// steps.  Inside a chunk each of its 16 warps takes 8 consecutive steps and
// scans them from h = 0, keeping h and the running product of a in f32
// registers; the warps' (product, h) pairs meet in shared memory, where each
// warp combines the carry of the previous chunk with the pairs of the warps
// before it into its own h_in, and then writes y = h + (product of a) h_in.
// x, r and i come through cp.async into a ring of chunks in shared memory
// (bf16: three, 72 KB; f32: two), so the next chunks load while this one is
// scanned, combined and stored; two blocks fit on an SM.  The gate math,
// log_a, u and h stay f32 as in the model's layer (nothing is rounded to
// bf16 but y); steps past S are (a, u) = (1, 0), so a ragged last chunk
// needs no special case; ``ref.rglru_chunked_ref`` repeats this order of
// arithmetic.  N not a multiple of 32, or rows not 16-byte aligned: each
// thread copies its own elements into the ring, without the overlap.
//
// Bound on this card: bytes.  Each element of (B, S, N) is read three times
// and written once, 8 bytes in bf16, at 3.35 TB/s (0.040 ms at B = 1, S = N =
// 4096).  At B = 1, N = 4096 the grid is 128 blocks of 16 warps, one per SM,
// each with two chunks of loads (48 KB) in flight; the earlier kernel had
// one thread per channel, 4,096 threads on 132 SMs (csrc/rglru_serial.cu,
// kept as chip_smoke.py's yardstick).  Known weakness: about 55 instructions
// an element (two expf and a sqrtf in f32), issued by 16 warps an SM at
// B = 1; 4 of 132 SMs idle at B = 1, N = 4096.
//
// C interface, loaded with ctypes: pointers and the stream are void*.  The
// launcher returns cudaGetLastError() right after the launch; it never
// synchronises and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;                // channels of a block, one per lane
constexpr int kWarps = 16;                // sub-segments of a chunk
constexpr int kSteps = 8;                 // steps of a sub-segment
constexpr int kChunk = kWarps * kSteps;   // steps of a chunk
constexpr int kThreads = kWarps * 32;
constexpr float kC = 8.0f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Chunks in shared memory at once: bf16 three (72 KB), f32 two (96 KB).
template <typename T>
struct Ring {
  static constexpr int kStages = sizeof(T) == 2 ? 3 : 2;
  static constexpr int kPer = kLanes * (int)sizeof(T) / 16;  // 16-byte pieces of a row
  static constexpr size_t kTile = (size_t)kChunk * kLanes;    // one tensor's chunk
  static constexpr size_t kBytes = kStages * 3 * kTile * sizeof(T);
};

// 16 bytes from global to shared memory without passing through registers;
// zeros when !valid (``src`` must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rglru_kernel(const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ i,
             const float* __restrict__ a_param, const float* __restrict__ h0,
             T* __restrict__ y, float* __restrict__ h_last, int seq, int width, int vec) {
  using R = Ring<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage s, tensor (x, r, i): a (kChunk, kLanes) tile of that chunk's rows
  T* ring = reinterpret_cast<T*>(smem_raw);
  // (product of a, h) at the end of each warp's sub-segment, two chunks
  // apart so that a chunk's combine and the next chunk's writes never meet.
  __shared__ float2 part[2][kWarps][kLanes];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kLanes;
  const int n = n0 + lane;
  const int b = blockIdx.y;
  const bool live = n < width;
  const float ap = live ? a_param[n] : 0.f;
  // softplus(a) = log1p(exp(-|a|)) + max(a, 0), as jax.nn.softplus.
  const float c = -kC * (log1pf(expf(-fabsf(ap))) + fmaxf(ap, 0.f));
  float carry = (h0 != nullptr && live) ? h0[(int64_t)b * width + n] : 0.f;
  const int64_t base = (int64_t)b * seq * width;
  const T* src[3] = {x + base, r + base, i + base};

  // Chunk ``chunk`` into stage ``chunk % kStages``.  Rows past S are zeros:
  // r = 0 gives a = 1 and x = 0 gives u = 0, the identity step.  vec (the
  // tile is whole and its rows 16-byte aligned): cp.async, one piece of
  // each tensor a thread (two in f32); else each thread copies its own
  // steps' elements.
  auto issue = [&](int chunk) {
    T* stage = ring + (chunk % R::kStages) * 3 * R::kTile;
    const int t0 = chunk * kChunk;
    if (vec) {
#pragma unroll
      for (int k = 0; k < kChunk * R::kPer / kThreads; ++k) {
        const int piece = tid + k * kThreads;
        const int row = piece / R::kPer;
        const int col = (piece % R::kPer) * (16 / (int)sizeof(T));
        const bool ok = t0 + row < seq;
        const int64_t off = (int64_t)(t0 + row) * width + n0 + col;
#pragma unroll
        for (int m = 0; m < 3; ++m)
          cp_async16(stage + m * R::kTile + row * kLanes + col, ok ? src[m] + off : src[m], ok);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int row = warp * kSteps + j;
        const bool ok = live && t0 + row < seq;
        const int64_t off = (int64_t)(t0 + row) * width + n;
#pragma unroll
        for (int m = 0; m < 3; ++m)
          stage[m * R::kTile + row * kLanes + lane] = ok ? src[m][off] : T(0.f);
      }
    }
  };

  const int chunks = (seq + kChunk - 1) / kChunk;
#pragma unroll
  for (int s = 0; s < R::kStages - 1; ++s) {
    if (s < chunks) issue(s);
    cp_async_commit();
  }
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait<R::kStages - 2>();  // this chunk landed
    __syncthreads();  // ... for every warp; the stage read last chunk is free
    if (ch + R::kStages - 1 < chunks) issue(ch + R::kStages - 1);
    cp_async_commit();
    const T* stage = ring + (ch % R::kStages) * 3 * R::kTile + warp * kSteps * kLanes + lane;
    float hs[kSteps], ps[kSteps];  // (u, a), then this sub-segment's scan from h = 0
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const float log_a = c * to_f32(stage[R::kTile + j * kLanes]);
      const float beta = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f));
      ps[j] = expf(log_a);
      hs[j] = beta * (to_f32(stage[2 * R::kTile + j * kLanes]) * to_f32(stage[j * kLanes]));
    }
#pragma unroll
    for (int j = 1; j < kSteps; ++j) {
      hs[j] = ps[j] * hs[j - 1] + hs[j];
      ps[j] = ps[j] * ps[j - 1];
    }
    float2(&mine)[kWarps][kLanes] = part[ch & 1];
    mine[warp][lane] = make_float2(ps[kSteps - 1], hs[kSteps - 1]);
    __syncthreads();
    // h_in of this warp: the carry combined with the warps before it; the
    // carry of the next chunk: combined with all of them.
    float h_in = carry;
    float h = carry;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp) h_in = h;
      const float2 pw = mine[w][lane];
      h = pw.x * h + pw.y;
    }
    carry = h;
    if (live) {
      const int t0 = ch * kChunk + warp * kSteps;
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        if (t0 + j < seq)
          store(y + base + (int64_t)(t0 + j) * width + n, hs[j] + ps[j] * h_in);
      }
    }
  }
  cp_async_wait<0>();  // nothing may be in flight when the block exits
  if (warp == 0 && live) h_last[(int64_t)b * width + n] = carry;
}

template <typename T>
int launch(const void* x, const void* r, const void* i, const void* a_param,
           const void* h0, void* y, void* h_last, int batch, int seq, int width,
           cudaStream_t stream) {
  using R = Ring<T>;
  auto kernel = rglru_kernel<T>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)R::kBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  // cp.async needs whole 32-channel tiles and 16-byte aligned rows.
  const bool aligned = ((uintptr_t)x | (uintptr_t)r | (uintptr_t)i) % 16 == 0;
  const int vec = aligned && width % kLanes == 0;
  const dim3 grid((width + kLanes - 1) / kLanes, batch);
  kernel<<<grid, kThreads, R::kBytes, stream>>>(
      (const T*)x, (const T*)r, (const T*)i, (const float*)a_param, (const float*)h0,
      (T*)y, (float*)h_last, seq, width, vec);
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
