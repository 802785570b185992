// Flash-attention forward for Hopper (sm_90a): online softmax over key tiles,
// causal / sliding-window / tanh soft-cap / GQA and MQA, bf16 in and out.
//
// Replaces _flash_fwd_kernel of the JAX package
// (src/repro/kernels/flash_attention/flash_attention.py:29, launched at :121).
// That kernel runs a (B, H, q-block, k-block) grid whose last axis is
// sequential on the TPU, carrying (m, l, acc) in VMEM scratch across k-blocks,
// and reads a (B, H, S, D) layout padded to block multiples.  Here one block
// of 128 threads (4 warps) owns one (batch, head, 64-query tile) and walks its
// key tiles in a loop, so the carry lives in registers; the model's
// (B, S, H, D) layout is read through strides (no transpose), and the ragged
// edges of Sq, Sk and D are masked or zero-filled in shared memory (no
// padding in device memory).
//
// Work skipped by loop bounds, not by masks: a query tile [q0, q1] visits key
// tiles from the one holding max(0, q0 - window + 1) (window > 0) to the one
// holding min(Sk - 1, q1) (causal).  Only the tiles on the diagonal and the
// window's edge are masked element by element.  Masked scores are -inf and a
// row with no key yet uses 0 as its running max, so a fully masked row gives
// zeros (as the materialised reference does after its NaN clean-up).
//
// Each warp computes a 16-row strip with mma.sync m16n8k16 (bf16 in, f32
// accumulate): S = Q K^T from Q and K tiles in shared memory, then the row
// max / sum of the online softmax on the accumulator fragments (quad
// shuffles), then O += P V with P re-packed from the S fragments to bf16
// (as the JAX layer casts p to v's dtype) and V stored transposed in shared
// memory.  The output is acc / max(l, 1e-20), written as bf16.
//
// Bound on this card: operations.  At recurrentgemma-9b's prefill (B = 8,
// S = 4096, H = 16, Hkv = 1, D = 256, window 2048) the live tiles hold
// 4·B·H·D·Σ_q min(q+1, window) = 8.2e11 flops against 0.27 GB of q/k/v/o,
// 3,000 flops a byte, far above the 295 at which bf16 tensor cores overtake
// memory.  mma.sync reaches a fraction of the 989 TFLOP/s that wgmma with TMA
// would; K/V tiles are loaded synchronously (no cp.async pipeline).  Both are
// left for later work.
//
// C interface, loaded with ctypes.  The launcher returns cudaGetLastError()
// right after the launch; it never synchronises and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;  // 16 query rows per warp
constexpr int kPad = 8;               // bf16 pad per shared row: no bank conflicts

struct Strides {
  int64_t b, s, h;  // elements; the last dim is contiguous
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kD: head dim rounded up to a multiple of 32 (zero-filled past d);
// kBlockK: keys per tile.
template <int kD, int kBlockK>
struct Tiles {
  static constexpr int kRow = kD + kPad;        // Q and K rows
  static constexpr int kVtRow = kBlockK + kPad;  // V^T rows (one per d)
  static constexpr size_t kQ = (size_t)kBlockQ * kRow;
  static constexpr size_t kK = (size_t)kBlockK * kRow;
  static constexpr size_t kVt = (size_t)kD * kVtRow;
  static constexpr size_t kBytes = (kQ + kK + kVt) * sizeof(__nv_bfloat16);
};

template <int kD, int kBlockK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 Strides sq_, Strides sk_, Strides sv_, Strides so_, int sq, int sk,
                 int heads, int kv_heads, int d, float scale, int causal, int window,
                 float cap) {
  using T = Tiles<kD, kBlockK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + T::kQ;
  __nv_bfloat16* vt = ks + T::kK;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row group of the mma fragments
  const int t = lane & 3;   // thread in the group
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (heads / kv_heads);

  const __nv_bfloat16* qb = q + b * sq_.b + h * sq_.h;
  const __nv_bfloat16* kb = k + b * sk_.b + hk * sk_.h;
  const __nv_bfloat16* vb = v + b * sv_.b + hk * sv_.h;

  constexpr int kChunks = kD / 8;  // 16-byte chunks per row
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // Q tile -> shared, zero past Sq and past d.
  for (int c = tid; c < kBlockQ * kChunks; c += kThreads) {
    const int row = c / kChunks, col = (c % kChunks) * 8;
    uint4 val = zero;
    if (q0 + row < sq && col < d) val = *reinterpret_cast<const uint4*>(qb + (int64_t)(q0 + row) * sq_.s + col);
    *reinterpret_cast<uint4*>(qs + row * T::kRow + col) = val;
  }

  // Key tiles this query tile can see.
  const int q_last = min(q0 + kBlockQ, sq) - 1;
  const int k_hi = causal ? min(sk, q_last + 1) : sk;  // exclusive
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int tile_lo = k_lo / kBlockK;
  const int tile_hi = (k_hi + kBlockK - 1) / kBlockK;

  constexpr int kNt = kBlockK / 8;  // n-tiles of S
  constexpr int kDt = kD / 8;       // n-tiles of O
  float acc[kDt][4];
#pragma unroll
  for (int i = 0; i < kDt; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int row0 = q0 + warp * 16 + g;  // query positions of this thread's rows
  const int rows[2] = {row0, row0 + 8};
  const __nv_bfloat16* qw = qs + (warp * 16) * T::kRow;

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int kt0 = tile * kBlockK;
    __syncthreads();  // the previous tile's K and V are no longer read
    for (int c = tid; c < kBlockK * kChunks; c += kThreads) {
      const int row = c / kChunks, col = (c % kChunks) * 8;
      uint4 kv = zero;
      if (kt0 + row < sk && col < d)
        kv = *reinterpret_cast<const uint4*>(kb + (int64_t)(kt0 + row) * sk_.s + col);
      *reinterpret_cast<uint4*>(ks + row * T::kRow + col) = kv;
    }
    // V goes in transposed; neighbouring threads take neighbouring keys, so
    // a warp's 2-byte stores into a V^T row are contiguous (no bank conflict).
    for (int c = tid; c < kBlockK * kChunks; c += kThreads) {
      const int row = c % kBlockK, col = (c / kBlockK) * 8;
      uint4 vv = zero;
      if (kt0 + row < sk && col < d)
        vv = *reinterpret_cast<const uint4*>(vb + (int64_t)(kt0 + row) * sv_.s + col);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(col + j) * T::kVtRow + row] = ve[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's keys.
    float s[kNt][4];
#pragma unroll
    for (int n = 0; n < kNt; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD; kk += 16) {
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(qw + g * T::kRow + kk + 2 * t);
      a[1] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * T::kRow + kk + 2 * t);
      a[2] = *reinterpret_cast<const uint32_t*>(qw + g * T::kRow + kk + 8 + 2 * t);
      a[3] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * T::kRow + kk + 8 + 2 * t);
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        const __nv_bfloat16* kr = ks + (n * 8 + g) * T::kRow + kk + 2 * t;
        mma_bf16(s[n], a, *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // Scale, soft-cap, mask; online softmax per row.
    const bool edge = (kt0 + kBlockK > sk) || (causal && kt0 + kBlockK - 1 > q0 + warp * 16) ||
                      (window > 0 && kt0 <= q0 + warp * 16 + 15 - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        if (edge) {
          const int qp = rows[e >> 1];
          const int kp = kt0 + n * 8 + 2 * t + (e & 1);
          const bool ok = kp < sk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
          if (!ok) x = -INFINITY;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = __expf(m_run[r] - m_use[r]);
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < kDt; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[n][e] - m_use[e >> 1]);
        s[n][e] = p;
        l_run[e >> 1] += p;
      }
    }

    // O += P V: P's accumulator fragments are the A operand, 16 keys a step.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int i = 0; i < kDt; ++i) {
        const __nv_bfloat16* vr = vt + (i * 8 + g) * T::kVtRow + kk * 16 + 2 * t;
        mma_bf16(acc[i], a, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }

  // Row sums across the quad, normalise, store bf16 pairs.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    l_run[r] = 1.f / fmaxf(l_run[r], 1e-20f);
  }
  __nv_bfloat16* ob = o + b * so_.b + h * so_.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= sq) continue;
    __nv_bfloat16* orow = ob + (int64_t)rows[r] * so_.s;
#pragma unroll
    for (int i = 0; i < kDt; ++i) {
      const int col = i * 8 + 2 * t;
      if (col < d) {
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(acc[i][2 * r] * l_run[r], acc[i][2 * r + 1] * l_run[r]);
      }
    }
  }
}

template <int kD, int kBlockK>
int launch(const void* q, const void* k, const void* v, void* o, const int64_t* st,
           int batch, int sq, int sk, int heads, int kv_heads, int d, float scale,
           int causal, int window, float cap, cudaStream_t stream) {
  using T = Tiles<kD, kBlockK>;
  auto kernel = flash_fwd_kernel<kD, kBlockK>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const Strides sq_{st[0], st[1], st[2]}, sk_{st[3], st[4], st[5]},
      sv_{st[6], st[7], st[8]}, so_{st[9], st[10], st[11]};
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, heads, batch);
  kernel<<<grid, kThreads, T::kBytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, sq_, sk_, sv_, so_, sq, sk, heads, kv_heads, d, scale, causal,
      window, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, Hkv, D), o (B, Sq, H, D), all bf16 with a
// contiguous last dim; strides[12] = (b, s, h) element strides of q, k, v, o.
// The caller checks D <= 256, D % 8 == 0, 16-byte alignment and H % Hkv == 0.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   const int64_t* strides, int batch, int sq, int sk,
                                   int heads, int kv_heads, int d, float scale, int causal,
                                   int window, float cap, void* stream) {
  if (batch <= 0 || sq <= 0 || heads <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 32)
    return launch<32, 64>(q, k, v, o, strides, batch, sq, sk, heads, kv_heads, d, scale,
                          causal, window, cap, s);
  if (d <= 64)
    return launch<64, 64>(q, k, v, o, strides, batch, sq, sk, heads, kv_heads, d, scale,
                          causal, window, cap, s);
  if (d <= 128)
    return launch<128, 64>(q, k, v, o, strides, batch, sq, sk, heads, kv_heads, d, scale,
                           causal, window, cap, s);
  return launch<256, 32>(q, k, v, o, strides, batch, sq, sk, heads, kv_heads, d, scale,
                         causal, window, cap, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
