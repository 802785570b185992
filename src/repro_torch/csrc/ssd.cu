// Mamba-2 SSD (state-space duality) chunked forward for Hopper (sm_90a), with
// the dt weighting and the D skip fused in.  Per (batch b, head h), over
// chunks of Q = 128 steps, with la = dt A and xw = x dt:
//
//   cum     = cumsum(la) within the chunk
//   y       = ((C B^T) o exp(cum_t - cum_s)[s <= t]) xw + (C h) o exp(cum) + D x
//   h'      = exp(cum_Q) h + (B o exp(cum_Q - cum))^T xw
//
// Replaces _ssd_kernel of the JAX package (src/repro/kernels/ssd/ssd.py:26,
// launched at :86), and the dt weighting and D skip its public op runs around
// it (src/repro/kernels/ssd/ops.py:21-33).  That kernel walks a (B, H, chunk)
// grid whose chunk axis is sequential on the TPU, with the (N, P) state in
// VMEM scratch, on inputs padded to a chunk multiple and rounded to x's dtype.
// Here one block of 256 threads owns one (batch, head, P-tile) and loops over
// the chunks with the state in shared memory, so nothing carries between
// blocks.  As the model's layer does (src/repro/layers/ssd.py), and unlike
// the Pallas op, x and dt are read in the model's dtype and widened in
// registers, la, xw, cum, B, C, the state and every accumulator stay f32, and
// only y is rounded.  B and C are read through (b, s, h) strides, so the
// model's head-shared (B, S, N) projections come in as stride-0 views and are
// never copied per head.  The ragged last chunk is masked here (zeros for B,
// C, x and la past S), so nothing is padded in device memory.  The initial
// state is an optional f32 h0.  Decay factors exp(cum_t - cum_s) are taken
// only for s <= t (above the diagonal the exponent is positive and could
// overflow).
//
// The columns of P are independent (y[:, p] needs only xw[:, p] and h[:, p]),
// so the launcher splits P into tiles of 64, 32 or 16 columns.  Each P-tile
// recomputes C B^T, which costs Q x Q x N multiply-adds per chunk and tile, so
// the launcher takes the tile with the least waves of blocks times work per
// block: at mamba2-370m's H = 32, P = 64 that is 64 columns at B = 8 and 4
// (256 and 128 blocks), 32 at B = 2 (128 blocks) and 16 at B = 1 (128).
//
// Per chunk the block runs four products out of shared memory, in f32 on the
// CUDA cores, each thread holding a register tile: C h (rows x 4 columns),
// C B^T (8 x 8, written over C once every read of C is done), G xw, and the
// state update B^T (w xw).  Shared memory: B and C (Q x N, odd row strides so
// that the rows neighbouring threads read fall in distinct banks), xw
// (Q x P-tile), h (N x P-tile) and four Q-vectors: 195 KB at N = 128 and a
// P-tile of 64, granted above the 48 KB default with cudaFuncSetAttribute.
//
// Bound on this card: bytes.  At mamba2-370m's prefill (B = 8, S = 32768,
// H = 32, P = 64, N = 128) the function moves 2.3 GB (x and y in bf16, B and C
// once, dt, h0 and h_last), 0.69 ms at 3.35 TB/s, against 4.8e11 operations
// for the causal half of the chunk products, 0.49 ms on bf16 tensor cores.
// This kernel does 6.9e11 f32 operations on the CUDA cores (the full square,
// P-tiles' repeats of C B^T aside), so it reaches a small share of that
// bound: mma/wgmma on bf16 fragments, skipping the upper triangle and a
// chunk-parallel state pass are left for later work.
//
// C interface, loaded with ctypes.  The launcher returns cudaGetLastError()
// right after the launch; it never synchronises and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 128;     // chunk length
constexpr int kMaxN = 128;  // the largest state the shared-memory plan holds
constexpr int kTC = 4;      // columns of a thread's y and h tiles
constexpr int kGT = 16;     // the C B^T tile: 16 x 16 threads ...
constexpr int kGR = kQ / kGT;  // ... of 8 x 8 entries each
static_assert(kQ == 4 * 32, "the chunk scan gives each lane of one warp 4 steps");
static_assert(kGT * kGT == kThreads, "the C B^T tile covers the block");

struct Strides {
  int64_t b, s, h;  // elements; the last dim is contiguous
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Row strides in floats.  Odd strides put the same column of neighbouring
// rows in distinct banks.
__host__ __device__ inline int ld_bc(int n) { return n | 1; }
constexpr int kLdG = kQ + 1;

__host__ __device__ inline size_t smem_floats(int n, int pt) {
  const int ld = ld_bc(n);
  return (size_t)kQ * ld + (size_t)kQ * (ld > kLdG ? ld : kLdG) + (size_t)kQ * pt +
         (size_t)n * pt + 4 * kQ;
}

template <typename T, int PT>
__global__ void __launch_bounds__(kThreads, 1)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
           const T* __restrict__ bm, const T* __restrict__ cm,
           const float* __restrict__ dskip, const float* __restrict__ h0,
           T* __restrict__ y, float* __restrict__ h_last, Strides sb, Strides sc, int seq,
           int heads, int P, int N) {
  // y and h tiles: TX column groups of kTC columns (strided by TX), TY row
  // groups (rows strided by TY).
  constexpr int TX = PT / kTC, TY = kThreads / TX;
  constexpr int TR = kQ / TY;                   // y rows per thread
  constexpr int NR = (kMaxN + TY - 1) / TY;     // h rows per thread (masked at N)

  extern __shared__ __align__(16) float smem[];
  const int ldb = ld_bc(N);
  float* bs = smem;                  // B rows (kQ x ldb)
  float* cg = bs + kQ * ldb;         // C rows (ldb), then G rows (kLdG)
  float* xs = cg + kQ * max(ldb, kLdG);  // xw (kQ x PT)
  float* hs = xs + kQ * PT;          // state (N x PT)
  float* cum = hs + N * PT;          // cumsum of la
  float* ecum = cum + kQ;            // exp(cum)
  float* ws = ecum + kQ;             // exp(cum_Q - cum)
  float* dts = ws + kQ;              // dt in f32

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = tid % TX, ty = tid / TX;
  const int gx = tid % kGT, gy = tid / kGT;
  const float a_h = A[h];
  const float d_h = dskip[h];

  // x, y (B, S, H, P) and dt (B, S, H) are contiguous.
  const int64_t row = (int64_t)heads * P;
  const T* xb = x + ((int64_t)b * seq * heads + h) * P + p0;
  T* yb = y + ((int64_t)b * seq * heads + h) * P + p0;
  const T* dtb = dt + (int64_t)b * seq * heads + h;
  const T* bb = bm + b * sb.b + h * sb.h;
  const T* cb = cm + b * sc.b + h * sc.h;
  const int64_t hoff = ((int64_t)b * heads + h) * N * P + p0;

  for (int i = tid; i < N * PT; i += kThreads) {
    const int n = i / PT, p = i % PT;
    hs[i] = (h0 != nullptr && p0 + p < P) ? h0[hoff + (int64_t)n * P + p] : 0.f;
  }

  const int nchunks = (seq + kQ - 1) / kQ;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * kQ;
    const int len = min(kQ, seq - t0);
    __syncthreads();  // the previous chunk's reads of B, G and xw are done

    // B and C rows and dt, zero past the end of the sequence.
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int t = i / N, n = i % N;
      float vb = 0.f, vc = 0.f;
      if (t < len) {
        vb = to_f32(bb[(int64_t)(t0 + t) * sb.s + n]);
        vc = to_f32(cb[(int64_t)(t0 + t) * sc.s + n]);
      }
      bs[t * ldb + n] = vb;
      cg[t * ldb + n] = vc;
    }
    if (tid < kQ) dts[tid] = tid < len ? to_f32(dtb[(int64_t)(t0 + tid) * heads]) : 0.f;
    __syncthreads();

    if (tid < 32) {
      // cum = cumsum(dt A): 4 steps per lane, then a scan of the lane sums.
      float v[4], run = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        run += dts[4 * tid + j] * a_h;
        v[j] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += u;
      }
      const float excl = incl - run;
      const float total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float cj = v[j] + excl;
        cum[4 * tid + j] = cj;
        ecum[4 * tid + j] = expf(cj);
        ws[4 * tid + j] = expf(total - cj);
      }
    } else {
      // xw = x dt, zero past S and past P.
      for (int i = tid - 32; i < kQ * PT; i += kThreads - 32) {
        const int t = i / PT, p = i % PT;
        float v = 0.f;
        if (t < len && p0 + p < P) v = to_f32(xb[(int64_t)(t0 + t) * row + p]) * dts[t];
        xs[i] = v;
      }
    }
    __syncthreads();

    // y = (C h) o exp(cum): the incoming state.
    float acc[TR][kTC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < N; ++k) {
      float a[TR], hv[kTC];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = cg[(ty + TY * i) * ldb + k];
#pragma unroll
      for (int j = 0; j < kTC; ++j) hv[j] = hs[k * PT + tx + TX * j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < kTC; ++j) acc[i][j] = fmaf(a[i], hv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float e = ecum[ty + TY * i];
#pragma unroll
      for (int j = 0; j < kTC; ++j) acc[i][j] *= e;
    }

    // G = (C B^T) o decay, in registers, then over C in shared memory.
    {
      float g[kGR][kGR];
#pragma unroll
      for (int i = 0; i < kGR; ++i)
#pragma unroll
        for (int j = 0; j < kGR; ++j) g[i][j] = 0.f;
      for (int k = 0; k < N; ++k) {
        float a[kGR], bv[kGR];
#pragma unroll
        for (int i = 0; i < kGR; ++i) a[i] = cg[(gy + kGT * i) * ldb + k];
#pragma unroll
        for (int j = 0; j < kGR; ++j) bv[j] = bs[(gx + kGT * j) * ldb + k];
#pragma unroll
        for (int i = 0; i < kGR; ++i)
#pragma unroll
          for (int j = 0; j < kGR; ++j) g[i][j] = fmaf(a[i], bv[j], g[i][j]);
      }
      __syncthreads();  // every read of C is done
#pragma unroll
      for (int i = 0; i < kGR; ++i) {
        const int t = gy + kGT * i;
        const float ct = cum[t];
#pragma unroll
        for (int j = 0; j < kGR; ++j) {
          const int s = gx + kGT * j;
          cg[t * kLdG + s] = s <= t ? g[i][j] * expf(ct - cum[s]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y += G xw (rows of xw past the sequence are zero), then the D skip.
    for (int k = 0; k < len; ++k) {
      float a[TR], xv[kTC];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = cg[(ty + TY * i) * kLdG + k];
#pragma unroll
      for (int j = 0; j < kTC; ++j) xv[j] = xs[k * PT + tx + TX * j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < kTC; ++j) acc[i][j] = fmaf(a[i], xv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int t = ty + TY * i;
      if (t >= len) continue;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const int p = tx + TX * j;
        if (p0 + p >= P) continue;
        const int64_t off = (int64_t)(t0 + t) * row + p;
        store(yb + off, acc[i][j] + d_h * to_f32(xb[off]));
      }
    }

    // h' = exp(cum_Q) h + (B o w)^T xw; each thread updates its own entries.
    {
      float hacc[NR][kTC];
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int j = 0; j < kTC; ++j) hacc[i][j] = 0.f;
      for (int k = 0; k < len; ++k) {
        const float w = ws[k];
        float bw[NR], xv[kTC];
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const int n = ty + TY * i;
          bw[i] = n < N ? bs[k * ldb + n] * w : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kTC; ++j) xv[j] = xs[k * PT + tx + TX * j];
#pragma unroll
        for (int i = 0; i < NR; ++i)
#pragma unroll
          for (int j = 0; j < kTC; ++j) hacc[i][j] = fmaf(bw[i], xv[j], hacc[i][j]);
      }
      const float decay = ecum[kQ - 1];  // la is zero past the sequence
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int n = ty + TY * i;
        if (n >= N) continue;
#pragma unroll
        for (int j = 0; j < kTC; ++j) {
          const int idx = n * PT + tx + TX * j;
          hs[idx] = fmaf(decay, hs[idx], hacc[i][j]);
        }
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < N * PT; i += kThreads) {
    const int n = i / PT, p = i % PT;
    if (p0 + p < P) h_last[hoff + (int64_t)n * P + p] = hs[i];
  }
}

template <typename T, int PT>
int launch(const void* x, const void* dt, const void* A, const void* bm, const void* cm,
           const void* D, const void* h0, void* y, void* h_last, const int64_t* st,
           int batch, int seq, int heads, int P, int N, cudaStream_t stream) {
  auto kernel = ssd_kernel<T, PT>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(smem_floats(kMaxN, PT) * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const Strides sb{st[0], st[1], st[2]}, sc{st[3], st[4], st[5]};
  const dim3 grid((P + PT - 1) / PT, heads, batch);
  kernel<<<grid, kThreads, smem_floats(N, PT) * sizeof(float), stream>>>(
      (const T*)x, (const T*)dt, (const float*)A, (const T*)bm, (const T*)cm,
      (const float*)D, (const float*)h0, (T*)y, (float*)h_last, sb, sc, seq, heads, P, N);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int pt, const void* x, const void* dt, const void* A, const void* bm,
             const void* cm, const void* D, const void* h0, void* y, void* h_last,
             const int64_t* st, int batch, int seq, int heads, int P, int N,
             cudaStream_t s) {
  if (pt == 64)
    return launch<T, 64>(x, dt, A, bm, cm, D, h0, y, h_last, st, batch, seq, heads, P, N, s);
  if (pt == 32)
    return launch<T, 32>(x, dt, A, bm, cm, D, h0, y, h_last, st, batch, seq, heads, P, N, s);
  return launch<T, 16>(x, dt, A, bm, cm, D, h0, y, h_last, st, batch, seq, heads, P, N, s);
}

}  // namespace

// x, y (B, S, H, P) and dt (B, S, H) contiguous, of one dtype (bf16 when
// is_bf16, else f32), as are bm and cm (B, S, H, N) with a contiguous last dim
// and (b, s, h) element strides in strides[0..2] and [3..5] (h may be 0);
// A, D (H,) f32; h0 (B, H, N, P) f32 or null (zeros); h_last (B, H, N, P)
// f32.  The caller checks 1 <= N <= 128.
extern "C" int ssd_fwd(const void* x, const void* dt, const void* A, const void* bm,
                       const void* cm, const void* D, const void* h0, void* y,
                       void* h_last, const int64_t* strides, int batch, int seq, int heads,
                       int P, int N, int is_bf16, void* stream) {
  if (batch <= 0 || heads <= 0 || P <= 0) return 0;
  if (N <= 0 || N > kMaxN) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // The P-tile with the least waves x work per block and chunk: every tile
  // recomputes C B^T (Q^2 N multiply-adds) and does pt (Q^2 + 2 Q N) more.
  // One block fits an SM at N = 128, so the waves are whole.  A tile mostly
  // past P is not considered.
  const int64_t bh = (int64_t)batch * heads;
  int pt = 16;
  double best = 0.0;
  for (int cand = 16; cand <= 64 && (cand == 16 || cand / 2 < P); cand *= 2) {
    const int64_t blocks = bh * ((P + cand - 1) / cand);
    const double work = (double)((blocks + sms - 1) / sms) *
                        ((double)kQ * kQ * N + (double)cand * (kQ * kQ + 2.0 * kQ * N));
    if (cand == 16 || work < best) {
      best = work;
      pt = cand;
    }
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(pt, x, dt, A, bm, cm, D, h0, y, h_last, strides, batch,
                                   seq, heads, P, N, s);
  return dispatch<float>(pt, x, dt, A, bm, cm, D, h0, y, h_last, strides, batch, seq, heads,
                         P, N, s);
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
