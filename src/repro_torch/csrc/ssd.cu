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
// the chunks with the state on chip, so nothing carries between blocks.  As
// the model's layer does (src/repro/layers/ssd.py), and unlike the Pallas
// op, la, cum, the state and every accumulator stay f32 and x dt is never
// rounded.  B and C are read through (b, s, h) strides, so the
// model's head-shared (B, S, N) projections come in as stride-0 views and are
// never copied per head.  The ragged last chunk is masked here (zeros for B,
// C, x and la past S), so nothing is padded in device memory.  The initial
// state is an optional f32 h0.  Decay factors exp(cum_t - cum_s) are taken
// only for s <= t (above the diagonal the exponent is positive and could
// overflow).
//
// The columns of P are independent (y[:, p] needs only xw[:, p] and h[:, p]),
// so the launcher splits P into tiles of 64, 32 or 16 columns; each P-tile
// recomputes C B^T.  Two kernels, chosen by dtype:
//
// bf16 (the model's dtype): ssd_mma_kernel runs the four chunk products as
// mma.sync m16n8k16 (bf16 operands, f32 accumulators) on the tensor cores,
// each warp on a 16-row strip i of the chunk's steps t:
//   * y = exp(cum_t) (C h): C rows from shared memory as the A operand, the
//     state's copy h^T (P-tile x N) as the B operand;
//   * S = C B^T over the s-tiles 0..i only: the tiles above the diagonal are
//     skipped by loop bounds, two tiles at a time for two accumulator
//     chains, and G = S exp(cum_t - cum_s) dt_s (zero for s > t, the
//     exponential taken only for s <= t) is packed from the accumulators
//     into A fragments, as flash packs P.  Strip i has i + 1 tiles, so the
//     warps pair up: warp w < 4 also does the first 4 - w tiles of strip
//     7 - w and hands its partial y over through shared memory, and no warp
//     does more than 5 of the 36;
//   * y += G x with x (Q x P-tile) read transposed as the B operand: x stays
//     exact (dt is folded into G's columns), then y + D x is rounded once;
//   * h' = exp(cum_Q) h + Bw^T x, Bw = B exp(cum_Q - cum_s) dt_s: the A
//     operand (n, s) is read from B's (s, n) rows with ldmatrix.trans and
//     scaled in registers.  The f32 state lives in registers as the
//     accumulators of the warp that owns its 16 rows of n; only its copy h^T
//     goes through shared memory.
// x, B and C are bf16 already, so C B^T is exact.  G, h^T and Bw are f32
// values: each goes in as a bf16 part and the bf16 part of its remainder
// (two mmas, about 16 bits).  Rounded once, G puts y beyond the bf16
// tolerance on the model's own inputs (B and C of unit scale make G's terms
// large against y), h^T adds to that, and Bw takes h_last to the edge of
// its tolerance (scripts/torch_ssd_probe.py attributes it;
// ``ref.ssd_chunked_bf16ops_ref`` repeats this arithmetic).  Fragments come
// through ldmatrix.  C, B and x rows come through cp.async into two stages:
// the next chunk's rows load while this chunk's products run, and a warp
// with 4 tiles takes the next chunk's dt and cumsum.  Shared memory: two
// stages of C, B (Q x N, padded to 16 and by 8 bf16 per row), x and four
// f32 Q-vectors, both parts of h^T and the partial strips: 226 KB at
// N = 128 and 64 columns, one block per SM.
//
// f32: ssd_kernel runs the four products in f32 on the CUDA cores, each
// thread holding a register tile: C h (rows x 4 columns), the full square
// of C B^T (8 x 8, written over C once every read of C is done), G xw, and
// the state update B^T (w xw).  Shared memory: B and C (Q x N, odd row
// strides so that the rows neighbouring threads read fall in distinct
// banks), xw (Q x P-tile), h (N x P-tile) and four Q-vectors: 195 KB at
// N = 128 and a P-tile of 64.  It holds the f32 parity of 2e-4.
//
// Each launcher grants its shared memory above the 48 KB default with
// cudaFuncSetAttribute and takes the P-tile with the least waves of blocks
// times work per block.
//
// Bound on this card: bytes.  At mamba2-370m's prefill (B = 8, S = 32768,
// H = 32, P = 64, N = 128) the function moves 2.3 GB (x and y in bf16, B and C
// once, dt, h0 and h_last), 0.69 ms at 3.35 TB/s, against 4.8e11 operations
// for the causal half of the chunk products, 0.49 ms on bf16 tensor cores.
// The bf16 kernel issues 8.6e11 (the diagonal tiles whole, three operands
// split).  What holds it from the bound (scripts/torch_ssd_phases.py): the
// triangle's dependent mma.sync chains and its exponentials, one block of
// 8 warps per SM to hide them, and a B operand read from shared memory for
// every mma of a 16-row strip (wgmma, two blocks per SM and a chunk-parallel
// state pass for B = 1 are left for later work).
//
// Training: ``states`` (optional) receives the f32 state entering each chunk,
// (B, H, chunks, N, P), which the backward (layers/ssd.py ssd_bwd, PyTorch
// ops) starts from.  The bf16 kernel stores it from the state's f32
// accumulators, the f32 kernel from shared memory; a null pointer writes
// nothing, and the bf16 kernel is then the instantiation without the store.
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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Row strides in floats.  Odd strides put the same column of neighbouring
// rows in distinct banks.
__host__ __device__ inline int ld_bc(int n) { return n | 1; }
constexpr int kLdG = kQ + 1;

__host__ __device__ inline size_t smem_floats(int n, int pt) {
  const int ld = ld_bc(n);
  return (size_t)kQ * ld + (size_t)kQ * (ld > kLdG ? ld : kLdG) + (size_t)kQ * pt +
         (size_t)n * pt + 4 * kQ;
}

// -- f32: the chunk products on the CUDA cores (instantiated for float) ------

template <typename T, int PT>
__global__ void __launch_bounds__(kThreads, 1)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
           const T* __restrict__ bm, const T* __restrict__ cm,
           const float* __restrict__ dskip, const float* __restrict__ h0,
           T* __restrict__ y, float* __restrict__ h_last, float* __restrict__ states,
           Strides sb, Strides sc, int seq, int heads, int P, int N) {
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
  // (B, H, chunks, N, P): the state entering each chunk, for the backward
  float* const sts = states == nullptr ? nullptr
                                       : states + ((int64_t)b * heads + h) * nchunks * N * P + p0;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * kQ;
    const int len = min(kQ, seq - t0);
    __syncthreads();  // the previous chunk's reads of B, G and xw are done
    if (sts != nullptr) {
      for (int i = tid; i < N * PT; i += kThreads) {
        const int n = i / PT, p = i % PT;
        if (p0 + p < P) sts[(int64_t)c * N * P + (int64_t)n * P + p] = hs[i];
      }
    }

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

// -- bf16: the chunk products on the tensor cores ----------------------------

typedef __nv_bfloat16 bf16;

constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;  // bf16 pad per shared row: ldmatrix rows in distinct banks
static_assert(kWarps * 16 == kQ, "each warp owns 16 steps of the chunk");
static_assert(kWarps * 16 == kMaxN, "each warp owns 16 rows of the largest state");

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

// Two stages, each of C and B (kQ x ldn) and x (kQ x (pt + kPad)) in bf16
// and four f32 Q-vectors; h^T's two parts (pt x ldn each) in bf16, with
// ldn = N padded to 16 plus kPad; four partial strips of y (16 x pt) in f32.
__host__ __device__ inline size_t mma_smem_bytes(int n, int pt) {
  const size_t ldn = pad16(n) + kPad;
  const size_t stage = 2 * kQ * ldn + (size_t)kQ * (pt + kPad);
  return (2 * stage + 2 * (size_t)pt * ldn) * sizeof(bf16) +
         (2 * 4 * kQ + (size_t)(kWarps / 2) * 16 * pt) * sizeof(float);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Two floats as a bf16 pair ``hi`` and the bf16 pair of what its rounding
// left out, ``lo``: hi + lo holds about 16 bits of each.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(a, b);
  const float2 r = unpack_bf16(hi);
  lo = pack_bf16(a - r.x, b - r.y);
}

// Two bf16 scaled by (f0, f1), split.
__device__ __forceinline__ void scale_split(uint32_t v, float f0, float f1, uint32_t& hi,
                                            uint32_t& lo) {
  const float2 f = unpack_bf16(v);
  split_bf16(f.x * f0, f.y * f1, hi, lo);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory; each lane gives the address
// of one row (lanes 8m..8m+7 the rows of matrix m), ``trans`` transposes.
template <bool trans>
__device__ __forceinline__ void ldsm4(uint32_t* r, const bf16* row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(row);
  if (trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

// 16 bytes from global to shared memory without passing through registers;
// zeros when !valid (``src`` must still be a mapped address).
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for every cp.async group but the last one committed.
__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows r < len and columns c < w of a row-major bf16 matrix (row stride ss)
// into a kQ x ld tile, zero from there to kQ rows and wpad <= kMaxW columns.  vec:
// w % 8 == 0 or w >= wpad, and 16-byte aligned rows: cp.async (the caller
// commits and waits); else element by element.
template <int kMaxW>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, int64_t ss,
                                          int len, int w, int wpad, bool vec, int tid) {
  if (vec) {
    constexpr int per = kMaxW / 8;  // 16-byte pieces of the widest row
    static_assert(kQ * per % kThreads == 0, "whole rounds of pieces");
#pragma unroll
    for (int k = 0; k < kQ * per / kThreads; ++k) {
      const int i = tid + k * kThreads;
      const int r = i / per, c = (i % per) * 8;
      if (c >= wpad) continue;
      const bool ok = r < len && c < w;
      cp_async16(dst + r * ld + c, ok ? src + r * ss + c : src, ok);
    }
  } else {
    for (int i = tid; i < kQ * wpad; i += kThreads) {
      const int r = i / wpad, c = i % wpad;
      dst[r * ld + c] = (r < len && c < w) ? src[r * ss + c] : __float2bfloat16(0.f);
    }
  }
}

template <int PT, bool kStates>
__global__ void __launch_bounds__(kThreads, 1)
ssd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dt,
               const float* __restrict__ A, const bf16* __restrict__ bm,
               const bf16* __restrict__ cm, const float* __restrict__ dskip,
               const float* __restrict__ h0, bf16* __restrict__ y,
               float* __restrict__ h_last, float* __restrict__ states, Strides sb, Strides sc,
               int seq, int heads, int P, int N, int vec) {
  constexpr int kNt = PT / 8;       // 8-column tiles of y and of the state
  constexpr int kLdX = PT + kPad;   // x rows
  static_assert(kNt % 2 == 0, "B operands come two column tiles at a time");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int npad = pad16(N), ldn = npad + kPad;
  // Chunk k's rows and vectors live in stage k % 2: the next chunk's loads
  // are in flight while this one's products run.
  const int stage_rows = 2 * kQ * ldn + kQ * kLdX;  // C, B (kQ x ldn), x (kQ x kLdX)
  bf16* const rows = reinterpret_cast<bf16*>(smem_raw);
  bf16* ht = rows + 2 * stage_rows;              // the state's copy h^T (PT x ldn) ...
  bf16* hl = ht + PT * ldn;                      // ... and its remainder
  // Per stage: dt in f32, cum = cumsum of la, exp(cum), exp(cum_Q - cum) dt.
  float* const vecs = reinterpret_cast<float*>(hl + PT * ldn);
  float* const part = vecs + 2 * 4 * kQ;  // partial y of 4 strips (16 x PT each)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' row group, place in it
  // This lane's row and column in the 16 x 16 ldmatrix quads: (ra, ca) for
  // A operands and for B operands read transposed, (rb, cb) for B operands
  // and for A operands read transposed.
  const int ra = (lane & 7) + ((lane >> 3) & 1) * 8, ca = (lane >> 4) * 8;
  const int rb = (lane & 7) + (lane >> 4) * 8, cb = ((lane >> 3) & 1) * 8;
  const int r0 = warp * 16;  // this warp's steps of the chunk and rows of the state
  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int np = P - p0;  // columns of this tile inside P
  const float a_h = A[h];
  const float d_h = dskip[h];

  // x, y (B, S, H, P) and dt (B, S, H) are contiguous.
  const int64_t row = (int64_t)heads * P;
  const bf16* xb = x + ((int64_t)b * seq * heads + h) * P + p0;
  bf16* yb = y + ((int64_t)b * seq * heads + h) * P + p0;
  const bf16* dtb = dt + (int64_t)b * seq * heads + h;
  const bf16* bb = bm + b * sb.b + h * sb.h;
  const bf16* cbm = cm + b * sc.b + h * sc.h;
  const int64_t hoff = ((int64_t)b * heads + h) * N * P + p0;

  // The f32 state as mma accumulators: rows n = r0 + g (+ 8), columns
  // p = 8 nt + 2t (+ 1).  Warps past N hold zeros and never update them.
  const bool owns_state = r0 < npad;
  float hacc[kNt][4];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = r0 + g + 8 * (e >> 1), p = nt * 8 + 2 * t + (e & 1);
      hacc[nt][e] = (h0 != nullptr && n < N && p < np) ? h0[hoff + (int64_t)n * P + p] : 0.f;
    }

  // C, B and x rows of chunk k into its stage, zero past the sequence, past
  // N (to npad) and past P.
  auto load_chunk = [&](int k) {
    bf16* dst = rows + (k & 1) * stage_rows;
    const int t0 = k * kQ, len = min(kQ, seq - t0);
    load_rows<kMaxN>(dst, ldn, cbm + (int64_t)t0 * sc.s, sc.s, len, N, npad, vec, tid);
    load_rows<kMaxN>(dst + kQ * ldn, ldn, bb + (int64_t)t0 * sb.s, sb.s, len, N, npad, vec,
                     tid);
    load_rows<PT>(dst + 2 * kQ * ldn, kLdX, xb + (int64_t)t0 * row, row, len, np, PT, vec,
                  tid);
  };
  // One warp: dt of chunk k, and cum = cumsum(dt A) (4 steps per lane, then
  // a scan of the lane sums), into its stage.  Zero past the sequence.
  auto scan_chunk = [&](int k) {
    float* dts = vecs + (k & 1) * 4 * kQ;
    const int t0 = k * kQ, len = min(kQ, seq - t0);
    float d[4], v[4], run = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = 4 * lane + j;
      d[j] = s < len ? __bfloat162float(dtb[(int64_t)(t0 + s) * heads]) : 0.f;
      run += d[j] * a_h;
      v[j] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    const float excl = incl - run;
    const float total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = 4 * lane + j;
      const float cj = v[j] + excl;
      dts[s] = d[j];
      dts[kQ + s] = cj;
      dts[2 * kQ + s] = expf(cj);
      dts[3 * kQ + s] = expf(total - cj) * d[j];
    }
  };

  const int nchunks = (seq + kQ - 1) / kQ;
  if (nchunks > 0) load_chunk(0);
  cp_async_commit();
  if (warp == 0 && nchunks > 0) scan_chunk(0);
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * kQ;
    const int len = min(kQ, seq - t0);
    __syncthreads();  // the previous chunk's reads of shared memory are done

    if (owns_state) {  // h^T in two bf16 parts for this chunk's C h
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = (nt * 8 + 2 * t + (e & 1)) * ldn + r0 + g + 8 * (e >> 1);
          const bf16 hi = __float2bfloat16_rn(hacc[nt][e]);
          ht[i] = hi;
          hl[i] = __float2bfloat16_rn(hacc[nt][e] - __bfloat162float(hi));
        }
      if (kStates) {  // the f32 state entering this chunk, from the accumulators
        float* sts = states + (((int64_t)b * heads + h) * nchunks + c) * N * P + p0;
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = r0 + g + 8 * (e >> 1), p = nt * 8 + 2 * t + (e & 1);
            if (n < N && p < np) sts[(int64_t)n * P + p] = hacc[nt][e];
          }
      }
    }
    if (c + 1 < nchunks) load_chunk(c + 1);
    cp_async_commit();
    cp_async_wait_all_but_last();  // this chunk's rows have landed
    __syncthreads();
    const bf16* cs = rows + (c & 1) * stage_rows;  // C rows (kQ x ldn)
    const bf16* bs = cs + kQ * ldn;                // B rows (kQ x ldn)
    const bf16* xs = bs + kQ * ldn;                // x rows (kQ x kLdX)
    const float* dts = vecs + (c & 1) * 4 * kQ;    // dt
    const float* cum = dts + kQ;                   // cumsum of la
    const float* ecum = cum + kQ;                  // exp(cum)
    const float* fw = ecum + kQ;                   // exp(cum_Q - cum) dt

    // h' = exp(cum_Q) h + Bw^T x on this warp's 16 rows of the state, over
    // the steps inside the sequence.  Bw^T is read from B's rows with
    // ldmatrix.trans, scaled in registers and split (two mmas on the same x
    // fragments).
    if (owns_state) {
      const float decay = ecum[kQ - 1];  // la is zero past the sequence
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[nt][e] *= decay;
      for (int s0 = 0; s0 < len; s0 += 16) {
        uint32_t a[4], hi[4], lo[4];
        ldsm4<true>(a, bs + (s0 + rb) * ldn + r0 + cb);
        const float f0 = fw[s0 + 2 * t], f1 = fw[s0 + 2 * t + 1];
        const float f2 = fw[s0 + 8 + 2 * t], f3 = fw[s0 + 9 + 2 * t];
        scale_split(a[0], f0, f1, hi[0], lo[0]);
        scale_split(a[1], f0, f1, hi[1], lo[1]);
        scale_split(a[2], f2, f3, hi[2], lo[2]);
        scale_split(a[3], f2, f3, hi[3], lo[3]);
#pragma unroll
        for (int nt = 0; nt < kNt; nt += 2) {
          uint32_t bx[4];
          ldsm4<true>(bx, xs + (s0 + ra) * kLdX + nt * 8 + ca);
          mma_bf16(hacc[nt], hi, bx[0], bx[1]);
          mma_bf16(hacc[nt], lo, bx[0], bx[1]);
          mma_bf16(hacc[nt + 1], hi, bx[2], bx[3]);
          mma_bf16(hacc[nt + 1], lo, bx[2], bx[3]);
        }
      }
    }

    // y = exp(cum) (C h) + G x + D x on each strip of 16 steps.  Strip i
    // has i + 1 s-tiles of the triangle, so the warps pair up: warp w < 4
    // does its own strip and the first 4 - w s-tiles of strip 7 - w, whose
    // partial y it leaves in shared memory; warp 7 - w does the other 4
    // tiles of its strip and adds that partial.  No warp does more than 5.
    float yacc[kNt][4];
    auto zero_y = [&]() {
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) yacc[nt][0] = yacc[nt][1] = yacc[nt][2] = yacc[nt][3] = 0.f;
    };
    // + G x for the strip at row0 over its s-tiles jlo..jhi, two at a time:
    // S = C B^T for the pair, then G per tile in registers and its product.
    auto triangle = [&](int row0, int jlo, int jhi) {
      const bf16* cw = cs + (row0 + ra) * ldn + ca;  // this lane's row of C's A operands
      const float cum0 = cum[row0 + g], cum1 = cum[row0 + g + 8];
      for (int j = jlo; j <= jhi; j += 2) {
        const bool two = j + 1 <= jhi;  // the pair's second tile is in the range
        float sacc[4][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) sacc[q][0] = sacc[q][1] = sacc[q][2] = sacc[q][3] = 0.f;
        for (int kk = 0; kk < npad; kk += 16) {
          uint32_t a[4], bq[4];
          ldsm4<false>(a, cw + kk);
          ldsm4<false>(bq, bs + (16 * j + rb) * ldn + kk + cb);
          mma_bf16(sacc[0], a, bq[0], bq[1]);
          mma_bf16(sacc[1], a, bq[2], bq[3]);
          if (two) {
            ldsm4<false>(bq, bs + (16 * j + 16 + rb) * ldn + kk + cb);
            mma_bf16(sacc[2], a, bq[0], bq[1]);
            mma_bf16(sacc[3], a, bq[2], bq[3]);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          if (jj == 1 && !two) break;
          const int s0 = 16 * (j + jj);
          float gv[2][4];
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int tt = row0 + g + 8 * (e >> 1);
              const int ss = s0 + 8 * q + 2 * t + (e & 1);
              gv[q][e] = ss <= tt ? sacc[2 * jj + q][e] * expf((e >> 1 ? cum1 : cum0) - cum[ss]) *
                                        dts[ss]
                                  : 0.f;
            }
          uint32_t gh[4], gl[4];
          split_bf16(gv[0][0], gv[0][1], gh[0], gl[0]);
          split_bf16(gv[0][2], gv[0][3], gh[1], gl[1]);
          split_bf16(gv[1][0], gv[1][1], gh[2], gl[2]);
          split_bf16(gv[1][2], gv[1][3], gh[3], gl[3]);
#pragma unroll
          for (int nt = 0; nt < kNt; nt += 2) {
            uint32_t bx[4];
            ldsm4<true>(bx, xs + (s0 + ra) * kLdX + nt * 8 + ca);
            mma_bf16(yacc[nt], gh, bx[0], bx[1]);
            mma_bf16(yacc[nt + 1], gh, bx[2], bx[3]);
            mma_bf16(yacc[nt], gl, bx[0], bx[1]);
            mma_bf16(yacc[nt + 1], gl, bx[2], bx[3]);
          }
        }
      }
    };
    // + D x from the exact bf16 x, rounded once and stored.
    auto store_y = [&]() {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int tt = r0 + g + 8 * r;
        if (tt >= len) continue;
        bf16* yr = yb + (int64_t)(t0 + tt) * row;
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          const int p = nt * 8 + 2 * t;
          const float2 xv = unpack_bf16(*reinterpret_cast<const uint32_t*>(xs + tt * kLdX + p));
          const float v0 = yacc[nt][2 * r] + d_h * xv.x;
          const float v1 = yacc[nt][2 * r + 1] + d_h * xv.y;
          if (vec) {  // P % 8 == 0: the pair is inside P or outside it
            if (p < np) *reinterpret_cast<uint32_t*>(yr + p) = pack_bf16(v0, v1);
          } else {
            if (p < np) yr[p] = __float2bfloat16_rn(v0);
            if (p + 1 < np) yr[p + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    };
    // A partial y of 16 rows and PT columns, in the mma accumulators' order.
    auto part_at = [&](int w, int r, int nt) {
      return part + (w * 16 + g + 8 * r) * PT + nt * 8 + 2 * t;
    };

    constexpr int kHalf = kWarps / 2;
    const bool live = r0 < len;  // this warp's strip has steps inside the sequence
    if (live) {
      zero_y();
      // exp(cum) (C h): the incoming state, both parts.
      const bf16* cw = cs + (r0 + ra) * ldn + ca;
      for (int kk = 0; kk < npad; kk += 16) {
        uint32_t a[4];
        ldsm4<false>(a, cw + kk);
#pragma unroll
        for (int nt = 0; nt < kNt; nt += 2) {
          uint32_t bh[4], bl[4];
          ldsm4<false>(bh, ht + (nt * 8 + rb) * ldn + kk + cb);
          ldsm4<false>(bl, hl + (nt * 8 + rb) * ldn + kk + cb);
          mma_bf16(yacc[nt], a, bh[0], bh[1]);
          mma_bf16(yacc[nt + 1], a, bh[2], bh[3]);
          mma_bf16(yacc[nt], a, bl[0], bl[1]);
          mma_bf16(yacc[nt + 1], a, bl[2], bl[3]);
        }
      }
      const float e0 = ecum[r0 + g], e1 = ecum[r0 + g + 8];
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        yacc[nt][0] *= e0;
        yacc[nt][1] *= e0;
        yacc[nt][2] *= e1;
        yacc[nt][3] *= e1;
      }
      triangle(r0, warp < kHalf ? 0 : warp - (kHalf - 1), warp);
    }
    if (warp < kHalf) {
      if (live) store_y();
      const int partner = kWarps - 1 - warp;
      if (16 * partner < len) {
        zero_y();
        triangle(16 * partner, 0, kHalf - 1 - warp);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt)
            *reinterpret_cast<float2*>(part_at(warp, r, nt)) =
                make_float2(yacc[nt][2 * r], yacc[nt][2 * r + 1]);
      }
    }
    // The last warp, one of the four with 4 s-tiles, takes the next chunk's
    // cumsum while the helpers finish their fifth.
    if (warp == kWarps - 1 && c + 1 < nchunks) scan_chunk(c + 1);
    __syncthreads();  // the partials are written
    if (warp >= kHalf && live) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          const float2 v = *reinterpret_cast<const float2*>(part_at(kWarps - 1 - warp, r, nt));
          yacc[nt][2 * r] += v.x;
          yacc[nt][2 * r + 1] += v.y;
        }
      store_y();
    }
  }

  if (owns_state) {
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = r0 + g + 8 * (e >> 1), p = nt * 8 + 2 * t + (e & 1);
        if (n < N && p < np) h_last[hoff + (int64_t)n * P + p] = hacc[nt][e];
      }
  }
}

// -- launchers ----------------------------------------------------------------

template <int PT>
int launch_f32(const void* x, const void* dt, const void* A, const void* bm, const void* cm,
               const void* D, const void* h0, void* y, void* h_last, void* states,
               const int64_t* st, int batch, int seq, int heads, int P, int N,
               cudaStream_t stream) {
  auto kernel = ssd_kernel<float, PT>;
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
      (const float*)x, (const float*)dt, (const float*)A, (const float*)bm, (const float*)cm,
      (const float*)D, (const float*)h0, (float*)y, (float*)h_last, (float*)states, sb, sc, seq,
      heads, P, N);
  return (int)cudaGetLastError();
}

template <int PT, bool kStates>
int launch_mma(const void* x, const void* dt, const void* A, const void* bm, const void* cm,
               const void* D, const void* h0, void* y, void* h_last, void* states,
               const int64_t* st, int batch, int seq, int heads, int P, int N, int vec,
               cudaStream_t stream) {
  auto kernel = ssd_mma_kernel<PT, kStates>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)mma_smem_bytes(kMaxN, PT));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const Strides sb{st[0], st[1], st[2]}, sc{st[3], st[4], st[5]};
  const dim3 grid((P + PT - 1) / PT, heads, batch);
  kernel<<<grid, kThreads, mma_smem_bytes(N, PT), stream>>>(
      (const bf16*)x, (const bf16*)dt, (const float*)A, (const bf16*)bm, (const bf16*)cm,
      (const float*)D, (const float*)h0, (bf16*)y, (float*)h_last, (float*)states, sb, sc, seq,
      heads, P, N, vec);
  return (int)cudaGetLastError();
}

// The P-tile with the least waves of blocks x work(pt) per block and chunk.
// Either kernel's shared-memory plan takes more than half an SM at N = 128,
// so one block fits an SM and the waves are whole.  A tile mostly past P is
// not considered.
template <typename Work>
int pick_pt(int64_t bh, int P, int sms, Work work) {
  int pt = 16;
  double best = 0.0;
  for (int cand = 16; cand <= 64 && (cand == 16 || cand / 2 < P); cand *= 2) {
    const int64_t blocks = bh * ((P + cand - 1) / cand);
    const double cost = (double)((blocks + sms - 1) / sms) * work(cand);
    if (cand == 16 || cost < best) {
      best = cost;
      pt = cand;
    }
  }
  return pt;
}

}  // namespace

// x, y (B, S, H, P) and dt (B, S, H) contiguous, of one dtype (bf16 when
// is_bf16, else f32), as are bm and cm (B, S, H, N) with a contiguous last dim
// and (b, s, h) element strides in strides[0..2] and [3..5] (h may be 0);
// A, D (H,) f32; h0 (B, H, N, P) f32 or null (zeros); h_last (B, H, N, P)
// f32; states (B, H, ceil(S / 128), N, P) f32, the state entering each
// chunk, or null (serving: the bf16 kernel is then the instantiation
// without the store).  The caller checks 1 <= N <= 128.  bf16 runs the
// tensor-core kernel, f32 the CUDA-core one.
extern "C" int ssd_fwd(const void* x, const void* dt, const void* A, const void* bm,
                       const void* cm, const void* D, const void* h0, void* y,
                       void* h_last, void* states, const int64_t* strides, int batch, int seq,
                       int heads, int P, int N, int is_bf16, void* stream) {
  if (batch <= 0 || heads <= 0 || P <= 0) return 0;
  if (N <= 0 || N > kMaxN) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t bh = (int64_t)batch * heads;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    // Work: the mma steps per chunk of a busiest warp.  C h and the state
    // update: pt/8 column tiles by npad/16 and Q/16 steps, both parts; 5
    // s-tiles of the triangle: S (2 x npad/16 steps) and G x (pt/8 column
    // tiles, both parts).  Every tile recomputes S.
    const int kn = pad16(N) / 16, ks = kQ / 16;
    const int pt = pick_pt(bh, P, sms, [&](int cand) {
      const int tiles = cand / 8;
      return 2.0 * tiles * (kn + ks) + (kWarps / 2 + 1) * (2.0 * kn + 2.0 * tiles);
    });
    // 16-byte loads of x, B and C rows and 4-byte stores of y pairs.
    const bool aligned =
        ((uintptr_t)x | (uintptr_t)bm | (uintptr_t)cm | (uintptr_t)y) % 16 == 0;
    bool vec = aligned && P % 8 == 0 && N % 8 == 0;
    for (int i = 0; i < 6; ++i) vec = vec && strides[i] % 8 == 0;
    const int v = vec ? 1 : 0;
    if (states != nullptr) {
      if (pt == 64)
        return launch_mma<64, true>(x, dt, A, bm, cm, D, h0, y, h_last, states, strides, batch,
                                    seq, heads, P, N, v, s);
      if (pt == 32)
        return launch_mma<32, true>(x, dt, A, bm, cm, D, h0, y, h_last, states, strides, batch,
                                    seq, heads, P, N, v, s);
      return launch_mma<16, true>(x, dt, A, bm, cm, D, h0, y, h_last, states, strides, batch,
                                  seq, heads, P, N, v, s);
    }
    if (pt == 64)
      return launch_mma<64, false>(x, dt, A, bm, cm, D, h0, y, h_last, states, strides, batch,
                                   seq, heads, P, N, v, s);
    if (pt == 32)
      return launch_mma<32, false>(x, dt, A, bm, cm, D, h0, y, h_last, states, strides, batch,
                                   seq, heads, P, N, v, s);
    return launch_mma<16, false>(x, dt, A, bm, cm, D, h0, y, h_last, states, strides, batch,
                                 seq, heads, P, N, v, s);
  }
  // Work: every tile recomputes C B^T (Q^2 N multiply-adds) and does
  // pt (Q^2 + 2 Q N) more.
  const int pt = pick_pt(bh, P, sms, [&](int cand) {
    return (double)kQ * kQ * N + (double)cand * (kQ * kQ + 2.0 * kQ * N);
  });
  if (pt == 64)
    return launch_f32<64>(x, dt, A, bm, cm, D, h0, y, h_last, states, strides, batch, seq, heads,
                          P, N, s);
  if (pt == 32)
    return launch_f32<32>(x, dt, A, bm, cm, D, h0, y, h_last, states, strides, batch, seq, heads,
                          P, N, s);
  return launch_f32<16>(x, dt, A, bm, cm, D, h0, y, h_last, states, strides, batch, seq, heads, P,
                        N, s);
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
