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
// Training: ``carries`` (optional) receives the state entering each chunk,
// written by warp 0 before the chunk's scan; a null pointer launches the
// instantiation without the store, the same code as serving ran before.
// ``rglru_scan_bwd`` (below) is the gradient, from those carries.
//
// C interface, loaded with ctypes: pointers and the stream are void*.  The
// launchers return cudaGetLastError() right after the launch; they never
// synchronise and allocate nothing.

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

// Chunks in shared memory at once, each of kTensors tiles: bf16 three (the
// forward's three tensors 72 KB, the backward's four 96 KB), f32 two (96 KB,
// 128 KB).
template <typename T, int kTensors = 3>
struct Ring {
  static constexpr int kStages = sizeof(T) == 2 ? 3 : 2;
  static constexpr int kPer = kLanes * (int)sizeof(T) / 16;  // 16-byte pieces of a row
  static constexpr size_t kTile = (size_t)kChunk * kLanes;    // one tensor's chunk
  static constexpr size_t kBytes = kStages * kTensors * kTile * sizeof(T);
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

template <typename T, bool kCarries>
__global__ void __launch_bounds__(kThreads, 2)
rglru_kernel(const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ i,
             const float* __restrict__ a_param, const float* __restrict__ h0,
             T* __restrict__ y, float* __restrict__ h_last, float* __restrict__ carries,
             int seq, int width, int vec) {
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
    // The state entering each chunk, for the backward (training only).
    if (kCarries && warp == 0 && live)
      carries[((int64_t)b * chunks + ch) * width + n] = carry;
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

template <typename T, bool kCarries>
int launch(const void* x, const void* r, const void* i, const void* a_param,
           const void* h0, void* y, void* h_last, void* carries, int batch, int seq,
           int width, cudaStream_t stream) {
  using R = Ring<T>;
  auto kernel = rglru_kernel<T, kCarries>;
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
      (T*)y, (float*)h_last, (float*)carries, seq, width, vec);
  return (int)cudaGetLastError();
}


// -- the backward ---------------------------------------------------------------
//
// With e_t = a_t g_t, the gradient g_t of h_t is the reverse recurrence
//
//   g_t = dy_t + e_{t+1},   e_S = dh_last (the step past S has a = 1),
//
// the forward's recurrence with time flipped, so it is scanned as the forward
// is: each warp runs its 8 steps from e = 0 (last step first) and leaves the
// pair (product of its a, e at its first step); warp w's e_in is the carry
// from the chunk after combined with the warps after w (combine((P, e), E) =
// P E + e), and the carry for the chunk before is combined with all 16.
// Chunks are walked from last to first.  h_{t-1}, which d a_t needs, is
// recomputed in f32 from the chunk's saved carry (the forward's ``carries``)
// with the forward's sub-segment scan, not from y (rounded to x's dtype).
// Per step, with a^2 = a a, u = beta i x and beta = sqrt(max(1 - a^2, 1e-12)):
//
//   dlog_a = g h_{t-1} a - [1 - a^2 > 1e-12] g i x a^2 / beta
//   dr = -8 softplus(a_param) dlog_a,  di = g beta x,  dx = g beta i,
//
// d a_param = sum -8 sigmoid(a_param) r dlog_a goes out as one f32 partial a
// (b, chunk, channel), summed over the warps in a fixed order (no atomics),
// and dh0 = e_0.  Rows past S load as zeros (a = 1, u = 0, dy = 0), so g
// passes through them unchanged and they add nothing.  The JAX package has
// no backward kernel: its gradient is autodiff of the layer's associative
// scan (src/repro/layers/rglru.py:rglru_scan).
//
// Bound on this card: bytes.  x, r, i and dy are read and dx, dr and di
// written once, 14 bytes an element in bf16 (0.140 ms at B = 2, S = N =
// 4096); the carries and partials are 1/128 of that.  The design keeps
// loads in flight and the SM's issue slots free for them:
// - x, r, i and dy come through cp.async into a ring of chunks in shared
//   memory (bf16: three stages of 32 KB; f32: two of 64 KB), filled from
//   the last chunk back, so two chunks load while one is computed;
// - nothing is prefetched into registers, so a thread fits in 64 registers
//   and two 512-thread blocks share an SM in bf16 (106 KB of shared memory
//   each): at B = 2, N = 4096 all 256 blocks are resident at once;
// - each thread writes its dx, dr and di over its own x, r and i in the
//   stage; after the next chunk's barrier every thread copies the 16-byte
//   pieces it loaded out to device memory, then refills them (so the drain
//   needs no barrier of its own: two a chunk, as before);
// - the gate math runs once: a = exp(log_a) and 1 / beta (one rsqrtf) stay
//   in registers from the first pass; a^2 is a a, and beta is
//   max(1 - a^2, 1e-12) times 1 / beta: no second expf, no sqrtf, no
//   division.
// N not a multiple of 32, or a row not 16-byte aligned: each thread copies
// its own elements in and out of the ring, without the overlap.

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rglru_bwd_kernel(const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ i,
                 const float* __restrict__ a_param, const float* __restrict__ carries,
                 const T* __restrict__ dy, const float* __restrict__ dh_last,
                 T* __restrict__ dx, T* __restrict__ dr, T* __restrict__ di,
                 float* __restrict__ dh0, float* __restrict__ da_part, int seq, int width,
                 int vec) {
  using R = Ring<T, 4>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage s, tensor (x, r, i, dy): a (kChunk, kLanes) tile of that chunk's
  // rows; the first three hold (dx, dr, di) once the chunk is computed.
  T* ring = reinterpret_cast<T*>(smem_raw);
  // Per warp and lane: the forward scan's (product of a, h) and the reverse
  // scan's (product of a, e) at the end of its sub-segment; d a_param sums.
  __shared__ float2 fwd[kWarps][kLanes];
  __shared__ float2 bwd[kWarps][kLanes];
  __shared__ float red[kWarps][kLanes];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kLanes;
  const int n = n0 + lane;
  const int b = blockIdx.y;
  const bool live = n < width;
  const float ap = live ? a_param[n] : 0.f;
  const float c = -kC * (log1pf(expf(-fabsf(ap))) + fmaxf(ap, 0.f));
  const float dc = -kC / (1.f + expf(-ap));  // d log_a / d a_param, over r
  const int64_t base = (int64_t)b * seq * width;
  const int chunks = (seq + kChunk - 1) / kChunk;
  // Tensor m of (x, r, i, dy) and of (dx, dr, di); m is a constant once
  // the loops over it are unrolled, so no pointer is held in registers.
  auto in = [&](int m) { return m == 0 ? x : m == 1 ? r : m == 2 ? i : dy; };
  auto out = [&](int m) { return m == 0 ? dx : m == 1 ? dr : di; };
  float e_carry = (dh_last != nullptr && live) ? dh_last[(int64_t)b * width + n] : 0.f;

  // Chunk ``ch`` into stage ``s``, zeros past S and past N: as the
  // forward's ``issue``, with dy as a fourth tensor.
  auto issue = [&](int ch, int s) {
    T* stage = ring + s * 4 * R::kTile;
    const int t0 = ch * kChunk;
    if (vec) {
#pragma unroll
      for (int k = 0; k < kChunk * R::kPer / kThreads; ++k) {
        const int piece = tid + k * kThreads;
        const int row = piece / R::kPer;
        const int col = (piece % R::kPer) * (16 / (int)sizeof(T));
        const bool ok = t0 + row < seq;
        const int64_t off = ok ? base + (int64_t)(t0 + row) * width + n0 + col : 0;
#pragma unroll
        for (int m = 0; m < 4; ++m)
          cp_async16(stage + m * R::kTile + row * kLanes + col, in(m) + off, ok);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int row = warp * kSteps + j;
        const bool ok = live && t0 + row < seq;
        const int64_t off = base + (int64_t)(t0 + row) * width + n;
#pragma unroll
        for (int m = 0; m < 4; ++m)
          stage[m * R::kTile + row * kLanes + lane] = ok ? in(m)[off] : T(0.f);
      }
    }
  };
  // Chunk ``ch``'s (dx, dr, di) from stage ``s`` out to device memory, each
  // thread the pieces (or elements) that its ``issue`` loaded, rows before S.
  auto drain = [&](int ch, int s) {
    const T* stage = ring + s * 4 * R::kTile;
    const int t0 = ch * kChunk;
    if (vec) {
#pragma unroll
      for (int k = 0; k < kChunk * R::kPer / kThreads; ++k) {
        const int piece = tid + k * kThreads;
        const int row = piece / R::kPer;
        const int col = (piece % R::kPer) * (16 / (int)sizeof(T));
        if (t0 + row >= seq) continue;
        const int64_t off = base + (int64_t)(t0 + row) * width + n0 + col;
#pragma unroll
        for (int m = 0; m < 3; ++m)
          *reinterpret_cast<uint4*>(out(m) + off) =
              *reinterpret_cast<const uint4*>(stage + m * R::kTile + row * kLanes + col);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int row = warp * kSteps + j;
        if (!live || t0 + row >= seq) continue;
        const int64_t off = base + (int64_t)(t0 + row) * width + n;
#pragma unroll
        for (int m = 0; m < 3; ++m) out(m)[off] = stage[m * R::kTile + row * kLanes + lane];
      }
    }
  };
  // Chunk ``ch``'s d a_param partial: the warps' sums in order.
  auto partial = [&](int ch) {
    if (warp != 0 || !live) return;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][lane];
    da_part[((int64_t)b * chunks + ch) * width + n] = s;
  };

  // Step k of the loop computes chunk chunks - 1 - k in stage k % kStages.
#pragma unroll
  for (int k = 0; k < R::kStages - 1; ++k) {
    if (k < chunks) issue(chunks - 1 - k, k);
    cp_async_commit();
  }
  for (int k = 0; k < chunks; ++k) {
    const int ch = chunks - 1 - k;
    const float h_chunk = live ? carries[((int64_t)b * chunks + ch) * width + n] : 0.f;
    cp_async_wait<R::kStages - 2>();  // this chunk landed
    __syncthreads();  // ... for every warp; the chunk after's gradients are in its stage
    if (k > 0) {
      // Out with the chunk after, and its stage refilled by the same pieces.
      drain(ch + 1, (k - 1) % R::kStages);
      partial(ch + 1);
    }
    if (k + R::kStages - 1 < chunks)
      issue(ch - (R::kStages - 1), (k + R::kStages - 1) % R::kStages);
    cp_async_commit();
    // This warp's steps of the four tiles, at its lane's channel.
    T* tx = ring + (k % R::kStages) * 4 * R::kTile + warp * kSteps * kLanes + lane;
    T* tr = tx + R::kTile;
    T* ti = tx + 2 * R::kTile;
    const T* td = tx + 3 * R::kTile;
    // The gates, the forward's sub-segment scan from h = 0 and the reverse
    // scan from e = 0.
    float a[kSteps], inv_beta[kSteps], hs[kSteps], ps[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      a[j] = ps[j] = expf(c * to_f32(tr[j * kLanes]));
      const float m = fmaxf(1.f - a[j] * a[j], 1e-12f);
      inv_beta[j] = rsqrtf(m);
      hs[j] = (m * inv_beta[j]) * (to_f32(ti[j * kLanes]) * to_f32(tx[j * kLanes]));
    }
#pragma unroll
    for (int j = 1; j < kSteps; ++j) {
      hs[j] = ps[j] * hs[j - 1] + hs[j];
      ps[j] = ps[j] * ps[j - 1];
    }
    float e = 0.f;
#pragma unroll
    for (int j = kSteps - 1; j >= 0; --j) e = a[j] * (to_f32(td[j * kLanes]) + e);
    fwd[warp][lane] = make_float2(ps[kSteps - 1], hs[kSteps - 1]);
    bwd[warp][lane] = make_float2(ps[kSteps - 1], e);
    __syncthreads();
    float h_in = h_chunk, h = h_chunk;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp) h_in = h;
      const float2 pw = fwd[w][lane];
      h = pw.x * h + pw.y;
    }
    float e_in = e_carry, ee = e_carry;
#pragma unroll
    for (int w = kWarps - 1; w >= 0; --w) {
      if (w == warp) e_in = ee;
      const float2 pw = bwd[w][lane];
      ee = pw.x * ee + pw.y;
    }
    e_carry = ee;
    // g from e_in, h_{t-1} as the forward forms h, and the gate gradients,
    // each written over the input of the same step: dx over x, dr over r,
    // di over i.
    float dap = 0.f;
    e = e_in;
#pragma unroll
    for (int j = kSteps - 1; j >= 0; --j) {
      const float g = to_f32(td[j * kLanes]) + e;
      const float h_prev = j > 0 ? hs[j - 1] + ps[j - 1] * h_in : h_in;
      const float rv = to_f32(tr[j * kLanes]), iv = to_f32(ti[j * kLanes]),
                  xv = to_f32(tx[j * kLanes]);
      const float a2 = a[j] * a[j];
      const float om = 1.f - a2;
      const float beta = fmaxf(om, 1e-12f) * inv_beta[j];
      float dlog = g * h_prev * a[j];
      if (om > 1e-12f) dlog -= g * (iv * xv) * a2 * inv_beta[j];  // jnp.maximum's gradient
      dap = fmaf(dc * rv, dlog, dap);
      store(tx + j * kLanes, g * beta * iv);
      store(tr + j * kLanes, c * dlog);
      store(ti + j * kLanes, g * beta * xv);
      e = a[j] * g;
    }
    red[warp][lane] = dap;
  }
  __syncthreads();
  if (chunks > 0) {
    drain(0, (chunks - 1) % R::kStages);
    partial(0);
  }
  cp_async_wait<0>();  // nothing may be in flight when the block exits
  if (warp == 0 && live) dh0[(int64_t)b * width + n] = e_carry;
}

// The dynamic shared memory above 48 KB, once an instantiation.
template <typename T>
cudaError_t configure_bwd() {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(rglru_bwd_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)Ring<T, 4>::kBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  return cudaSuccess;
}

template <typename T>
int launch_bwd(const void* x, const void* r, const void* i, const void* a_param,
               const void* carries, const void* dy, const void* dh_last, void* dx, void* dr,
               void* di, void* dh0, void* da_part, int batch, int seq, int width,
               cudaStream_t stream) {
  cudaError_t err = configure_bwd<T>();
  if (err != cudaSuccess) return (int)err;
  // The ring's 16-byte pieces need whole 32-channel tiles and aligned rows.
  const bool aligned = ((uintptr_t)x | (uintptr_t)r | (uintptr_t)i | (uintptr_t)dy |
                        (uintptr_t)dx | (uintptr_t)dr | (uintptr_t)di) % 16 == 0;
  const int vec = aligned && width % kLanes == 0;
  const dim3 grid((width + kLanes - 1) / kLanes, batch);
  rglru_bwd_kernel<T><<<grid, kThreads, Ring<T, 4>::kBytes, stream>>>(
      (const T*)x, (const T*)r, (const T*)i, (const float*)a_param, (const float*)carries,
      (const T*)dy, (const float*)dh_last, (T*)dx, (T*)dr, (T*)di, (float*)dh0,
      (float*)da_part, seq, width, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_resources(int* registers, int* blocks_per_sm) {
  cudaError_t err = configure_bwd<T>();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, rglru_bwd_kernel<T>);
  if (err != cudaSuccess) return (int)err;
  *registers = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, rglru_bwd_kernel<T>, kThreads, Ring<T, 4>::kBytes);
}

}  // namespace

// x, r, i, y: contiguous (B, S, N) of one dtype (bf16 when is_bf16, else
// f32); a_param (N,) f32; h0 (B, N) f32 or null (zeros); h_last (B, N) f32;
// carries (B, ceil(S / 128), N) f32, the state entering each chunk, or null
// (serving: nothing written, the kernel the same as without the argument).
extern "C" int rglru_scan(const void* x, const void* r, const void* i, const void* a_param,
                          const void* h0, void* y, void* h_last, void* carries, int batch,
                          int seq, int width, int is_bf16, void* stream) {
  if (batch <= 0 || width <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return carries ? launch<__nv_bfloat16, true>(x, r, i, a_param, h0, y, h_last, carries,
                                                 batch, seq, width, s)
                   : launch<__nv_bfloat16, false>(x, r, i, a_param, h0, y, h_last, carries,
                                                  batch, seq, width, s);
  return carries ? launch<float, true>(x, r, i, a_param, h0, y, h_last, carries, batch, seq,
                                       width, s)
                 : launch<float, false>(x, r, i, a_param, h0, y, h_last, carries, batch, seq,
                                        width, s);
}

// x, r, i, dy, dx, dr, di: contiguous (B, S, N) of one dtype; a_param (N,)
// f32; carries (B, ceil(S / 128), N) f32 from rglru_scan (chunk 0's is h0);
// dh_last (B, N) f32 or null (zeros); dh0 (B, N) and da_part
// (B, ceil(S / 128), N) f32, the caller sums da_part over its first two dims.
extern "C" int rglru_scan_bwd(const void* x, const void* r, const void* i, const void* a_param,
                              const void* carries, const void* dy, const void* dh_last,
                              void* dx, void* dr, void* di, void* dh0, void* da_part, int batch,
                              int seq, int width, int is_bf16, void* stream) {
  if (batch <= 0 || width <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch_bwd<__nv_bfloat16>(x, r, i, a_param, carries, dy, dh_last, dx, dr, di, dh0,
                                     da_part, batch, seq, width, s);
  return launch_bwd<float>(x, r, i, a_param, carries, dy, dh_last, dx, dr, di, dh0, da_part,
                           batch, seq, width, s);
}

// The backward's registers a thread and blocks an SM (for the record).
extern "C" int rglru_bwd_resources(int is_bf16, int* registers, int* blocks_per_sm) {
  return is_bf16 ? bwd_resources<__nv_bfloat16>(registers, blocks_per_sm)
                 : bwd_resources<float>(registers, blocks_per_sm);
}

extern "C" const char* rglru_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
