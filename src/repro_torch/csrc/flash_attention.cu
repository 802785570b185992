// Flash-attention forward for Hopper (sm_90a): online softmax over key tiles,
// causal / sliding-window / tanh soft-cap / GQA and MQA, bf16 in and out, with
// the JAX layer's prefill continuation (q_offset: query row i sits at absolute
// position q_offset + i) and ragged key lengths (kv_valid_len: key j of batch
// row b is live only if j < kv_valid_len[b]).
//
// Replaces _flash_fwd_kernel of the JAX package
// (src/repro/kernels/flash_attention/flash_attention.py:29, launched at :121).
// Its rounding follows the JAX layer that the JAX package's models run
// (_flash_fwd, src/repro/layers/attention.py:120; no model calls the Pallas
// kernel) and the port's plain version (chunked_attention_ref), not the
// Pallas kernel: q is scaled by 1/sqrt(D) in f32 and rounded to bf16 before
// Q K^T (the Pallas kernel scales the f32 product), and p is rounded to bf16
// before P V (the Pallas kernel keeps it in f32).
// That kernel runs a (B, H, q-block, k-block) grid whose last axis is
// sequential on the TPU, carrying (m, l, acc) in VMEM scratch across k-blocks,
// and reads a (B, H, S, D) layout padded to block multiples.  Here one block
// of two warpgroups owns one (batch, head, 128-query tile) and walks its key
// tiles in a loop, so the carry lives in registers; the model's (B, S, H, D)
// layout is read through strides (no transpose), and the ragged edges of
// Sq, Sk and D are zero-filled in shared memory by cp.async (no padding in
// device memory).
//
// Work skipped by loop bounds, not by masks: a query tile at absolute
// positions [q0, q1] visits key tiles from the one holding
// max(0, q0 - window + 1) (window > 0) to the one holding min(L - 1, q1)
// (causal), L the batch row's valid length (Sk without kv_valid_len), and a
// warpgroup skips a tile in which none of its 64 rows sees a key.  Only the
// tiles on the diagonal, the window's edge and the valid length's are masked
// element by element.  Masked scores are -inf and a
// row with no key yet uses 0 as its running max, so a fully masked row gives
// zeros (as the materialised reference does after its NaN clean-up).  The
// grid puts the query tile on its slowest axis, the last (heaviest) tiles
// first, and the heads on its fastest: blocks that run together read the
// same K/V tiles (under MQA, the same ones for all heads) from L2.
//
// K and V come through TMA into a ring of two tiles of 64 keys (48 x 3,
// 32 x 3 and 32 x 4 were each slower at D = 256 when the loads were
// cp.async): thread 0 issues a (64-column,
// kBlockK-key) box per column block of K and of V, completing on the
// stage's mbarrier, so tile t + 1 loads while tile t computes; one block
// barrier a tile frees the stage.  Q comes once through cp.async, and each
// thread scales the chunks it loaded by 1/sqrt(D) in f32 and rounds them
// back to bf16 (the JAX layer's q pre-scaling: at D = 128, where the scale
// is no power of two, a product scaled after the fact parts the seeded
// models' scores of some thousands by several units from the layer's, and
// decode, which pre-scales q, from prefill).  Each
// warpgroup (64 query rows) runs its products on the tensor cores with
// wgmma: S = Q K^T (m64n64k16, Q and K from shared memory), then the row
// max / sum of the online softmax on the accumulator fragments (quad
// shuffles), then O += P V (m64nDk16) with P re-packed from the S fragments
// to bf16 in registers (as the JAX layer casts p to v's dtype) and V read
// transposed from its natural rows.  Q, K and V sit in shared memory in
// 64-column blocks with the 128-byte swizzle that the wgmma descriptors and
// the tensor maps name.  The output is acc / max(l, 1e-20), written as bf16.
//
// Tiles: 128 queries by 64 keys; D rounded up to a multiple of 64.  Shared
// memory at D = 256: Q (64 KB) and two stages of K and V (32 KB each),
// 193 KB, one block per SM.
//
// Bound on this card: operations.  At recurrentgemma-9b's prefill (B = 8,
// S = 4096, H = 16, Hkv = 1, D = 256, window 2048) the live tiles hold
// 4·B·H·D·Σ_q min(q+1, window) = 8.2e11 flops against 0.27 GB of q/k/v/o,
// 3,000 flops a byte, far above the 295 at which bf16 tensor cores overtake
// memory.  Known weakness: each warpgroup waits for its S product, then for
// its softmax, then for its P V product, and the block barrier keeps the two
// warpgroups in step, so the tensor cores idle through the softmax (with
// both products switched off the kernel keeps two thirds of its time).
// Issuing the next tile's S before the softmax (waiting with
// wgmma.wait_group 1) made ptxas serialise every wgmma; ping-pong between
// the warpgroups with a producer warp is left for later work.
//
// Training asks for one more output, each row's log-sum-exp (m + log l, f32,
// in the units of the pre-scaled, soft-capped logits), which the JAX layer's
// _flash_fwd keeps as the residual of its custom VJP
// (src/repro/layers/attention.py:124): the backward (layers/attention.py,
// PyTorch ops) recomputes p from it chunk by chunk without another pass over
// K.  It is taken from the running max and sums before the epilogue inverts
// l, and one thread of each row's quad writes it; a null pointer writes
// nothing, so serving launches are unchanged.
//
// C interface, loaded with ctypes.  The launcher returns cudaGetLastError()
// right after the launch; it never synchronises and allocates nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

struct Strides {
  int64_t b, s, h;  // elements; the last dim is contiguous
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes from global memory to shared address ``dst`` without passing
// through registers; zeros when !valid (``src`` must still be mapped).
__device__ __forceinline__ void cp_async16(uint32_t dst, const bf16* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 16 bytes of shared memory at ``addr``, read and written as four words.
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// A packed bf16 pair times ``scale`` in f32, rounded back to bf16.
__device__ __forceinline__ uint32_t scale_pair(uint32_t w, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
  return pack_bf16(f.x * scale, f.y * scale);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// One arrival that also expects ``bytes`` of TMA transfers on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the barrier's phase of this parity to complete; a transfer that
// never lands traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int spins = 0; !mbar_try_wait(bar, parity); ++spins)
    if (spins > (1 << 24)) __trap();
}

// A (64-column, rows) box of a 4-d tensor map into shared memory at ``dst``
// (128-byte swizzle), completing on barrier ``bar``; coordinates innermost
// first, elements past the tensor's edges are zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// d (64 x 64 f32 accumulators of the warpgroup) += A B^T, A (64 x 16) and
// B (64 x 16) K-major in shared memory (descriptors); scale_d = 0 drops d.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64) += A B: A (64 x 16 bf16) from registers in the mma.sync
// fragment layout, B (16 x 64) N-major in shared memory (transposed read).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128) += A B: A (64 x 16 bf16) from registers in the mma.sync
// fragment layout, B (16 x 128) N-major in shared memory (transposed read).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 256) += A B: A (64 x 16 bf16) from registers in the mma.sync
// fragment layout, B (16 x 256) N-major in shared memory (transposed read).
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

constexpr int kBlockK = 64;  // keys a tile
constexpr int kStages = 2;   // tiles of K and of V in the ring

// kD: head dim rounded up to a multiple of 64 (zero-filled past d), one
// 128-byte swizzle atom of bf16 per 64 columns.
template <int kD>
struct Tiles {
  static constexpr int kWarpgroups = 2;
  static constexpr int kThreads = kWarpgroups * 128;
  static constexpr int kBlockQ = kWarpgroups * 64;      // 64 query rows a warpgroup
  static constexpr int kQBytes = kBlockQ * kD * 2;
  static constexpr int kKVBytes = kBlockK * kD * 2;     // one K or V stage
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr size_t kBytes = (size_t)kBarOffset + 8 * kStages + 1024;  // + alignment
};

// Byte offset of 16-byte chunk ``c`` (columns 8c .. 8c + 7) of row ``row``
// in a tile of ``rows`` rows: 64-column blocks one after another, each
// rows x 128 bytes with the 128-byte swizzle (chunk index XOR row % 8), the
// layout the wgmma descriptors below describe.
__device__ __forceinline__ uint32_t swizzled(int rows, int row, int c) {
  return (uint32_t)((c >> 3) * rows * 128 + row * 128 + (((c & 7) ^ (row & 7)) << 4));
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
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
// Ties registers written by an asynchronous wgmma to this point: no read of
// them moves above the wait before it.
template <int kN>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// cp.async writes go through the generic proxy; wgmma reads through the
// async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int kN>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b) {
  if constexpr (kN == 64) wgmma_rs_n64(d, a, b);
  else if constexpr (kN == 128) wgmma_rs_n128(d, a, b);
  else wgmma_rs_n256(d, a, b);
}

// Rows [r0, r0 + rows) of a (rows, kD) swizzled tile at shared address
// ``dst`` from ``src`` (row stride ``ss``): rows at or past ``limit`` and
// columns at or past d are zero-filled.  The caller commits.
template <int kD, int kThreads>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int64_t ss, int r0,
                                          int rows, int limit, int d, int tid) {
  constexpr int kChunks = kD / 8;  // 16-byte chunks per row
  for (int c = tid; c < rows * kChunks; c += kThreads) {
    const int row = c / kChunks, ch = c % kChunks;
    const bool ok = r0 + row < limit && ch * 8 < d;
    cp_async16(dst + swizzled(rows, row, ch),
               ok ? src + (int64_t)(r0 + row) * ss + ch * 8 : src, ok);
  }
}

template <int kD>
__global__ void __launch_bounds__(Tiles<kD>::kThreads, 1)
flash_fwd_kernel(const bf16* __restrict__ q, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, Strides sq_,
                 Strides so_, int sq, int sk, int heads, int kv_heads, int d, float scale,
                 int causal, int window, float cap, int q_off,
                 const int* __restrict__ kv_len, float* __restrict__ lse) {
  using T = Tiles<kD>;
  constexpr int kThreads = T::kThreads;
  extern __shared__ unsigned char smem_raw[];
  // Swizzle atoms need 1024-byte aligned tiles.
  const uint32_t qs = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t ks = qs + T::kQBytes;              // kStages tiles of K
  const uint32_t vs = ks + kStages * T::kKVBytes;   // kStages tiles of V
  const uint32_t full = qs + T::kBarOffset;         // kStages barriers: tile landed

  const int tid = threadIdx.x;
  const int wg = tid >> 7;            // warpgroup
  const int warp = (tid >> 5) & 3;    // warp in the warpgroup
  const int lane = tid & 31;
  const int g = lane >> 2;  // row group of the fragments
  const int t = lane & 3;   // thread in the group
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * T::kBlockQ;  // heaviest tiles first
  const int hk = h / (heads / kv_heads);

  const bf16* qb = q + b * sq_.b + h * sq_.h;

  // Key tiles this query tile can see: its rows sit at absolute positions
  // q_off + row, and keys at or past the batch row's valid length are dead.
  const int sk_b = kv_len != nullptr ? max(0, min(sk, kv_len[b])) : sk;
  const int q_last = min(q0 + T::kBlockQ, sq) - 1;
  const int k_hi = causal ? min(sk_b, q_off + q_last + 1) : sk_b;  // exclusive
  const int k_lo = window > 0 ? max(0, q_off + q0 - window + 1) : 0;
  const int tile_lo = k_lo / kBlockK;
  const int tile_hi = (k_hi + kBlockK - 1) / kBlockK;

  // Tile tile_lo + j goes into stage j % kStages through TMA, issued by
  // thread 0: a (64-column, kBlockK-key) box per column block of K and of
  // V, all completing on the stage's barrier.  The ring starts with
  // kStages - 1 tiles in flight.
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) mbar_init(full + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_kv = [&](int j) {
    const int tile = tile_lo + j;
    if (tid != 0 || tile >= tile_hi) return;
    const int st = j % kStages;
    mbar_expect_tx(full + 8 * st, 2 * T::kKVBytes);
#pragma unroll
    for (int cb = 0; cb < kD / 64; ++cb) {
      tma_load(ks + st * T::kKVBytes + cb * kBlockK * 128, &tk, full + 8 * st, cb * 64, hk,
               tile * kBlockK, b);
      tma_load(vs + st * T::kKVBytes + cb * kBlockK * 128, &tv, full + 8 * st, cb * 64, hk,
               tile * kBlockK, b);
    }
  };
  load_tile<kD, kThreads>(qs, qb, sq_.s, q0, T::kBlockQ, sq, d, tid);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load_kv(j);
  cp_async_wait_all();  // Q landed; each thread scales the chunks it loaded ...
  for (int c = tid; c < T::kBlockQ * (kD / 8); c += kThreads) {
    const uint32_t at = qs + swizzled(T::kBlockQ, c / (kD / 8), c % (kD / 8));
    uint4 w = lds128(at);
    w.x = scale_pair(w.x, scale);
    w.y = scale_pair(w.y, scale);
    w.z = scale_pair(w.z, scale);
    w.w = scale_pair(w.w, scale);
    sts128(at, w);
  }
  fence_proxy_async();  // ... visible to wgmma ...
  __syncthreads();      // ... for every warp

  constexpr int kNt = kBlockK / 8;  // n-tiles of S
  constexpr int kDt = kD / 8;       // n-tiles of O
  float acc[kDt][4];
#pragma unroll
  for (int i = 0; i < kDt; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int g0 = q0 + wg * 64;        // this warpgroup's first query row
  const int r0 = g0 + warp * 16;      // this warp's first query row
  const int rows[2] = {r0 + g, r0 + g + 8};
  const int g_last = min(g0 + 63, sq - 1);
  // Descriptors: Q and K K-major (rows of 128 bytes, 8-row groups 1024
  // bytes apart), V N-major (8-key groups 1024 bytes apart, 64-column
  // blocks kBlockK x 128 bytes apart).
  const uint32_t qw = qs + wg * 64 * 128;

  for (int tile = tile_lo, it = 0; tile < tile_hi; ++tile, ++it) {
    const int kt0 = tile * kBlockK;
    const int st = it % kStages;
    // Every warp is done with the stage read last tile: refill it.
    __syncthreads();
    load_kv(it + kStages - 1);
    mbar_wait(full + 8 * st, (it / kStages) & 1);  // this tile landed
    // A warpgroup none of whose rows sees a key of this tile skips it.
    if (g0 >= sq || (causal && kt0 > q_off + g_last) ||
        (window > 0 && kt0 + kBlockK - 1 <= q_off + g0 - window))
      continue;
    const uint32_t kt = ks + st * T::kKVBytes;
    const uint32_t vt = vs + st * T::kKVBytes;

    // S = Q K^T for this warpgroup's 64 rows and the tile's keys.
    float s[kNt][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;  // 16 columns a step inside the atom
      wgmma_ss_n64(&s[0][0], desc(qw + (kk >> 2) * T::kBlockQ * 128 + off, 16, 1024),
                   desc(kt + (kk >> 2) * kBlockK * 128 + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kNt * 4>(&s[0][0]);

    // Soft-cap, mask; online softmax per row (Q came scaled).
    const bool edge = (kt0 + kBlockK > sk_b) || (causal && kt0 + kBlockK - 1 > q_off + r0) ||
                      (window > 0 && kt0 <= q_off + r0 + 15 - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e];
        if (cap > 0.f) x = cap * tanhf(x / cap);
        if (edge) {
          const int qp = q_off + rows[e >> 1];
          const int kp = kt0 + n * 8 + 2 * t + (e & 1);
          const bool ok = kp < sk_b && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
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
    uint32_t p[kBlockK / 16][4];  // P in bf16 as A fragments, 16 keys each
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = __expf(s[n][e] - m_use[e >> 1]);
        s[n][e] = pe;
        l_run[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      p[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      p[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      p[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      p[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }

    // O += P V, 16 keys a step; V's 8-key groups are 1024 bytes apart.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk)
      wgmma_rs<kD>(&acc[0][0], p[kk], desc(vt + kk * 16 * 128, kBlockK * 128, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kDt * 4>(&acc[0][0]);
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk)  // P stays in its registers until here
      asm volatile("" : "+r"(p[kk][0]), "+r"(p[kk][1]), "+r"(p[kk][2]), "+r"(p[kk][3])::"memory");
  }

  // Row sums across the quad; the row's log-sum-exp when asked for (the
  // sums were rescaled to the last tile's m_use, which is m_run or 0 for a
  // row that saw no key), then normalise and store bf16 pairs.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    if (lse != nullptr && t == 0 && rows[r] < sq) {
      const float m_fin = m_run[r] == -INFINITY ? 0.f : m_run[r];
      lse[((int64_t)b * heads + h) * sq + rows[r]] = m_fin + logf(fmaxf(l_run[r], 1e-20f));
    }
    l_run[r] = 1.f / fmaxf(l_run[r], 1e-20f);
  }
  bf16* ob = o + b * so_.b + h * so_.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= sq) continue;
    bf16* orow = ob + (int64_t)rows[r] * so_.s;
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime (no link
// against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) ==
        cudaSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, S, Hkv, D) bf16 tensor with element strides (b, s, h) as a 4-d
// tensor map (D, Hkv, S, B), read in (64, 1, keys, 1) boxes with the
// 128-byte swizzle; zeros past its edges.
bool tensor_map(CUtensorMap* map, const void* base, int batch, int seq, int kv_heads, int d,
                const int64_t* stride, int keys) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)kv_heads, (cuuint64_t)seq,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)stride[2] * 2, (cuuint64_t)stride[1] * 2,
                                 (cuuint64_t)stride[0] * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)keys, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kD>
int launch(const void* q, const void* k, const void* v, void* o, const int64_t* st,
           int batch, int sq, int sk, int heads, int kv_heads, int d, float scale,
           int causal, int window, float cap, int q_off, const int* kv_len, float* lse,
           cudaStream_t stream) {
  using T = Tiles<kD>;
  auto kernel = flash_fwd_kernel<kD>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap tk, tv;
  if (!tensor_map(&tk, k, batch, sk, kv_heads, d, st + 3, kBlockK) ||
      !tensor_map(&tv, v, batch, sk, kv_heads, d, st + 6, kBlockK))
    return (int)cudaErrorInvalidValue;
  const Strides sq_{st[0], st[1], st[2]}, so_{st[9], st[10], st[11]};
  const dim3 grid(heads, batch, (sq + T::kBlockQ - 1) / T::kBlockQ);
  kernel<<<grid, T::kThreads, T::kBytes, stream>>>((const bf16*)q, tk, tv, (bf16*)o, sq_,
                                                    so_, sq, sk, heads, kv_heads, d, scale,
                                                    causal, window, cap, q_off, kv_len,
                                                    lse);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, Hkv, D), o (B, Sq, H, D), all bf16 with a
// contiguous last dim; strides[12] = (b, s, h) element strides of q, k, v, o.
// q_offset >= 0 is the absolute position of query row 0; kv_len is a (B,)
// int32 array on the device, or null for Sk keys in every row.  lse, when not
// null, is a (B, H, Sq) f32 array that receives each row's log-sum-exp of the
// scaled (and soft-capped) logits, m + log(l) in natural log; serving passes
// null and nothing is written.  The caller checks D <= 256, D % 8 == 0,
// 16-byte alignment, H % Hkv == 0 and B below 65,536.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   const int64_t* strides, int batch, int sq, int sk,
                                   int heads, int kv_heads, int d, float scale, int causal,
                                   int window, float cap, int q_offset, const void* kv_len,
                                   void* lse, void* stream) {
  if (batch <= 0 || sq <= 0 || heads <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int* kl = (const int*)kv_len;
  float* ls = (float*)lse;
  if (d <= 64)
    return launch<64>(q, k, v, o, strides, batch, sq, sk, heads, kv_heads, d, scale, causal,
                      window, cap, q_offset, kl, ls, s);
  if (d <= 128)
    return launch<128>(q, k, v, o, strides, batch, sq, sk, heads, kv_heads, d, scale, causal,
                       window, cap, q_offset, kl, ls, s);
  return launch<256>(q, k, v, o, strides, batch, sq, sk, heads, kv_heads, d, scale, causal,
                     window, cap, q_offset, kl, ls, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
