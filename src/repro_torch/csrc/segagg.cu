// GROUP-BY partial aggregation for Hopper (sm_90a): out[key_i, :] += values[i, :].
//
// Two kernels, the counterparts of the two Pallas kernels of the JAX package
// (src/repro/kernels/segagg/segagg.py):
//
// * segagg_scatter replaces _segagg_scatter_kernel (segagg.py:75), which walks
//   each row block serially into a (G, 128)-padded accumulator resident in
//   VMEM.  Here one thread handles one (row, v) element in a grid-stride loop
//   and adds it with a global atomicAdd into the zeroed (G, V) f32 output.
//   The wide-G accumulators of the paper's queries (CQ3: 360K groups, 1.4 MB;
//   CQ4: 1.5M groups, 6 MB) do not fit a block's shared memory but stay in
//   the 50 MB L2, where the atomics resolve.  Bound: the bytes it must move,
//   4N (keys) + 4NV (values) + 4GV (output), at 3.35 TB/s.  Known weakness:
//   skewed keys contend on the atomics of their hot groups.
//
// * segagg_narrow replaces _segagg_matmul_kernel (segagg.py:48), the one-hot
//   MXU contraction used for narrow G.  Each block walks a strided range of
//   elements and accumulates into a (G, V) f32 table in shared memory (at most
//   48 KB, checked by the caller); at the end each block adds its table into
//   the output with one global atomicAdd per non-zero (g, v).  When G*V is at
//   most 32 every thread first sums its own elements in registers, one per
//   (g, v) slot, and each warp combines its lanes by shuffle reduction before
//   one shared atomic per slot: CQ1 and TPC-Q6 (G = 1) would otherwise
//   serialise 32 ways on one shared address.  Bound: the same bytes.
//
// Both kernels mask the ragged edge themselves (no padding of N, G or V) and
// drop keys outside [0, G), negative ones included.  Additions happen in an
// order that changes from run to run; integer-valued sums (COUNT) stay exact
// while every per-group total is below 2^24.
//
// C interface, loaded with ctypes: pointers and the stream are void*, row
// counts int64.  Each launcher returns cudaGetLastError() right after the
// launch (0 on success); it never synchronises and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSmScatter = 8;
constexpr int kBlocksPerSmNarrow = 4;

int num_sms() {
  int dev = 0;
  int sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

int grid_for(int64_t elements, int blocks_per_sm) {
  const int64_t needed = (elements + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)num_sms() * blocks_per_sm;
  return (int)(needed < cap ? needed : cap);
}

// Row and value column of flat element e of a row-major (N, V) array.
__device__ __forceinline__ void split_element(int64_t e, int32_t v, int64_t* row,
                                              int32_t* col) {
  if (v == 1) {
    *row = e;
    *col = 0;
  } else {
    *row = e / v;
    *col = (int32_t)(e - *row * v);
  }
}

__global__ void __launch_bounds__(kThreads)
segagg_scatter_kernel(const int32_t* __restrict__ keys, const float* __restrict__ values,
                      float* __restrict__ out, int64_t n, int32_t v, int64_t g) {
  const int64_t total = n * v;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    int64_t row;
    int32_t col;
    split_element(e, v, &row, &col);
    const int32_t k = __ldg(keys + row);
    if (k >= 0 && (int64_t)k < g) {
      atomicAdd(out + (int64_t)k * v + col, __ldg(values + e));
    }
  }
}

// kSlots > 0: register accumulation for G*V <= kSlots; kSlots == 0: shared
// atomics per element.
template <int kSlots>
__global__ void __launch_bounds__(kThreads)
segagg_narrow_kernel(const int32_t* __restrict__ keys, const float* __restrict__ values,
                     float* __restrict__ out, int64_t n, int32_t v, int32_t g) {
  extern __shared__ float table[];  // (g, v) f32
  const int32_t gv = g * v;
  for (int32_t i = threadIdx.x; i < gv; i += blockDim.x) table[i] = 0.f;
  __syncthreads();

  const int64_t total = n * v;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (kSlots > 0) {
    float acc[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) acc[s] = 0.f;
    for (int64_t e = first; e < total; e += stride) {
      int64_t row;
      int32_t col;
      split_element(e, v, &row, &col);
      const int32_t k = __ldg(keys + row);
      const int32_t slot = (k >= 0 && k < g) ? k * v + col : -1;
      const float x = __ldg(values + e);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) acc[s] += (slot == s) ? x : 0.f;
    }
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      float x = acc[s];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0 && s < gv) atomicAdd(table + s, x);
    }
  } else {
    for (int64_t e = first; e < total; e += stride) {
      int64_t row;
      int32_t col;
      split_element(e, v, &row, &col);
      const int32_t k = __ldg(keys + row);
      if (k >= 0 && k < g) atomicAdd(table + k * v + col, __ldg(values + e));
    }
  }
  __syncthreads();
  for (int32_t i = threadIdx.x; i < gv; i += blockDim.x) {
    const float x = table[i];
    if (x != 0.f) atomicAdd(out + i, x);
  }
}

template <int kSlots>
void launch_narrow(const int32_t* keys, const float* values, float* out, int64_t n,
                   int32_t v, int32_t g, cudaStream_t stream) {
  const size_t smem = (size_t)g * v * sizeof(float);
  segagg_narrow_kernel<kSlots><<<grid_for(n * v, kBlocksPerSmNarrow), kThreads, smem,
                                 stream>>>(keys, values, out, n, v, g);
}

}  // namespace

extern "C" int segagg_scatter(const void* keys, const void* values, void* out, int64_t n,
                              int32_t v, int64_t g, void* stream) {
  if (n <= 0 || v <= 0 || g <= 0) return 0;
  segagg_scatter_kernel<<<grid_for(n * v, kBlocksPerSmScatter), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)keys, (const float*)values, (float*)out, n, v, g);
  return (int)cudaGetLastError();
}

extern "C" int segagg_narrow(const void* keys, const void* values, void* out, int64_t n,
                             int32_t v, int32_t g, void* stream) {
  if (n <= 0 || v <= 0 || g <= 0) return 0;
  const int32_t gv = g * v;
  const int32_t* k = (const int32_t*)keys;
  const float* x = (const float*)values;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (gv <= 1) launch_narrow<1>(k, x, o, n, v, g, s);
  else if (gv <= 2) launch_narrow<2>(k, x, o, n, v, g, s);
  else if (gv <= 4) launch_narrow<4>(k, x, o, n, v, g, s);
  else if (gv <= 8) launch_narrow<8>(k, x, o, n, v, g, s);
  else if (gv <= 16) launch_narrow<16>(k, x, o, n, v, g, s);
  else if (gv <= 32) launch_narrow<32>(k, x, o, n, v, g, s);
  else launch_narrow<0>(k, x, o, n, v, g, s);
  return (int)cudaGetLastError();
}

extern "C" const char* segagg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
