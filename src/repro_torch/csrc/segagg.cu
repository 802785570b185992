// GROUP-BY partial aggregation for Hopper (sm_90a): out[key_i, :] += values[i, :].
//
// Three kernels, the counterparts of the two Pallas kernels of the JAX package
// (src/repro/kernels/segagg/segagg.py):
//
// * segagg_scatter replaces _segagg_scatter_kernel (segagg.py:75), which walks
//   each row block serially into a (G, 128)-padded accumulator resident in
//   VMEM.  Here the blocks of a thread-block cluster (8, or 16 when the table
//   needs it; one block an SM) pool their shared memory (distributed shared
//   memory) into one f32 table of a key range [lo, hi) of the flat (G, V)
//   index, split into 8-float chunks dealt round-robin to the blocks.  CQ3's
//   table (360K groups, 1.4 MB) does not fit one block's 227 KB but fits a
//   cluster of 8.  Hopper has no shared-memory f32 atomic add: it is a
//   compare-and-swap loop, and on a remote block one that crosses the
//   cluster's network on every try (CQ3: 0.85 ms, twice the first design).
//   So elements go to their owner as mail and are added there locally:
//   each block streams a strided share of the rows as int4/float4 quads, one
//   quad a thread and round; two elements of each quad go into the inbox
//   segment the block holds in the owner's shared memory (remote 8-byte
//   stores of (position, value), entries reserved by one shared atomic a
//   warp and owner), the other two, and mail past a segment's capacity, go
//   to the output by global atomics in L2, which run alongside.  A cluster
//   barrier ends the round; three inbox buffers let each block add the last
//   round's mail into its table between its arrive and its wait.  At the end
//   each block adds its non-zero chunks into the zeroed output with 16-byte
//   vector atomics.  tuning.scatter_plan picks the cluster size and the key
//   ranges; each range's clusters read every row, and two ranges already
//   lose to:
//
// * segagg_scatter_atomic, the first design: one thread per (row, v)
//   element in a grid-stride loop, each added with a global atomicAdd into
//   the zeroed (G, V) f32 output, which stays in the 50 MB L2.  Skewed keys
//   contend on the atomics of their hot groups.
//
//   Bound of both: the bytes they must move, 4N (keys) + 4NV (values) + 4GV
//   (output), at 3.35 TB/s.
//
// * segagg_narrow replaces _segagg_matmul_kernel (segagg.py:48), the one-hot
//   MXU contraction used for narrow G.  Bound: the same bytes, and with
//   G*V <= 12,288 the output is nothing beside the rows, so it streams keys
//   and values at the card's copy rate or it loses.  Its first design issued
//   one 4-byte load of a key and one of a value per thread and step: about
//   8 KB in flight an SM, where covering HBM's ~700 ns at 3.35 TB/s over 132
//   SMs needs ~18 KB, so it was latency-bound (35% of its bound at CQ2's 8.7M
//   rows).  Now, when V = 1 and keys and values sit at the same offset from a
//   16-byte boundary (a batch slice starting at any row), each thread loads
//   kNarrowUnroll int4/float4 quad pairs (128 bytes) before it adds any, and
//   the rows before the first boundary and after the last quad go through
//   the element path inside the same kernel, as do V > 1 and keys and values
//   at different offsets (kNarrowUnroll elements loaded ahead).  The grid is
//   what the card holds at once, and fewer blocks for few rows, so each
//   thread takes at least 2 * kNarrowUnroll quads.  Pre-combining as before:
//   for G*V <= 32 every thread sums its elements in registers, one per (g, v)
//   slot, and each warp combines its lanes by shuffle before one shared atomic
//   per slot; above, a (G, V) f32 table per block in shared memory (at most
//   48 KB, checked by the caller).  One launch a call: each block adds its
//   non-zero table entries into a (G, V) f32 accumulator in global memory
//   (L2) that is zero between calls, takes a ticket, and the last block to
//   take one copies the accumulator into the output, zeroes it and resets
//   the ticket.  So the output needs no zeroing launch; the accumulator and
//   ticket (the caller's workspace) belong to one stream.
//
// All kernels mask the ragged edge themselves (no padding of N, G or V) and
// drop keys outside [0, G), negative ones included.  Additions happen in an
// order that changes from run to run; integer-valued sums (COUNT) stay exact
// while every per-group total is below 2^24.
//
// C interface, loaded with ctypes: pointers and the stream are void*, row
// counts int64.  Each launcher returns cudaGetLastError() (or the launch's
// own error) right after the launch (0 on success); it never synchronises and
// allocates nothing.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSmScatter = 8;
constexpr int kNarrowThreads = 256;
// Measured on the H100: 2, 4 or 8 quads ahead tie; 1 block an SM loses.
constexpr int kNarrowBlocksPerSm = 4;  // 1,024 threads an SM at most
constexpr int kNarrowUnroll = 4;       // quads (or elements) loaded before any is added
constexpr int kNarrowMinUnits = 2 * kNarrowUnroll;  // a thread's fewest quads (or elements)
constexpr int kNarrowMaxTable = 12288;   // floats of the workspace's accumulator (48 KB)
constexpr int kClusterThreads = 1024;  // one block an SM: its table takes the shared memory
constexpr int kChunk = 8;              // floats of a table chunk: one 32-byte sector
constexpr int kMaxClusterBlocks = 16;  // the non-portable cluster size Hopper allows
constexpr int kBuffers = 3;            // inboxes in flight: send, consume, free
constexpr int kMail = 2;               // of a thread's 4 elements a round, those sent to mailboxes
constexpr int kAhead = 1;              // quads loaded ahead of the current one

int num_sms() {
  static int cached[64] = {};  // by device: asked once
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int sms = 132;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = sms;
  }
  return cached[dev];
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
segagg_scatter_atomic_kernel(const int32_t* __restrict__ keys,
                             const float* __restrict__ values, float* __restrict__ out,
                             int64_t n, int32_t v, int64_t g) {
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

// Flat (G, V) index of element e, or -1 for a key outside [0, g).
__device__ __forceinline__ int64_t flat_index(const int32_t* __restrict__ keys, int64_t e,
                                              int32_t v, int64_t g) {
  int64_t row;
  int32_t col;
  split_element(e, v, &row, &col);
  const int32_t k = __ldg(keys + row);
  return (k >= 0 && (int64_t)k < g) ? (int64_t)k * v + col : -1;
}

__device__ __forceinline__ bool any_nonzero(float4 a) {
  return a.x != 0.f || a.y != 0.f || a.z != 0.f || a.w != 0.f;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One block's part of a cluster's table and mailboxes, in shared memory in
// this order: its slice of the key range's f32 table (chunk c of the range,
// kChunk floats, lives in block c % blocks at chunk c / blocks); kBuffers
// inboxes, each a segment of `capacity` (position, value) entries for every
// source block of the cluster; kBuffers rows of entry counts, one a source;
// and two rows of send counters, one an owner.
struct ClusterBlock {
  float* table;
  uint2* inbox;
  uint32_t* counts;
  uint32_t* sent;
  int64_t lo, hi;
  uint32_t blocks, rank;
  int log2_blocks;
  int32_t capacity;

  // Mails the round's K elements (idx[k], x[k]) of every lane to the inbox
  // of round buffer `buf` of the blocks that own them: the lanes of a warp
  // that go to one owner take consecutive entries of this block's segment
  // there (one shared atomic on `count` a warp and owner reserves them).  An
  // entry past the segment's capacity goes straight to the output in global
  // memory.  All 32 lanes call it; the K elements go through each step
  // together, so their latencies overlap.
  template <int K>
  __device__ __forceinline__ void send(const int64_t* idx, const float* x, int buf,
                                       uint32_t* count, float* out) const {
    bool ok[K];
    uint32_t owner[K], pos[K], base[K];
    unsigned same[K];
    int leader[K];
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ok[k] = idx[k] >= lo && idx[k] < hi;
      const uint32_t off = ok[k] ? (uint32_t)(idx[k] - lo) : 0u;
      const uint32_t chunk = off / kChunk;
      owner[k] = chunk & (blocks - 1);
      pos[k] = ((chunk >> log2_blocks) * kChunk) | (off % kChunk);
      same[k] = __ballot_sync(0xffffffffu, ok[k]);
    }
    for (int b = 0; b < log2_blocks; ++b) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const bool bit = (owner[k] >> b) & 1u;
        const unsigned set = __ballot_sync(0xffffffffu, bit);
        same[k] &= bit ? set : ~set;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      leader[k] = ok[k] ? __ffs(same[k]) - 1 : lane;
      base[k] = 0;
      if (ok[k] && lane == leader[k]) base[k] = atomicAdd(count + owner[k], (uint32_t)__popc(same[k]));
    }
#pragma unroll
    for (int k = 0; k < K; ++k) base[k] = __shfl_sync(0xffffffffu, base[k], leader[k]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!ok[k]) continue;
      const uint32_t slot = base[k] + __popc(same[k] & ((1u << lane) - 1u));
      if (slot < (uint32_t)capacity) {
        uint2* dst = cg::this_cluster().map_shared_rank(inbox, (int)owner[k]);
        dst[((size_t)buf * blocks + rank) * capacity + slot] =
            make_uint2(pos[k], __float_as_uint(x[k]));
      } else {
        atomicAdd(out + idx[k], x[k]);
      }
    }
  }

  // After a round's sends and a block barrier: hands each owner the count
  // this block sent it, and clears the other row of send counters for the
  // next round.
  __device__ __forceinline__ void publish(int buf, const uint32_t* count,
                                          uint32_t* next_count) const {
    if (threadIdx.x < blocks) {
      const uint32_t c = min(count[threadIdx.x], (uint32_t)capacity);
      cg::this_cluster().map_shared_rank(counts, (int)threadIdx.x)[buf * blocks + rank] = c;
      next_count[threadIdx.x] = 0;
    }
  }

  // Adds the entries every source sent this block in round buffer `buf`
  // into its table (blockDim.x / blocks threads a source, two entries at a
  // time).
  __device__ __forceinline__ void consume(int buf) const {
    const uint32_t per = blockDim.x >> log2_blocks;
    const uint32_t src = threadIdx.x / per;
    const uint32_t c = counts[buf * blocks + src];
    const uint2* seg = inbox + ((size_t)buf * blocks + src) * capacity;
    uint32_t i = threadIdx.x % per;
    for (; i + per < c; i += 2 * per) {
      const uint2 e0 = seg[i], e1 = seg[i + per];
      atomicAdd(table + e0.x, __uint_as_float(e0.y));
      atomicAdd(table + e1.x, __uint_as_float(e1.y));
    }
    if (i < c) {
      const uint2 e = seg[i];
      atomicAdd(table + e.x, __uint_as_float(e.y));
    }
  }
};

// Grid: clusters * blocks thread blocks in clusters of `blocks` (a power of
// two); cluster c serves key range c % num_ranges, together with the other
// clusters of that range, and streams its share of all rows.  The rows go in
// rounds of four elements a thread; in each, every block mails kMail of them
// to their owners' inboxes, arrives at the cluster barrier, adds the rest to
// the output in L2, adds what it received in the round before into its
// table, and waits at the barrier.  kVec: v == 1 with keys and values 16-byte
// aligned, read as int4 and float4 quads kAhead rounds ahead of use.
template <bool kVec>
__global__ void __launch_bounds__(kClusterThreads, 1)
segagg_scatter_cluster_kernel(const int32_t* __restrict__ keys,
                              const float* __restrict__ values, float* __restrict__ out,
                              int64_t n, int32_t v, int64_t g, int64_t range_len,
                              int32_t num_ranges, int32_t slice_chunks, int32_t capacity) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t blocks = cluster.num_blocks();
  const uint32_t rank = cluster.block_rank();
  const int64_t cid = blockIdx.x / blocks;
  const int64_t clusters = gridDim.x / blocks;
  const int32_t range = (int32_t)(cid % num_ranges);
  const int64_t peers = (clusters - range + num_ranges - 1) / num_ranges;
  ClusterBlock cb;
  cb.table = reinterpret_cast<float*>(smem4);
  cb.inbox = reinterpret_cast<uint2*>(cb.table + (size_t)slice_chunks * kChunk);
  cb.counts = reinterpret_cast<uint32_t*>(cb.inbox + (size_t)kBuffers * blocks * capacity);
  cb.sent = cb.counts + kBuffers * blocks;
  cb.lo = range * range_len;
  cb.hi = min(g * v, cb.lo + range_len);
  cb.blocks = blocks;
  cb.rank = rank;
  cb.log2_blocks = __ffs((int)blocks) - 1;
  cb.capacity = capacity;

  for (int i = threadIdx.x; i < slice_chunks * (kChunk / 4); i += blockDim.x) {
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (threadIdx.x < 2 * blocks) cb.sent[threadIdx.x] = 0;
  cluster.sync();  // every block zeroed and resident before any remote store

  const int64_t stride = peers * blocks * blockDim.x;  // threads of this range
  const int64_t first = ((cid / num_ranges) * blocks + rank) * blockDim.x + threadIdx.x;
  const int64_t total = n * v;
  const int64_t units = kVec ? total / 4 : total;  // quads or elements
  const int64_t most = (units + stride - 1) / stride;  // units of the busiest thread
  const int64_t rounds = kVec ? most : (most + 3) / 4;

  // Four elements a thread and round: kMail go through the mailboxes, the
  // others straight to the output by global atomics, issued after the
  // round's arrive (whose release waits for every memory access issued
  // before it), as are the loads of the vector path's next quad.
  const int4* keys4 = reinterpret_cast<const int4*>(keys);
  const float4* values4 = reinterpret_cast<const float4*>(values);
  int4 kq[kAhead + 1];
  float4 xq[kAhead + 1];
#pragma unroll
  for (int i = 0; i <= kAhead; ++i) {
    const int64_t q = first + i * stride;
    kq[i] = make_int4(-1, -1, -1, -1);
    xq[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kVec && q < units) {
      kq[i] = __ldg(keys4 + q);
      xq[i] = __ldg(values4 + q);
    }
  }
  for (int64_t r = 0; r < rounds; ++r) {
    const int buf = (int)(r % kBuffers);
    uint32_t* count = cb.sent + (r & 1) * blocks;
    int64_t idx[4];
    float x[4];
    if constexpr (kVec) {
      idx[0] = kq[0].x, idx[1] = kq[0].y, idx[2] = kq[0].z, idx[3] = kq[0].w;
      x[0] = xq[0].x, x[1] = xq[0].y, x[2] = xq[0].z, x[3] = xq[0].w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t e = first + (4 * r + k) * stride;
        idx[k] = e < total ? flat_index(keys, e, v, g) : -1;
        x[k] = e < total ? __ldg(values + e) : 0.f;
      }
    }
    cb.send<kMail>(idx, x, buf, count, out);
    __syncthreads();  // this round's send counters are final
    cb.publish(buf, count, cb.sent + ((r + 1) & 1) * blocks);
    cluster_arrive();
#pragma unroll
    for (int k = kMail; k < 4; ++k) {
      if (idx[k] >= cb.lo && idx[k] < cb.hi) atomicAdd(out + idx[k], x[k]);
    }
    if constexpr (kVec) {
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        kq[i] = kq[i + 1];
        xq[i] = xq[i + 1];
      }
      const int64_t q = first + (r + 1 + kAhead) * stride;
      kq[kAhead] = make_int4(-1, -1, -1, -1);
      if (q < units) {
        kq[kAhead] = __ldg(keys4 + q);
        xq[kAhead] = __ldg(values4 + q);
      }
    }
    if (r > 0) cb.consume((int)((r - 1) % kBuffers));
    cluster_wait();
  }
  if (rounds > 0) cb.consume((int)((rounds - 1) % kBuffers));
  if (kVec && first == 0) {  // the rows past the last quad, once a range
    for (int64_t e = 4 * units; e < total; ++e) {
      const int64_t idx = __ldg(keys + e);
      if (idx >= cb.lo && idx < cb.hi) atomicAdd(out + idx, __ldg(values + e));
    }
  }
  __syncthreads();  // the table is final

  for (int32_t c = threadIdx.x; c < slice_chunks; c += blockDim.x) {
    const int64_t base = cb.lo + ((int64_t)c * blocks + rank) * kChunk;
    if (base >= cb.hi) continue;
    const float4 a = smem4[2 * c], b = smem4[2 * c + 1];
    if (base + kChunk <= cb.hi) {
      if (any_nonzero(a)) atomicAdd(reinterpret_cast<float4*>(out + base), a);
      if (any_nonzero(b)) atomicAdd(reinterpret_cast<float4*>(out + base + 4), b);
    } else {
      const float* t = reinterpret_cast<const float*>(smem4 + 2 * c);
      for (int64_t i = 0; i < cb.hi - base; ++i) {
        if (t[i] != 0.f) atomicAdd(out + base + i, t[i]);
      }
    }
  }
}

size_t cluster_smem_bytes(int32_t cluster, int32_t slice_chunks, int32_t capacity) {
  return (size_t)slice_chunks * kChunk * sizeof(float) +
         (size_t)kBuffers * cluster * capacity * sizeof(uint2) +
         (size_t)(kBuffers + 2) * cluster * sizeof(uint32_t);
}

template <bool kVec>
cudaError_t configure_cluster(int32_t cluster, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(segagg_scatter_cluster_kernel<kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(segagg_scatter_cluster_kernel<kVec>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

cudaLaunchConfig_t cluster_config(int64_t clusters, int32_t cluster, size_t smem,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * cluster));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kVec>
cudaError_t launch_cluster(const int32_t* keys, const float* values, float* out, int64_t n,
                           int32_t v, int64_t g, int32_t cluster, int32_t clusters,
                           int64_t range_len, int32_t num_ranges, int32_t slice_chunks,
                           int32_t capacity, cudaStream_t stream) {
  const size_t smem = cluster_smem_bytes(cluster, slice_chunks, capacity);
  cudaError_t err = configure_cluster<kVec>(cluster, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(clusters, cluster, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, segagg_scatter_cluster_kernel<kVec>, keys, values, out, n,
                           v, g, range_len, num_ranges, slice_chunks, capacity);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// A thread's share of the narrow sum: kSlots > 0 keeps one register a (g, v)
// slot (G*V <= kSlots); kSlots == 0 adds into the block's shared table.
template <int kSlots>
struct NarrowSum {
  float acc[kSlots > 0 ? kSlots : 1];
  float* table;
  int32_t g, v;

  __device__ __forceinline__ void add(int32_t k, int32_t col, float x) {
    if (k < 0 || k >= g) return;
    const int32_t slot = k * v + col;
    if constexpr (kSlots > 0) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) acc[s] += (slot == s) ? x : 0.f;
    } else {
      atomicAdd(table + slot, x);
    }
  }

  __device__ __forceinline__ void add4(int4 k, float4 x) {
    add(k.x, 0, x.x);
    add(k.y, 0, x.y);
    add(k.z, 0, x.z);
    add(k.w, 0, x.w);
  }
};

// head >= 0: the vector path (v == 1; keys + head and values + head 16-byte
// aligned): rows [0, head) and the rows after the last quad by the element
// path, the quads between as int4/float4.  head < 0: every element by the
// element path.  work: kNarrowMaxTable floats, then a uint32 ticket, all zero
// on entry and left so.
template <int kSlots>
__global__ void __launch_bounds__(kNarrowThreads)
segagg_narrow_kernel(const int32_t* __restrict__ keys, const float* __restrict__ values,
                     float* __restrict__ out, float* __restrict__ work, int64_t n, int32_t v,
                     int32_t g, int32_t head) {
  extern __shared__ float4 narrow_smem4[];  // no static shared: 48 KB of table fit
  float* table = reinterpret_cast<float*>(narrow_smem4);
  const int32_t gv = g * v;
  const int32_t slots = kSlots > 0 ? kSlots : gv;
  for (int32_t i = threadIdx.x; i < slots; i += blockDim.x) table[i] = 0.f;
  __syncthreads();

  NarrowSum<kSlots> sum;
#pragma unroll
  for (int s = 0; s < (kSlots > 0 ? kSlots : 1); ++s) sum.acc[s] = 0.f;
  sum.table = table;
  sum.g = g;
  sum.v = v;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (head >= 0) {
    const int64_t quads = (n - head) / 4;
    const int64_t tail = head + 4 * quads;
    if (first < head) sum.add(__ldg(keys + first), 0, __ldg(values + first));
    if (first < n - tail) sum.add(__ldg(keys + tail + first), 0, __ldg(values + tail + first));
    const int4* keys4 = reinterpret_cast<const int4*>(keys + head);
    const float4* values4 = reinterpret_cast<const float4*>(values + head);
    int64_t q = first;
    for (; q + (kNarrowUnroll - 1) * stride < quads; q += kNarrowUnroll * stride) {
      int4 kq[kNarrowUnroll];
      float4 xq[kNarrowUnroll];
#pragma unroll
      for (int u = 0; u < kNarrowUnroll; ++u) {
        kq[u] = __ldg(keys4 + q + u * stride);
        xq[u] = __ldg(values4 + q + u * stride);
      }
#pragma unroll
      for (int u = 0; u < kNarrowUnroll; ++u) sum.add4(kq[u], xq[u]);
    }
    for (; q < quads; q += stride) sum.add4(__ldg(keys4 + q), __ldg(values4 + q));
  } else {
    const int64_t total = n * v;
    int64_t e = first;
    for (; e + (kNarrowUnroll - 1) * stride < total; e += kNarrowUnroll * stride) {
      int32_t k[kNarrowUnroll], col[kNarrowUnroll];
      float x[kNarrowUnroll];
#pragma unroll
      for (int u = 0; u < kNarrowUnroll; ++u) {
        int64_t row;
        split_element(e + u * stride, v, &row, &col[u]);
        k[u] = __ldg(keys + row);
        x[u] = __ldg(values + e + u * stride);
      }
#pragma unroll
      for (int u = 0; u < kNarrowUnroll; ++u) sum.add(k[u], col[u], x[u]);
    }
    for (; e < total; e += stride) {
      int64_t row;
      int32_t col;
      split_element(e, v, &row, &col);
      sum.add(__ldg(keys + row), col, __ldg(values + e));
    }
  }
  if constexpr (kSlots > 0) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      float x = sum.acc[s];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0 && s < gv) atomicAdd(table + s, x);
    }
  }
  __syncthreads();

  // The block's table into the accumulator in L2 (16-byte vector atomics,
  // all-zero quads skipped), then the ticket.
  const int32_t quads = gv / 4;
  for (int32_t i = threadIdx.x; i < quads; i += blockDim.x) {
    const float4 t = narrow_smem4[i];
    if (any_nonzero(t)) atomicAdd(reinterpret_cast<float4*>(work) + i, t);
  }
  for (int32_t i = 4 * quads + threadIdx.x; i < gv; i += blockDim.x) {
    if (table[i] != 0.f) atomicAdd(work + i, table[i]);
  }
  __threadfence();
  __syncthreads();
  uint32_t* ticket = reinterpret_cast<uint32_t*>(work + kNarrowMaxTable);
  const bool last =
      __syncthreads_or(threadIdx.x == 0 && atomicAdd(ticket, 1u) == gridDim.x - 1);
  if (!last) return;
  __threadfence();  // every other block's adds, seen before they are read
  for (int32_t i = threadIdx.x; i < gv; i += blockDim.x) {
    out[i] = __ldcg(work + i);
    work[i] = 0.f;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

template <int kSlots>
cudaError_t launch_narrow(const int32_t* keys, const float* values, float* out,
                          float* work, int64_t n, int32_t v, int32_t g, cudaStream_t stream) {
  const size_t smem = (size_t)(kSlots > 0 ? kSlots : g * v) * sizeof(float);
  // The vector path needs keys and values at one offset from a 16-byte
  // boundary: rows before it (head, 0-3 of them) take the element path.
  const uintptr_t ka = (uintptr_t)keys % 16, xa = (uintptr_t)values % 16;
  int32_t head = -1;
  if (v == 1 && ka == xa) head = (int32_t)std::min<int64_t>((16 - ka) % 16 / 4, n);
  const int64_t units = head >= 0 ? (n - head) / 4 : n * v;
  // Blocks the card holds at once, asked once for each table size.
  static int cached_per_sm[(kSlots > 0 ? kSlots : kNarrowMaxTable) + 1] = {};
  int& per_sm = cached_per_sm[smem / sizeof(float)];
  if (per_sm == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segagg_narrow_kernel<kSlots>, kNarrowThreads, smem);
    if (err != cudaSuccess) return err;
  }
  int64_t blocks = (int64_t)num_sms() * std::min(std::max(per_sm, 1), kNarrowBlocksPerSm);
  const int64_t per_block = (int64_t)kNarrowThreads * kNarrowMinUnits;
  blocks = std::min(blocks, std::max<int64_t>((units + per_block - 1) / per_block, 1));
  segagg_narrow_kernel<kSlots><<<(unsigned)blocks, kNarrowThreads, smem, stream>>>(
      keys, values, out, work, n, v, g, head);
  return cudaGetLastError();
}

}  // namespace

extern "C" int segagg_scatter_atomic(const void* keys, const void* values, void* out,
                                     int64_t n, int32_t v, int64_t g, void* stream) {
  if (n <= 0 || v <= 0 || g <= 0) return 0;
  segagg_scatter_atomic_kernel<<<grid_for(n * v, kBlocksPerSmScatter), kThreads, 0,
                                 (cudaStream_t)stream>>>(
      (const int32_t*)keys, (const float*)values, (float*)out, n, v, g);
  return (int)cudaGetLastError();
}

// cluster: blocks a cluster (a power of two up to 16); clusters: clusters
// launched, at least num_ranges = ceil(G*V / range_len); range_len: a
// multiple of 8 floats; slice_chunks: 8-float chunks of table a block, with
// slice_chunks * cluster * 8 >= range_len; capacity: inbox entries a source
// block and round.  tuning.scatter_plan makes them.
extern "C" int segagg_scatter(const void* keys, const void* values, void* out, int64_t n,
                              int32_t v, int64_t g, int32_t cluster, int32_t clusters,
                              int64_t range_len, int32_t slice_chunks, int32_t capacity,
                              void* stream) {
  if (n <= 0 || v <= 0 || g <= 0) return 0;
  const int64_t gv = g * v;
  const int64_t num_ranges = range_len > 0 ? (gv + range_len - 1) / range_len : 0;
  if (cluster < 1 || cluster > kMaxClusterBlocks || (cluster & (cluster - 1)) ||
      range_len <= 0 || range_len % kChunk || num_ranges > clusters || capacity < 1 ||
      (int64_t)slice_chunks * cluster * kChunk < range_len) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec = v == 1 && (uintptr_t)values % 16 == 0 && (uintptr_t)keys % 16 == 0;
  const auto launch = vec ? launch_cluster<true> : launch_cluster<false>;
  return (int)launch((const int32_t*)keys, (const float*)values, (float*)out, n, v, g,
                     cluster, clusters, range_len, (int32_t)num_ranges, slice_chunks,
                     capacity, (cudaStream_t)stream);
}

// How many clusters of `cluster` blocks, each block with `smem_bytes` of
// shared memory, the card runs at once (cudaOccupancyMaxActiveClusters); 0
// if none.
extern "C" int segagg_scatter_clusters(int32_t cluster, int32_t smem_bytes,
                                       int32_t* max_clusters) {
  *max_clusters = 0;
  cudaError_t err = configure_cluster<true>(cluster, (size_t)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, cluster, (size_t)smem_bytes, 0, &attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, segagg_scatter_cluster_kernel<true>, &cfg);
  *max_clusters = count;
  return (int)err;
}

// The shared memory one block of the current device may take (opt-in).
extern "C" int segagg_scatter_smem_optin(int32_t* bytes) {
  int dev = 0;
  int value = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&value, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  *bytes = value;
  return (int)err;
}

// work: kNarrowMaxTable (12,288) zero floats, then a zero uint32 ticket; the
// kernel leaves them zero.  Calls that share a workspace must be ordered (one
// stream).  The output needs no zeroing: the last block writes all of it.
extern "C" int segagg_narrow(const void* keys, const void* values, void* out, int64_t n,
                             int32_t v, int32_t g, void* work, void* stream) {
  if (n <= 0 || v <= 0 || g <= 0) return 0;
  const int32_t gv = g * v;
  if (gv > kNarrowMaxTable || work == nullptr) return (int)cudaErrorInvalidValue;
  const int32_t* k = (const int32_t*)keys;
  const float* x = (const float*)values;
  float* o = (float*)out;
  float* w = (float*)work;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (gv <= 1) err = launch_narrow<1>(k, x, o, w, n, v, g, s);
  else if (gv <= 2) err = launch_narrow<2>(k, x, o, w, n, v, g, s);
  else if (gv <= 4) err = launch_narrow<4>(k, x, o, w, n, v, g, s);
  else if (gv <= 8) err = launch_narrow<8>(k, x, o, w, n, v, g, s);
  else if (gv <= 16) err = launch_narrow<16>(k, x, o, w, n, v, g, s);
  else if (gv <= 32) err = launch_narrow<32>(k, x, o, w, n, v, g, s);
  else err = launch_narrow<0>(k, x, o, w, n, v, g, s);
  return (int)err;
}

extern "C" const char* segagg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
