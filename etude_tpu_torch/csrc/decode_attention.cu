// Single-query decode attention for Hopper (sm_90a), bound to Python through
// ctypes (etude_tpu_torch/ops/decode_attention.py).
//
// Replaces the Pallas TPU kernel etude_tpu/ops/decode_attention.py:56
// (decode_attention_pallas, body _kernel :37). For each (stream b, head h):
//
//   s[c] = bf16(q) . K[c]          f32 accumulation
//   s[c] = s[c] / sqrt(D) + bias[b, c]
//   p    = softmax_c(s)            f32, max-subtracted, normalised by the sum
//   o    = sum_c bf16(p[c]) V[c]   f32 accumulation, stored as bf16
//
// bf16 rounding happens at the same three places as in the TPU kernel: q at
// entry, the normalised p before the PV product (:45-47), o at exit. The
// visibility bias is additive (0 or -1e9, never -inf), so a fully hidden row
// softmaxes to the uniform average of its V rows, exactly as the plain
// version does, and never to NaN.
//
// Layout (a port decision): k, v are [B, H, C, D] with D contiguous, so one
// slot row is 64 bf16 = 128 bytes. The TPU cache kept the slot axis last for
// the TPU's lanes.
//
// Bound: the kernel reads K and V once, 2 * B*H*C*D * 2 bytes, plus q, the
// bias and the output: 39.9 MB at B = 16, H = 8, C = 1217, D = 64, 11.9 us at
// the data sheet's 3.35 TB/s. The work is 4*B*H*C*D flops on the CUDA cores,
// far below the flop rate's limit (and far below the tensor cores' ratio of
// flops to bytes, so wgmma would give nothing): the kernel is bound by bytes.
//
// Design: one launch; a thread-block cluster of kCluster blocks per (b, h),
// each block owning a contiguous chunk of ceil(C / kCluster) slots.
//  1. A block streams its chunk through shared memory with cp.async: each
//     thread owns a ring of kStages 16-byte slots and keeps kStages pieces in
//     flight, first its pieces of the K rows, then of the V rows, so V is
//     already arriving while the last scores are computed. A thread reads
//     only what it copied, so the ring needs no block barrier. Each K and V
//     byte is read from HBM once.
//  2. Scores of its own slots (8 lanes per 128-byte row), then its local max
//     m_r and sum of exps l_r, which it writes into every block's table of
//     pairs through distributed shared memory.
//  3. cluster.sync(); every block forms the global max and sum from the
//     table in rank order, so p = bf16(exp(s - m) / L) is rounded exactly
//     where the TPU kernel rounds it (no online softmax, no rescaling after
//     rounding).
//  4. Its partial PV in f32, reduced over its warps in a fixed order; each
//     dim's partial goes to the block that stores that dim.
//  5. cluster.sync(); rank r sums the kCluster partials of dims
//     [16r, 16r + 16) in rank order and stores them. No block reads another
//     block's shared memory after that barrier, so blocks may leave freely.
// Every block arrives on the cluster barrier at entry and waits on it before
// its first remote write, so no block writes into one that has not started.
// The sums run in a fixed order, so the same inputs give the same bits. A
// block whose chunk is empty (small C) contributes max -inf and sum 0.
//
// Why a ring and four blocks: at the serving shape K and V (39.9 MB) exceed
// the card's shared memory (132 x 227 KB), so a design that stages a whole
// chunk runs in about 1.5 waves; the ring keeps every block resident and
// bytes in flight. Fewer, longer-streaming blocks per (b, h) pay the fixed
// cost of the exchange fewer times.
//
// What it still leaves behind: per-thread cp.async, not a TMA bulk copy with
// an mbarrier; a fixed cost per launch (first loads, two cluster barriers,
// the exchange) that is a large share of the time at the serving shape; the
// whole C is read even where the history region's tail is dead.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kHeadDim = 64;
constexpr int kCluster = 4;                               // blocks per (b, h)
constexpr int kThreads = 256;
constexpr int kStages = 4;                                // 16-byte pieces in flight per thread
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerSlot = 8;                          // 8 lanes x 8 bf16 = one row
constexpr int kSlotsPerWarp = 32 / kLanesPerSlot;         // 4 rows per warp step
constexpr int kSlotsPerPass = kWarps * kSlotsPerWarp;     // 32 rows per block step
constexpr int kPiecesPerRow = kHeadDim * 2 / 16;          // 16-byte pieces of a row
constexpr int kDimsPerRank = kHeadDim / kCluster;         // output dims each rank stores
constexpr unsigned kFull = 0xffffffffu;
static_assert(kHeadDim % kCluster == 0, "each rank stores kHeadDim / kCluster dims");

// Shared memory of one block for a chunk of `chunk` slots, in this order:
// the threads' rings, scores (f32), per-warp partial outputs, every rank's
// (max, sum), the reduction scratch and the partials of the dims this rank
// stores.
__host__ __device__ constexpr size_t smem_bytes(int chunk) {
  return static_cast<size_t>(kStages) * kThreads * 16 + static_cast<size_t>(chunk) * 4
         + sizeof(float) * (kWarps * kHeadDim + 2 * kCluster + kWarps + kCluster * kDimsPerRank);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void unpack8(const uint4 raw, float out[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ float block_max(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) r += red[w];
  __syncthreads();
  return r;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q,            // [B*H, D] f32
                        const __nv_bfloat16* __restrict__ k,    // [B*H, C, D]
                        const __nv_bfloat16* __restrict__ v,    // [B*H, C, D]
                        const float* __restrict__ bias,         // [B, C]
                        __nv_bfloat16* __restrict__ out,        // [B*H, D]
                        int H, int C, int chunk, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);                     // [kStages, kThreads]
  float* p = reinterpret_cast<float*>(ring + kStages * kThreads);   // [chunk]
  float* part = p + chunk;                  // [kWarps, D]: per-warp partial outputs
  float* stats = part + kWarps * kHeadDim;  // [kCluster, 2]: every rank's max, sum
  float* red = stats + 2 * kCluster;        // [kWarps]
  float* recv = red + kWarps;               // [kCluster, kDimsPerRank]: partials of my dims

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / kCluster;
  const int b = bh / H;
  const int c_begin = min(C, rank * chunk);
  const int n = min(C, c_begin + chunk) - c_begin;   // this block's slots, maybe 0
  const int tiles = (n + kSlotsPerPass - 1) / kSlotsPerPass;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane / kLanesPerSlot;   // which of the warp's 4 rows
  const int seg = lane % kLanesPerSlot;   // which 8 dims of the row
  const int row0 = warp * kSlotsPerWarp + sub;   // this thread's row in each tile
  const size_t base = (static_cast<size_t>(bh) * C + c_begin) * kHeadDim;
  const uint4* kg = reinterpret_cast<const uint4*>(k + base) + seg;
  const uint4* vg = reinterpret_cast<const uint4*>(v + base) + seg;
  uint4* mine = ring + threadIdx.x;
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // 1. Piece i of this thread: its 16 bytes of row (i mod tiles) * 32 + row0
  //    of K for i < tiles, of V after; one commit group per piece (maybe
  //    empty), so "all but the newest kStages - 1 groups" is piece i.
  auto issue = [&](int i) {
    if (i < 2 * tiles) {
      const int c = (i < tiles ? i : i - tiles) * kSlotsPerPass + row0;
      if (c < n)
        cp_async16(mine + (i % kStages) * kThreads, (i < tiles ? kg : vg) + c * kPiecesPerRow);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int i = 0; i < kStages; ++i) issue(i);

  // q rounded to bf16 at entry, as the TPU kernel does.
  float qf[8];
  {
    const float4* q4 = reinterpret_cast<const float4*>(q + static_cast<size_t>(bh) * kHeadDim + seg * 8);
    const float4 a = q4[0], c = q4[1];
    qf[0] = round_bf16(a.x); qf[1] = round_bf16(a.y); qf[2] = round_bf16(a.z); qf[3] = round_bf16(a.w);
    qf[4] = round_bf16(c.x); qf[5] = round_bf16(c.y); qf[6] = round_bf16(c.z); qf[7] = round_bf16(c.w);
  }
  const float* bias_b = bias + static_cast<size_t>(b) * C + c_begin;

  // 2. Scores. Every lane runs the same number of steps, so the shuffles see
  //    all 32 lanes; lanes past the end add zero. A ring slot is refilled
  //    only after its piece has been used.
  for (int t = 0; t < tiles; ++t) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1) : "memory");
    const int c = t * kSlotsPerPass + row0;
    float acc = 0.f;
    if (c < n) {
      float kf[8];
      unpack8(mine[(t % kStages) * kThreads], kf);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(qf[i], kf[i], acc);
    }
    issue(t + kStages);
    acc += __shfl_xor_sync(kFull, acc, 4);
    acc += __shfl_xor_sync(kFull, acc, 2);
    acc += __shfl_xor_sync(kFull, acc, 1);
    if (c < n && seg == 0) p[c] = acc * scale + bias_b[c];
  }
  __syncthreads();

  float m = -INFINITY;
  for (int c = threadIdx.x; c < n; c += kThreads) m = fmaxf(m, p[c]);
  m = block_max(m, red);
  float l = 0.f;
  for (int c = threadIdx.x; c < n; c += kThreads) l += expf(p[c] - m);
  l = block_sum(l, red);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");   // every block has started
  if (threadIdx.x < kCluster) {
    float* st = cluster.map_shared_rank(stats, static_cast<int>(threadIdx.x));
    st[2 * rank] = m;
    st[2 * rank + 1] = l;
  }
  cluster.sync();

  // 3. The global max and sum, in rank order; an empty chunk (l = 0) adds 0.
  float gm = -INFINITY;
#pragma unroll
  for (int r = 0; r < kCluster; ++r) gm = fmaxf(gm, stats[2 * r]);
  float gl = 0.f;
#pragma unroll
  for (int r = 0; r < kCluster; ++r) {
    const float lr = stats[2 * r + 1];
    if (lr > 0.f) gl += lr * expf(stats[2 * r] - gm);
  }
  for (int c = threadIdx.x; c < n; c += kThreads) p[c] = round_bf16(expf(p[c] - gm) / gl);
  __syncthreads();

  // 4. This block's share of o: each lane keeps 8 dims of its rows.
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1) : "memory");
    const int c = t * kSlotsPerPass + row0;
    if (c < n) {
      float vf[8];
      unpack8(mine[((tiles + t) % kStages) * kThreads], vf);
      const float pc = p[c];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(pc, vf[i], acc[i]);
    }
    issue(tiles + t + kStages);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[i] += __shfl_xor_sync(kFull, acc[i], 8);
    acc[i] += __shfl_xor_sync(kFull, acc[i], 16);
  }
  if (sub == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) part[warp * kHeadDim + seg * 8 + i] = acc[i];
  }
  __syncthreads();
  if (threadIdx.x < kHeadDim) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += part[w * kHeadDim + threadIdx.x];
    const int owner = threadIdx.x / kDimsPerRank;
    cluster.map_shared_rank(recv, owner)[rank * kDimsPerRank + threadIdx.x % kDimsPerRank] = o;
  }
  cluster.sync();

  // 5. Rank r stores its dims, summed over the cluster in rank order.
  if (threadIdx.x < kDimsPerRank) {
    float o = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) o += recv[r * kDimsPerRank + threadIdx.x];
    out[static_cast<size_t>(bh) * kHeadDim + rank * kDimsPerRank + threadIdx.x] = __float2bfloat16(o);
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs at C slots; the wrapper
// mirrors this (smem_bytes) to check C before it launches.
size_t decode_attention_smem_bytes(int C) {
  return smem_bytes((C + kCluster - 1) / kCluster);
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched). The caller
// checks shapes, types, contiguity and 16-byte alignment.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* bias, void* out, int B, int H, int C,
                            int D, void* stream) {
  if (D != kHeadDim || B <= 0 || H <= 0 || C <= 0 ||
      static_cast<long long>(B) * H * kCluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = (C + kCluster - 1) / kCluster;
  const size_t smem = smem_bytes(chunk);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  decode_attention_kernel<<<B * H * kCluster, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), H, C, chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
