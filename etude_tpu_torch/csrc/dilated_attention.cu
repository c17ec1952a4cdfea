// Dilated attention of the Beat-Transformer for Hopper (sm_90a), bound to
// Python through ctypes (etude_tpu_torch/ops/dilated_attention.py).
//
// Replaces the Pallas TPU kernel etude_tpu/ops/dilated_attention.py:276
// (dilated_attention_pallas, body _dilated_kernel :194). For each
// (b, h, t) and slot a in 0..4:
//
//   pos_a   = t + (a - 2 + shift_h) * dilation,  shift = (0,0,0,0,-2,-1,1,2)
//   logit_a = (q . k[pos_a] + q . er[h, :, a]) / sqrt(d)   f32 sums of bf16
//   p       = softmax over the slots with 0 <= pos_a < T   (others: p = 0)
//   o       = sum_a p_a v[pos_a]                           f32, stored bf16
//
// The launcher takes each head's slot-0 offset (a - 2 + shift at a = 0), so
// the shift table lives in one place (head_offsets in the wrapper). With
// head7_from6, head 7 scores against head 6's keys while keeping its own
// values, as dilated_attention(head7_bug=True) does; the TPU kernel lacks it.
// The kernel multiplies by 1/sqrt(d) and by 1/sum where the plain version
// divides: one f32 rounding apart, far below the bf16 output's.
//
// Every head's offsets include 0 (shifts -2..+2 around half = 2), so the
// query's own row is always a valid slot and no row is fully masked. The
// kernel defines that case anyway: a row with no valid slot is written as
// zeros, never NaN.
//
// Layout [B, H, T, d], d = 32 contiguous, so one row is 64 bytes: two whole
// 32-byte sectors, four 16-byte pieces.
//
// Bound: q, k and v are read once and o written once, 4 * B*H*T*d * 2 bytes:
// 125.8 MB at B = 5, H = 8, T = 12288, d = 32, about 37.6 us at the data
// sheet's 3.35 TB/s. The work is about 22 flops per (query, slot, dim), about
// 0.5 GFLOP on the CUDA cores, so by the data sheet the kernel is bound by
// bytes; in practice the conversions, dot products and softmax of 5 slots
// per query take about as long as the bytes (see PERF.md).
//
// Design: tiles in the strided view. Order the T positions of one (b, h) by
// residue mod the dilation, then by position: u = offset(r) + j for
// t = r + j * dilation, where residue class r holds n_r = ceil((T - r) / dil)
// queries. A tile is kTile consecutive u. Within one class the 5 slots of
// query j are the rows j + first + 0..4 of that class, so the queries of a
// class segment share the segment's length + 4 rows; a class row outside
// [0, n_r) is a position outside [0, T). For a tile the block stages, for
// each class segment it touches, those rows of k (of head 6 for head 7 under
// head7_from6) and of v, and the tile's q rows, in shared memory with
// cp.async (zeros for rows outside the tensor); query i of segment g finds
// slot a at staged row i + 4g + a. At dilation 1 a tile is one segment of
// contiguous rows; at dilation 128-256 (classes of 96 and 48 queries at
// T = 12,288) a tile covers two to four short classes, so tiles stay full;
// where dilation >= T every class is one query and a tile is a direct
// gather. L2-to-SM traffic for k and v falls from up to 5x the rows to
// (kTile + 4 * segments) / kTile of them.
//  - Persistent blocks, two stages: a block walks tiles w = blockIdx.x,
//    + gridDim.x, ..., and stages the next tile while it computes this one.
//  - Two lanes per query, each holding 16 of the 32 dims (pieces l and
//    l + 2), so the two lanes of a query ask for both halves of a 32-byte
//    sector in one instruction and the softmax is computed twice per query,
//    not four times.
//  - Staged rows are stored with their four pieces permuted by row, so the
//    rows that the lanes of a warp read at once fall on distinct banks.
//  - er lives in shared memory for the whole launch.
//
// What it still leaves behind: per-thread cp.async, not TMA; about half the
// time is instruction issue (bf16 unpacking and three f32 dot products per
// slot); q·k could run on the tensor cores (bf16 products are exact, sums
// f32), PV and q·er cannot without rounding p or er.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 32;
constexpr int kAttnLen = 5;
constexpr int kHalo = kAttnLen - 1;                       // extra rows per class segment
constexpr int kMaxHeads = 8;
constexpr int kPieces = kHeadDim * 2 / 16;                // 16-byte pieces of a row
constexpr int kLanes = 2;                                 // lanes per query
constexpr int kMine = kPieces / kLanes;                   // pieces each lane reads
constexpr int kDims = kMine * 8;                          // dims each lane holds
constexpr int kTile = 128;                                // queries per tile
constexpr int kThreads = kTile * kLanes;
constexpr unsigned kFull = 0xffffffffu;

struct HeadOffsets {
  int first[kMaxHeads];
};

// Class segments one tile of kTile consecutive u can touch: every class
// holds T / dilation or T / dilation + 1 queries (1 where dilation >= T).
__host__ __device__ constexpr int max_segments(int T, int dilation) {
  const int shortest = T / dilation > 0 ? T / dilation : 1;
  const int spans = (kTile - 1 + shortest - 1) / shortest + 1;
  return spans < kTile ? spans : kTile;
}

// Two stages of staged k rows, v rows and q rows, then er of every head.
__host__ __device__ constexpr size_t smem_bytes(int T, int dilation) {
  return 2 * static_cast<size_t>(2 * (kTile + kHalo * max_segments(T, dilation)) + kTile) * kPieces * 16
         + sizeof(float) * kMaxHeads * kAttnLen * kHeadDim;
}

// 16-byte unit of piece p of staged row `row`: pieces are permuted within a
// row so that 8 consecutive rows' piece p fall on 8 different bank groups.
__device__ __forceinline__ int unit(int row, int p) { return row * kPieces + (p ^ ((row >> 1) & 3)); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void unpack8(const uint4 raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// One thread's part of one tile w: query i = threadIdx.x / kLanes.
struct Tile {
  int h, first, r, j, n, t, base_row;
  bool live;
  int bh;
};

__device__ __forceinline__ Tile locate_tile(int w, int tiles_per_bh, int H, int T, int dilation,
                                            const HeadOffsets& offsets) {
  Tile x;
  x.bh = w / tiles_per_bh;
  const int u0 = (w % tiles_per_bh) * kTile;
  const int i = threadIdx.x / kLanes;
  x.h = x.bh % H;
  x.first = offsets.first[0];
#pragma unroll
  for (int y = 1; y < kMaxHeads; ++y)
    if (y == x.h) x.first = offsets.first[y];
  const int qn = T / dilation, rem = T % dilation;
  const int long_part = rem * (qn + 1);
  auto locate = [&](int u, int& r, int& j, int& n) {
    if (u < long_part) {
      r = u / (qn + 1); j = u % (qn + 1); n = qn + 1;
    } else {
      r = rem + (u - long_part) / qn; j = (u - long_part) % qn; n = qn;
    }
  };
  int r0, j0, n0;
  locate(u0, r0, j0, n0);
  const int u = u0 + i;
  x.live = u < T;
  x.r = r0; x.j = 0; x.n = 1;
  if (x.live) locate(u, x.r, x.j, x.n);
  x.t = x.r + x.j * dilation;
  x.base_row = i + kHalo * (x.r - r0);
  return x;
}

__global__ void __launch_bounds__(kThreads)
dilated_attention_kernel(const __nv_bfloat16* __restrict__ q,    // [B*H, T, d]
                         const __nv_bfloat16* __restrict__ k,    // [B*H, T, d]
                         const __nv_bfloat16* __restrict__ v,    // [B*H, T, d]
                         const float* __restrict__ er,           // [H, A, d] f32
                         __nv_bfloat16* __restrict__ out,        // [B*H, T, d]
                         int H, int T, int dilation, int head7_from6,
                         HeadOffsets offsets, float inv_sqrt_d, int tiles_per_bh, int total) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = kTile + kHalo * max_segments(T, dilation);
  const int buf_units = (2 * rows + kTile) * kPieces;    // k rows, v rows, q rows
  uint4* bufs = reinterpret_cast<uint4*>(smem);
  float* ers_all = reinterpret_cast<float*>(bufs + 2 * buf_units);   // [H, A, d]
  const int i = threadIdx.x / kLanes;
  const int lane_q = threadIdx.x % kLanes;
  for (int x = threadIdx.x; x < H * kAttnLen * kHeadDim / 4; x += kThreads)
    reinterpret_cast<float4*>(ers_all)[x] = __ldg(reinterpret_cast<const float4*>(er) + x);

  // Stage tile x into buffer `buf`: this query's q row and slot 0's k and v
  // rows and, at the end of its class segment, the kHalo rows after them;
  // zeros for class rows outside [0, n). One commit group per tile.
  auto stage = [&](const Tile& x, int buf) {
    uint4* ks = bufs + buf * buf_units;
    uint4* vs = ks + rows * kPieces;
    uint4* qs = vs + rows * kPieces;
    if (x.live) {
      const int k_head = (head7_from6 && x.h == 7) ? 6 : x.h;
      const uint4* qg = reinterpret_cast<const uint4*>(q + static_cast<size_t>(x.bh) * T * kHeadDim);
      const uint4* kg = reinterpret_cast<const uint4*>(k + static_cast<size_t>(x.bh - x.h + k_head) * T * kHeadDim);
      const uint4* vg = reinterpret_cast<const uint4*>(v + static_cast<size_t>(x.bh) * T * kHeadDim);
#pragma unroll
      for (int c = 0; c < kMine; ++c) {
        const int p = lane_q + c * kLanes;
        cp_async16(qs + unit(i, p), qg + static_cast<size_t>(x.t) * kPieces + p);
      }
      const bool last = (i == kTile - 1) || (x.j == x.n - 1);
      const int count = last ? 1 + kHalo : 1;
      for (int m = 0; m < count; ++m) {
        const int jj = x.j + x.first + m;
        const bool in = jj >= 0 && jj < x.n;
        const size_t row = static_cast<size_t>(x.r + jj * dilation) * kPieces;
#pragma unroll
        for (int c = 0; c < kMine; ++c) {
          const int p = lane_q + c * kLanes;
          uint4* kd = ks + unit(x.base_row + m, p);
          uint4* vd = vs + unit(x.base_row + m, p);
          if (in) {
            cp_async16(kd, kg + row + p);
            cp_async16(vd, vg + row + p);
          } else {
            *kd = make_uint4(0, 0, 0, 0);
            *vd = make_uint4(0, 0, 0, 0);
          }
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // Tile w is computed from buffer it & 1 while tile w + gridDim.x lands in
  // the other; the barrier at the end of an iteration frees the buffer that
  // the next iteration stages into. Dead lanes (u >= T) run every step so
  // the shuffles see both lanes of a query, but load and store nothing.
  int w = blockIdx.x;
  Tile x = locate_tile(w, tiles_per_bh, H, T, dilation, offsets);
  stage(x, 0);
  for (int it = 0; w < total; ++it) {
    const int wn = w + gridDim.x;
    Tile xn = x;
    if (wn < total) {
      xn = locate_tile(wn, tiles_per_bh, H, T, dilation, offsets);
      stage(xn, (it + 1) & 1);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();

    const uint4* ks = bufs + (it & 1) * buf_units;
    const uint4* vs = ks + rows * kPieces;
    const uint4* qs = vs + rows * kPieces;
    const float* ers = ers_all + x.h * kAttnLen * kHeadDim;
    float qf[kDims];
#pragma unroll
    for (int c = 0; c < kMine; ++c) unpack8(qs[unit(i, lane_q + c * kLanes)], qf + 8 * c);

    float logit[kAttnLen];
    bool valid[kAttnLen];
#pragma unroll
    for (int a = 0; a < kAttnLen; ++a) {
      const int jj = x.j + x.first + a;
      valid[a] = x.live && jj >= 0 && jj < x.n;
      float s = 0.f;
      if (valid[a]) {
#pragma unroll
        for (int c = 0; c < kMine; ++c) {
          float kf[8];
          unpack8(ks[unit(x.base_row + a, lane_q + c * kLanes)], kf);
#pragma unroll
          for (int y = 0; y < 8; ++y) s = fmaf(qf[8 * c + y], kf[y], s);
        }
      }
      float rr = 0.f;
#pragma unroll
      for (int c = 0; c < kMine; ++c) {
        const float4* e4 = reinterpret_cast<const float4*>(ers + a * kHeadDim + 8 * (lane_q + c * kLanes));
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float4 e = e4[h2];
          const float* qq = qf + 8 * c + 4 * h2;
          rr = fmaf(qq[0], e.x, rr); rr = fmaf(qq[1], e.y, rr);
          rr = fmaf(qq[2], e.z, rr); rr = fmaf(qq[3], e.w, rr);
        }
      }
      logit[a] = (lanes_sum(s) + lanes_sum(rr)) * inv_sqrt_d;
    }
    // f32 softmax over the valid slots, max-subtracted.
    float m = -INFINITY;
#pragma unroll
    for (int a = 0; a < kAttnLen; ++a)
      if (valid[a]) m = fmaxf(m, logit[a]);
    float denom = 0.f;
#pragma unroll
    for (int a = 0; a < kAttnLen; ++a) {
      logit[a] = valid[a] ? expf(logit[a] - m) : 0.f;
      denom += logit[a];
    }
    float acc[kDims];
#pragma unroll
    for (int y = 0; y < kDims; ++y) acc[y] = 0.f;
    const float inv_denom = 1.0f / denom;
    if (denom > 0.f) {
#pragma unroll
      for (int a = 0; a < kAttnLen; ++a) {
        if (!valid[a]) continue;
        const float p = logit[a] * inv_denom;
#pragma unroll
        for (int c = 0; c < kMine; ++c) {
          float vf[8];
          unpack8(vs[unit(x.base_row + a, lane_q + c * kLanes)], vf);
#pragma unroll
          for (int y = 0; y < 8; ++y) acc[8 * c + y] = fmaf(p, vf[y], acc[8 * c + y]);
        }
      }
    }
    if (x.live) {
      uint4* og = reinterpret_cast<uint4*>(out + static_cast<size_t>(x.bh) * T * kHeadDim);
#pragma unroll
      for (int c = 0; c < kMine; ++c) {
        uint4 packed;
        __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int y = 0; y < 4; ++y) o2[y] = __floats2bfloat162_rn(acc[8 * c + 2 * y], acc[8 * c + 2 * y + 1]);
        og[static_cast<size_t>(x.t) * kPieces + lane_q + c * kLanes] = packed;
      }
    }
    __syncthreads();
    x = xn;
    w = wn;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched). The
// caller checks shapes, types, contiguity and 16-byte alignment; `first`
// holds H slot-0 offsets (in strides).
int dilated_attention_launch(const void* q, const void* k, const void* v,
                             const void* er, void* out, int B, int H, int T,
                             int D, int A, int dilation, int head7_from6,
                             const int* first, void* stream) {
  if (D != kHeadDim || A != kAttnLen || B <= 0 || H <= 0 || H > kMaxHeads ||
      T <= 0 || dilation <= 0 ||
      static_cast<long long>((T + kTile - 1) / kTile) * B * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  HeadOffsets offsets = {};
  for (int h = 0; h < H; ++h) offsets.first[h] = first[h];
  const size_t smem = smem_bytes(T, dilation);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dilated_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles_per_bh = (T + kTile - 1) / kTile;
  const int total = tiles_per_bh * B * H;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dilated_attention_kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = min(total, sms * per_sm);   // persistent: every block resident
  dilated_attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(er),
      static_cast<__nv_bfloat16*>(out), H, T, dilation, head7_from6, offsets,
      1.0f / sqrtf(static_cast<float>(D)), tiles_per_bh, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
