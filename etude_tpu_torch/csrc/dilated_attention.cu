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
//
// Every head's offsets include 0 (shifts -2..+2 around half = 2), so the
// query's own row is always a valid slot and no row is fully masked. The
// kernel defines that case anyway: a row with no valid slot is written as
// zeros, never NaN.
//
// Layout [B, H, T, d], d = 32 contiguous, so one row is 64 bytes. Four lanes
// share a query row and each holds 8 dims as one 16-byte vector; a warp
// covers 8 consecutive queries, so for a fixed slot its k (or v) loads are
// 512 contiguous bytes. k and v rows are gathered straight from global
// memory: the 5 slots of neighbouring queries overlap, and that reuse comes
// from L1/L2. A row position is checked against [0, T) before it is read, so
// nothing before or after the tensor is touched, and T need not be a
// multiple of the block.
//
// What the TPU kernel did and this one does not: the union of shifted key
// rows followed by a one-hot selection matmul (Mosaic rejects batched dots
// and boolean vregs), and a 128-aligned halo (Mosaic's lane alignment). A
// thread here indexes its 5 rows directly.
//
// Bound: q, k and v are read once and o written once, 4 * B*H*T*d * 2 bytes:
// 125.8 MB at B = 5, H = 8, T = 12288, d = 32, about 37.6 us at the data
// sheet's 3.35 TB/s. The work is about 22 flops per (query, slot, dim), about
// 0.5 GFLOP, so the kernel is bound by bytes. What the simple design leaves
// on the table: each k and v row is requested by up to 5 queries, so L2
// serves about 5x the k/v bytes; no shared-memory tile, no cp.async/TMA
// pipeline; one 16-byte load per lane per slot keeps few bytes in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 32;
constexpr int kAttnLen = 5;
constexpr int kMaxHeads = 8;
constexpr int kLanesPerRow = 4;                           // 4 lanes x 8 bf16 = 64 bytes
constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / kLanesPerRow;    // 64 queries per block
constexpr unsigned kFull = 0xffffffffu;

struct HeadOffsets {
  int first[kMaxHeads];   // offset of slot 0 in strides, per head
};

__device__ __forceinline__ void load_row8(const __nv_bfloat16* p, float out[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float group_sum(float x) {
  // Sum over the 4 lanes of one query row (lanes 4j..4j+3).
  x += __shfl_xor_sync(kFull, x, 1);
  x += __shfl_xor_sync(kFull, x, 2);
  return x;
}

__global__ void __launch_bounds__(kThreads)
dilated_attention_kernel(const __nv_bfloat16* __restrict__ q,    // [B*H, T, d]
                         const __nv_bfloat16* __restrict__ k,    // [B*H, T, d]
                         const __nv_bfloat16* __restrict__ v,    // [B*H, T, d]
                         const float* __restrict__ er,           // [H, A, d] f32
                         __nv_bfloat16* __restrict__ out,        // [B*H, T, d]
                         int H, int T, int dilation, int head7_from6,
                         HeadOffsets offsets, float sqrt_d) {
  const int bh = blockIdx.y;
  const int h = bh % H;
  const int t = blockIdx.x * kRowsPerBlock + threadIdx.x / kLanesPerRow;
  const int seg = threadIdx.x % kLanesPerRow;              // which 8 dims
  // Lanes past T stay in the loop (the shuffles need all 32) but load and
  // store nothing.
  const bool live = t < T;
  const int k_head = (head7_from6 && h == 7) ? 6 : h;
  const size_t qv_base = static_cast<size_t>(bh) * T * kHeadDim + seg * 8;
  const size_t k_base = static_cast<size_t>(bh - h + k_head) * T * kHeadDim + seg * 8;
  const int first = offsets.first[h];

  float qf[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) qf[i] = 0.f;
  if (live) load_row8(q + qv_base + static_cast<size_t>(t) * kHeadDim, qf);

  float logit[kAttnLen];
  bool valid[kAttnLen];
#pragma unroll
  for (int a = 0; a < kAttnLen; ++a) {
    const int pos = t + (first + a) * dilation;
    valid[a] = live && pos >= 0 && pos < T;
    float s = 0.f;
    if (valid[a]) {
      float kf[8];
      load_row8(k + k_base + static_cast<size_t>(pos) * kHeadDim, kf);
#pragma unroll
      for (int i = 0; i < 8; ++i) s = fmaf(qf[i], kf[i], s);
    }
    const float4* e4 = reinterpret_cast<const float4*>(
        er + (static_cast<size_t>(h) * kAttnLen + a) * kHeadDim + seg * 8);
    const float4 e0 = __ldg(e4), e1 = __ldg(e4 + 1);
    float r = 0.f;
    r = fmaf(qf[0], e0.x, r); r = fmaf(qf[1], e0.y, r);
    r = fmaf(qf[2], e0.z, r); r = fmaf(qf[3], e0.w, r);
    r = fmaf(qf[4], e1.x, r); r = fmaf(qf[5], e1.y, r);
    r = fmaf(qf[6], e1.z, r); r = fmaf(qf[7], e1.w, r);
    logit[a] = (group_sum(s) + group_sum(r)) / sqrt_d;
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

  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  if (denom > 0.f) {
#pragma unroll
    for (int a = 0; a < kAttnLen; ++a) {
      if (!valid[a]) continue;
      const float p = logit[a] / denom;
      const int pos = t + (first + a) * dilation;
      float vf[8];
      load_row8(v + qv_base + static_cast<size_t>(pos) * kHeadDim, vf);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
    }
  }
  if (!live) return;
  uint4 packed;
  __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int i = 0; i < 4; ++i) o2[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
  *reinterpret_cast<uint4*>(out + qv_base + static_cast<size_t>(t) * kHeadDim) = packed;
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
      T <= 0 || dilation <= 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  HeadOffsets offsets = {};
  for (int h = 0; h < H; ++h) offsets.first[h] = first[h];
  const dim3 grid((T + kRowsPerBlock - 1) / kRowsPerBlock, B * H);
  dilated_attention_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(er),
      static_cast<__nv_bfloat16*>(out), H, T, dilation, head7_from6, offsets,
      sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
