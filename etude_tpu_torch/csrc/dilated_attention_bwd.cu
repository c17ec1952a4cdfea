// Backward of the Beat-Transformer's dilated attention for Hopper (sm_90a),
// bound to Python through ctypes (etude_tpu_torch/ops/dilated_attention.py,
// `dilated_attention_backward`).
//
// The TPU kernel etude_tpu/ops/dilated_attention.py:276
// (dilated_attention_pallas) has no backward: the JAX package trains through
// the XLA form `dilated_attention` (:106), and this kernel computes the
// gradient that jax.grad takes there, given dO. With s = 1/sqrt(d), the
// slots a of query t at key rows pos_a = t + (a - 2 + shift_h) * dilation,
// and only valid slots (0 <= pos_a < T) counted:
//
//   p_a   = softmax_a((q . k[pos_a] + q . er[h, :, a]) * s)   recomputed
//   dp_a  = dO . v[pos_a]
//   ds_a  = p_a (dp_a - sum_b p_b dp_b)
//   dq    = s * sum_a ds_a (k[pos_a] + er[h, :, a])
//   dk[j] = s * sum_a ds_a(t) q_t,    over the t with pos_a(t) = j
//   dv[j] = sum_a p_a(t) dO_t,        over the same t
//   der[h, :, a] = s * sum_{b,t} ds_a q     (partial sums per block here)
//
// Recomputing p from q, k and er costs five dot products per query, less
// than storing it from the forward. With head7_from6, head 7 scores against
// head 6's keys (dilated_attention(head7_bug=True)): the gradient of those
// keys goes to head 6's rows, head 7's key gradient is zero, as JAX's
// k.at[:, 7].set(k[:, 6]) differentiates.
//
// Two launches, no atomics, so two runs give the same bits:
//  1. per query (one thread each): recompute p, write dq, and write p and ds
//     to an f32 scratch [B, H, T, 5]; each block of 128 queries of one
//     (b, h) writes its partial sum of der ([5, d] f32), reduced by a fixed
//     loop over the block's queries in shared memory;
//  2. per key row (one thread each): gather dk and dv from the scratch and
//     from q and dO through the five inverse offsets t = j - off_a * dilation.
// The wrapper sums der's partials over the blocks (a fixed-order sum).
//
// Layout [B, H, T, d], d = 32 contiguous (64-byte rows); er as [H, A, d] f32,
// as the forward takes it. dq, dk and dv come out in bf16, der in f32.
//
// Bound: q, k, v and dO read once and dq, dk and dv written once,
// 7 * B*H*T*d * 2 bytes (73.4 MB at the training shape B = 40, H = 8,
// T = 512: 21.9 us at 3.35 TB/s), plus the scratch p and ds written and read
// once (6.6 MB there). About 110 flops per (query, slot) on the CUDA cores,
// so bytes bound it. This design is the simple one: a thread reads its rows
// straight from L2 (each k, v, q and dO row up to 5 times), and the dot
// products run on the CUDA cores. Staging rows in shared memory as the
// forward does, and the d = 32 products on the tensor cores, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 32;
constexpr int kAttnLen = 5;
constexpr int kMaxHeads = 8;
constexpr int kPieces = kHeadDim * 2 / 16;   // 16-byte pieces of a row
constexpr int kThreads = 128;                // queries (or key rows) per block

struct HeadOffsets {
  int first[kMaxHeads];
};

__device__ __forceinline__ int first_of(const HeadOffsets& o, int h) {
  int f = o.first[0];
#pragma unroll
  for (int y = 1; y < kMaxHeads; ++y)
    if (y == h) f = o.first[y];
  return f;
}

__device__ __forceinline__ const uint4* row_ptr(const __nv_bfloat16* base, int row) {
  return reinterpret_cast<const uint4*>(base + static_cast<size_t>(row) * kHeadDim);
}

__device__ __forceinline__ void load_row(const __nv_bfloat16* base, int row, float* out) {
  const uint4* p = row_ptr(base, row);
#pragma unroll
  for (int c = 0; c < kPieces; ++c) {
    const uint4 raw = __ldg(p + c);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      out[8 * c + 2 * i] = f.x;
      out[8 * c + 2 * i + 1] = f.y;
    }
  }
}

// x . row, f32 sums of the bf16 row.
__device__ __forceinline__ float dot_row(const __nv_bfloat16* base, int row, const float* x) {
  const uint4* p = row_ptr(base, row);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kPieces; ++c) {
    const uint4 raw = __ldg(p + c);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      s = fmaf(x[8 * c + 2 * i], f.x, s);
      s = fmaf(x[8 * c + 2 * i + 1], f.y, s);
    }
  }
  return s;
}

// acc += alpha * row.
__device__ __forceinline__ void axpy_row(const __nv_bfloat16* base, int row, float alpha, float* acc) {
  const uint4* p = row_ptr(base, row);
#pragma unroll
  for (int c = 0; c < kPieces; ++c) {
    const uint4 raw = __ldg(p + c);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      acc[8 * c + 2 * i] = fmaf(alpha, f.x, acc[8 * c + 2 * i]);
      acc[8 * c + 2 * i + 1] = fmaf(alpha, f.y, acc[8 * c + 2 * i + 1]);
    }
  }
}

__device__ __forceinline__ void store_row(__nv_bfloat16* base, int row, const float* x) {
  uint4* p = reinterpret_cast<uint4*>(base + static_cast<size_t>(row) * kHeadDim);
#pragma unroll
  for (int c = 0; c < kPieces; ++c) {
    uint4 packed;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int i = 0; i < 4; ++i) o2[i] = __floats2bfloat162_rn(x[8 * c + 2 * i], x[8 * c + 2 * i + 1]);
    p[c] = packed;
  }
}

// Launch 1: one thread per query t of one (b, h) = blockIdx.y.
__global__ void __launch_bounds__(kThreads)
query_grad_kernel(const __nv_bfloat16* __restrict__ q,    // [B*H, T, d]
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const float* __restrict__ er,           // [H, A, d]
                  const __nv_bfloat16* __restrict__ dout, // [B*H, T, d]
                  __nv_bfloat16* __restrict__ dq,         // [B*H, T, d]
                  float* __restrict__ pbuf,               // [B*H, T, A]
                  float* __restrict__ dsbuf,              // [B*H, T, A]
                  float* __restrict__ der_part,           // [B*H, tiles, A, d]
                  int H, int T, int dilation, int head7_from6, HeadOffsets offsets,
                  float inv_sqrt_d) {
  __shared__ float q_s[kThreads][kHeadDim + 1];
  __shared__ float ds_s[kThreads][kAttnLen];
  const int bh = blockIdx.y;
  const int h = bh % H;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const bool live = t < T;
  const int first = first_of(offsets, h);
  const int k_head = (head7_from6 && h == 7) ? 6 : h;
  const size_t plane = static_cast<size_t>(T) * kHeadDim;
  const __nv_bfloat16* kb = k + (bh - h + k_head) * plane;
  const __nv_bfloat16* vb = v + bh * plane;
  const float* ers = er + h * kAttnLen * kHeadDim;

  float qf[kHeadDim], gf[kHeadDim];
  if (live) {
    load_row(q + bh * plane, t, qf);
    load_row(dout + bh * plane, t, gf);
  } else {
#pragma unroll
    for (int c = 0; c < kHeadDim; ++c) qf[c] = gf[c] = 0.f;
  }

  float logit[kAttnLen], dp[kAttnLen];
  int pos[kAttnLen];
  bool valid[kAttnLen];
#pragma unroll
  for (int a = 0; a < kAttnLen; ++a) {
    pos[a] = t + (first + a) * dilation;
    valid[a] = live && pos[a] >= 0 && pos[a] < T;
    float s = 0.f, g = 0.f, r = 0.f;
    if (valid[a]) {
      s = dot_row(kb, pos[a], qf);
      g = dot_row(vb, pos[a], gf);
    }
#pragma unroll
    for (int c = 0; c < kHeadDim; ++c) r = fmaf(qf[c], ers[a * kHeadDim + c], r);
    logit[a] = (s + r) * inv_sqrt_d;
    dp[a] = g;
  }
  // The forward's f32 softmax over the valid slots; a row with none is 0.
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
  const float inv_denom = denom > 0.f ? 1.0f / denom : 0.f;
  float p[kAttnLen], ds[kAttnLen];
  float pdp = 0.f;
#pragma unroll
  for (int a = 0; a < kAttnLen; ++a) {
    p[a] = logit[a] * inv_denom;
    pdp = fmaf(p[a], dp[a], pdp);
  }
  float acc[kHeadDim];
#pragma unroll
  for (int c = 0; c < kHeadDim; ++c) acc[c] = 0.f;
#pragma unroll
  for (int a = 0; a < kAttnLen; ++a) {
    ds[a] = p[a] * (dp[a] - pdp);
    if (valid[a]) {
      axpy_row(kb, pos[a], ds[a], acc);
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) acc[c] = fmaf(ds[a], ers[a * kHeadDim + c], acc[c]);
    }
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < kHeadDim; ++c) acc[c] *= inv_sqrt_d;
    store_row(dq + bh * plane, t, acc);
    const size_t o = (static_cast<size_t>(bh) * T + t) * kAttnLen;
#pragma unroll
    for (int a = 0; a < kAttnLen; ++a) {
      pbuf[o + a] = p[a];
      dsbuf[o + a] = ds[a];
    }
  }

  // der's partial sum over this block's queries, in a fixed order.
#pragma unroll
  for (int c = 0; c < kHeadDim; ++c) q_s[threadIdx.x][c] = qf[c];
#pragma unroll
  for (int a = 0; a < kAttnLen; ++a) ds_s[threadIdx.x][a] = live ? ds[a] : 0.f;
  __syncthreads();
  float* part = der_part + (static_cast<size_t>(bh) * gridDim.x + blockIdx.x) * kAttnLen * kHeadDim;
  for (int x = threadIdx.x; x < kAttnLen * kHeadDim; x += kThreads) {
    const int a = x / kHeadDim, c = x % kHeadDim;
    float s = 0.f;
    for (int i = 0; i < kThreads; ++i) s = fmaf(ds_s[i][a], q_s[i][c], s);
    part[x] = s * inv_sqrt_d;
  }
}

// Launch 2: one thread per key row j of one (b, h) = blockIdx.y.
__global__ void __launch_bounds__(kThreads)
key_grad_kernel(const __nv_bfloat16* __restrict__ q,     // [B*H, T, d]
                const __nv_bfloat16* __restrict__ dout,  // [B*H, T, d]
                const float* __restrict__ pbuf,          // [B*H, T, A]
                const float* __restrict__ dsbuf,         // [B*H, T, A]
                __nv_bfloat16* __restrict__ dk,          // [B*H, T, d]
                __nv_bfloat16* __restrict__ dv,          // [B*H, T, d]
                int H, int T, int dilation, int head7_from6, HeadOffsets offsets,
                float inv_sqrt_d) {
  const int bh = blockIdx.y;
  const int h = bh % H;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= T) return;
  const size_t plane = static_cast<size_t>(T) * kHeadDim;

  float acc[kHeadDim];
#pragma unroll
  for (int c = 0; c < kHeadDim; ++c) acc[c] = 0.f;
  // dv[j]: this head's queries whose slot a lands on row j.
  const int first = first_of(offsets, h);
#pragma unroll
  for (int a = 0; a < kAttnLen; ++a) {
    const int t = j - (first + a) * dilation;
    if (t >= 0 && t < T)
      axpy_row(dout + bh * plane, t, pbuf[(static_cast<size_t>(bh) * T + t) * kAttnLen + a], acc);
  }
  store_row(dv + bh * plane, j, acc);

  // dk[j]: the queries that scored against row j. Under head7_from6 head 6's
  // keys serve heads 6 and 7, and head 7's own keys serve none.
#pragma unroll
  for (int c = 0; c < kHeadDim; ++c) acc[c] = 0.f;
  const bool h7 = head7_from6 && H == kMaxHeads;
  const int n_src = (h7 && h == 7) ? 0 : ((h7 && h == 6) ? 2 : 1);
  for (int s = 0; s < n_src; ++s) {
    const int bs = bh + s;
    const int fs = first_of(offsets, h + s);
#pragma unroll
    for (int a = 0; a < kAttnLen; ++a) {
      const int t = j - (fs + a) * dilation;
      if (t >= 0 && t < T)
        axpy_row(q + bs * plane, t, dsbuf[(static_cast<size_t>(bs) * T + t) * kAttnLen + a], acc);
    }
  }
#pragma unroll
  for (int c = 0; c < kHeadDim; ++c) acc[c] *= inv_sqrt_d;
  store_row(dk + bh * plane, j, acc);
}

}  // namespace

extern "C" {

// Launches both kernels on `stream`; returns cudaGetLastError() (0 =
// launched). The caller checks shapes, types, contiguity and 16-byte
// alignment and allocates every output: dq, dk, dv like q; p and ds f32
// [B, H, T, A]; der_part f32 [B, H, ceil(T / 128), A, d]. `first` holds H
// slot-0 offsets (in strides).
int dilated_attention_bwd_launch(const void* q, const void* k, const void* v,
                                 const void* er, const void* dout, void* dq, void* dk,
                                 void* dv, void* pbuf, void* dsbuf, void* der_part,
                                 int B, int H, int T, int D, int A, int dilation,
                                 int head7_from6, const int* first, void* stream) {
  const int tiles = (T + kThreads - 1) / kThreads;
  if (D != kHeadDim || A != kAttnLen || B <= 0 || H <= 0 || H > kMaxHeads ||
      T <= 0 || dilation <= 0 || static_cast<long long>(B) * H > 65535LL)
    return static_cast<int>(cudaErrorInvalidValue);
  HeadOffsets offsets = {};
  for (int h = 0; h < H; ++h) offsets.first[h] = first[h];
  const dim3 grid(tiles, B * H);
  const float inv_sqrt_d = 1.0f / sqrtf(static_cast<float>(D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  query_grad_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(er),
      static_cast<const __nv_bfloat16*>(dout), static_cast<__nv_bfloat16*>(dq),
      static_cast<float*>(pbuf), static_cast<float*>(dsbuf), static_cast<float*>(der_part),
      H, T, dilation, head7_from6, offsets, inv_sqrt_d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  key_grad_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(pbuf), static_cast<const float*>(dsbuf),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      H, T, dilation, head7_from6, offsets, inv_sqrt_d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
