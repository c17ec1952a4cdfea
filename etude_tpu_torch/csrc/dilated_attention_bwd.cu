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
//   der[h, :, a] = s * sum_{b,t} ds_a q     (one partial per block here)
//
// With head7_from6, head 7 scores against head 6's keys
// (dilated_attention(head7_bug=True)): the gradient of those keys goes to
// head 6's rows and head 7's key gradient is zero, as JAX's
// k.at[:, 7].set(k[:, 6]) differentiates.
//
// Layout [B, H, T, d], d = 32 contiguous (64-byte rows, four 16-byte
// pieces); er as it comes, [H, d, A] in bf16 or f32. dq, dk and dv come out
// in bf16, der's partials in f32.
//
// Bound: q, k, v and dO read once and dq, dk and dv written once,
// 7 * B*H*T*d * 2 bytes: 73.4 MB at the training shape B = 40, H = 8,
// T = 512, 21.9 us at 3.35 TB/s (0.0657 ms at B = 5, T = 12,288). About
// B*H*T*5 * (16d + 12) = 0.43 GFLOP there, 6.4 us on the CUDA cores at
// 67 TFLOP/s f32, so bytes bound it. The tensor cores below are not there
// for the flops: they cut the instructions that the PR 9 design issued per
// byte (bf16 unpacking and f32 dot products, 255 registers), which kept it
// far from the byte bound.
//
// Design: one launch, tiles in K2's strided view. Order the T positions of
// one (b, h) by residue mod the dilation, then by position: u = offset(r) + j
// for t = r + j * dilation. Within one class, query j's slot a is class row
// j + first + a (first = a - 2 + shift at a = 0, in -4..0), so the rows a
// query touches are its neighbours in u. A tile is kTile = 64 consecutive u
// of one (b, h); its block writes dq, dk and dv of exactly those positions,
// so the tiles partition every output, and a partial of der over them.
//  - Windows. It stages the k and v rows within 4 of its own (the keys of its
//    queries and of the queries that reach its key rows) and the q and dO
//    rows of the queries that reach its key rows (u - first - 4 ..
//    u - first), each window clipped to the class of the tile's first or
//    last position. A class that the tile holds whole needs nothing outside
//    it, so only the two end classes add rows: at most 8 k/v and 4 q/dO rows
//    per tile at any dilation, none at T = 512, dilation 256. The python
//    mirror `backward_tiles` computes the same windows (tested on the CPU for
//    every dilation 1..256). Staged row x holds u0 - 4 + x, so query m's slot
//    a is staged row m + first + a and key row m's slot-a query m - first - a;
//    rows outside a window are zeros, so no product tests the window.
//  - Tensor cores. Per 16 staged queries, q . k and dO . v over the band of
//    24 key rows, and q . er, are mma.sync m16n8k16 bf16 products with f32
//    sums (bf16 products are exact); a lane per query then takes the f32
//    softmax and ds into shared memory (no global scratch). dq = ds . (k +
//    er), dk = ds^T . q, dv = p^T . dO and der = ds^T . q are band-shaped mma
//    products too, their f32 operand (p or ds) split into bf16 hi + lo (to
//    2^-16 of its value), B operands transposed out of the staged rows by
//    ldmatrix. er enters as bf16 rows, rounded and rest (exact for bf16 er).
//    Staged rows are permuted by piece so that ldmatrix is free of bank
//    conflicts.
//  - Steps per tile: (1) p and ds of every staged query, a warp per 16
//    (5 tasks for 8 warps), while the 3 warps without a task stage the next
//    tile (cp.async into the other of two stages: their loads wait for the
//    memory, the tasks do not); (2) a warp per 16 own rows: dq and der's
//    partial (4 warps), or dk and dv (4 warps).
//  - Persistent blocks of 256 threads, every block resident; 80 registers,
//    no spills; 64,512 bytes of shared memory (3 blocks per SM), 105,216
//    under head7_from6 (2 blocks).
//  - der: each of the 4 dq warps leaves a [A, d] partial of its 16 queries;
//    they are summed in order under a barrier of those warps alone and
//    written as [H, A, d, B * tiles], which the wrapper sums along the last
//    axis (a fixed-order sum). No atomics: two runs give the same bits.
//  - head7_from6: the block of (b, 6) also stages head 7's q, dO and v rows
//    at head 7's windows and computes head 7's ds against head 6's keys, so
//    head 6's dk takes both heads' terms; the block of (b, 7) stages head
//    6's keys and writes dk = 0 (only reference weights set it).
//
// What it still leaves behind (PERF.md, NVIDIA H100 80GB HBM3, 700 W): the
// kernel alone takes about 48 us at B = 40, T = 512 against the 21.9 us
// bound, about 1.6 TB/s; without its stores it takes 35 us, so the
// writes of dq, dk and dv and the loads that wait behind them bound it, not
// the arithmetic (whole-row stores, through shared memory or a transpose
// across lanes, were slower). The wrapper's sum of der's partials is a
// second kernel of about 5 us.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 32;
constexpr int kAttnLen = 5;
constexpr int kHalo = kAttnLen - 1;              // rows a window reaches beyond the tile
constexpr int kMaxHeads = 8;
constexpr int kPieces = kHeadDim * 2 / 16;       // 16-byte pieces of a bf16 row
constexpr int kTile = 64;                        // strided positions per tile
constexpr int kGroups = kTile / 16;              // 16-row groups of a tile's own rows
constexpr int kAlloc = 96;                       // staged rows held per tensor (reads reach 91)
constexpr int kErRows = 16;                      // per head: er rounded to bf16, then the rest
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kErSize = kAttnLen * kHeadDim;
constexpr int kUnits = kAlloc * kPieces;         // 16-byte units of one staged tensor

static_assert(2 * kGroups == kWarps, "one gradient task (dq or dk/dv of 16 rows) per warp");

struct HeadOffsets {
  int first[kMaxHeads];
};

// Shared memory. One stage holds a tile's k, v, q and dO rows (under
// head7_from6 also head 7's v, q and dO rows) and the rows' positions; two
// stages; then p and ds [kAlloc, A] f32 (and head 7's), der's per-group
// partials [kGroups, A, d] f32, and every head's er as bf16 rows.
__host__ __device__ constexpr size_t stage_bytes(bool h7) {
  return (h7 ? 7 : 4) * kUnits * 16 + kAlloc * 4;
}
__host__ __device__ constexpr size_t smem_bytes(bool h7) {
  return 2 * stage_bytes(h7) + (h7 ? 4 : 2) * kAlloc * kAttnLen * 4 + kGroups * kErSize * 4
         + kMaxHeads * kErRows * kPieces * 16;
}
static_assert(stage_bytes(false) % 16 == 0 && stage_bytes(true) % 16 == 0, "stages stay 16-byte aligned");

// The arrays of one stage, from its base (one register rather than eight
// pointers).
template <bool kH7>
struct Stage {
  unsigned char* base;
  __device__ uint4* K() const { return reinterpret_cast<uint4*>(base); }
  __device__ uint4* V() const { return K() + kUnits; }
  __device__ uint4* Q() const { return K() + 2 * kUnits; }
  __device__ uint4* G() const { return K() + 3 * kUnits; }
  __device__ uint4* V7() const { return K() + 4 * kUnits; }   // only under head7_from6
  __device__ uint4* Q7() const { return K() + 5 * kUnits; }
  __device__ uint4* G7() const { return K() + 6 * kUnits; }
  __device__ int* tpos() const { return reinterpret_cast<int*>(K() + (kH7 ? 7 : 4) * kUnits); }
};

// 16-byte unit of piece p of staged row r: the pieces are permuted by row so
// that the 8 rows of an 8x8 ldmatrix tile fall on 8 different bank groups.
__device__ __forceinline__ int unit(int r, int p) { return r * kPieces + (p ^ ((r >> 1) & 3)); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// Four 8x8 bf16 tiles; lane l gives the address of row l % 8 of tile l / 8.
__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x, y) as bf16 pairs hi + lo, so that hi + lo = (x, y) to 2^-16 of |x|:
// an f32 operand of the tensor cores in two bf16 products.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The strided view of one (b, h): `dilation` classes, the first T % dilation
// of them one position longer.
struct Strided {
  int T, dilation, qn, rem, long_part;
  __device__ Strided(int T_, int dilation_)
      : T(T_), dilation(dilation_), qn(T_ / dilation_), rem(T_ % dilation_),
        long_part((T_ % dilation_) * (T_ / dilation_ + 1)) {}
  // Class row j, class length and position t of strided position u.
  __device__ __forceinline__ void locate(int u, int& j, int& len, int& t) const {
    int r;
    if (u < long_part) {
      len = qn + 1; r = u / len; j = u - r * len;
    } else {
      len = qn; r = rem + (u - long_part) / qn; j = (u - long_part) - (r - rem) * qn;
    }
    t = r + j * dilation;
  }
};

// Tile w of the launch: (b, h) = w / tiles, strided positions
// [u0, u0 + n); the windows in staged rows (row x holds strided position
// u0 - kHalo + x), clipped to the classes of the tile's first and last
// positions (`backward_tiles` in the wrapper mirrors this).
struct Tile {
  int bh, h, tile, u0, n, f, f7, k_head;
  bool extra;                                    // head 6's keys also serve head 7
  int k_lo, k_hi, q_lo, q_hi, q7_lo, q7_hi;
};

template <bool kH7>
__device__ __forceinline__ Tile locate_tile(int w, int tiles, int H, int T, int dilation,
                                            const HeadOffsets& offsets) {
  const Strided view(T, dilation);
  Tile x;
  x.bh = w / tiles;
  x.tile = w - x.bh * tiles;
  x.h = x.bh % H;
  x.f = offsets.first[0];
#pragma unroll
  for (int y = 1; y < kMaxHeads; ++y)
    if (y == x.h) x.f = offsets.first[y];
  x.f7 = offsets.first[kMaxHeads - 1];
  x.extra = kH7 && x.h == 6;
  x.k_head = (kH7 && x.h == 7) ? 6 : x.h;
  x.u0 = x.tile * kTile;
  x.n = min(kTile, view.T - x.u0);
  int head, len, t, j_last;
  view.locate(x.u0, head, len, t);
  view.locate(x.u0 + x.n - 1, j_last, len, t);
  const int tail = len - 1 - j_last;
  x.k_lo = kHalo - min(kHalo, head);
  x.k_hi = kHalo + x.n + min(kHalo, tail);
  x.q_lo = kHalo - min(head, x.f + kHalo);
  x.q_hi = kHalo + x.n + min(tail, -x.f);
  x.q7_lo = kHalo - min(head, x.f7 + kHalo);
  x.q7_hi = kHalo + x.n + min(tail, -x.f7);
  return x;
}

// Stage half of tile x with threads t0, t0 + stride, ...: part 0 the k and
// v rows (and head 7's v rows) and the rows' positions; part 1 the q and dO
// rows (and head 7's). Every row 0 .. kAlloc of every tensor is written,
// with the rows outside a tensor's window set to zero, so the products
// below read every row without a branch.
template <bool kH7>
__device__ __forceinline__ void stage_part(int part, const Tile& x, const Stage<kH7>& s,
                                           int T, int dilation, const __nv_bfloat16* q,
                                           const __nv_bfloat16* k, const __nv_bfloat16* v,
                                           const __nv_bfloat16* dout, int t0, int stride) {
  const Strided view(T, dilation);
  const size_t bh_off = static_cast<size_t>(x.bh) * view.T * kHeadDim;
  const size_t next = static_cast<size_t>(view.T) * kPieces;   // head 7's rows after head 6's
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const uint4* a_src = reinterpret_cast<const uint4*>(
      part == 0 ? k + static_cast<size_t>(x.bh - x.h + x.k_head) * view.T * kHeadDim : q + bh_off);
  const uint4* b_src = reinterpret_cast<const uint4*>((part == 0 ? v : dout) + bh_off);
  uint4* a_dst = part == 0 ? s.K() : s.Q();
  uint4* b_dst = part == 0 ? s.V() : s.G();
  const int lo = part == 0 ? x.k_lo : x.q_lo, hi = part == 0 ? x.k_hi : x.q_hi;
  const int lo7 = part == 0 ? x.k_lo : x.q7_lo, hi7 = part == 0 ? x.k_hi : x.q7_hi;
  for (int e = t0; e < kUnits; e += stride) {
    const int row = e / kPieces, p = e % kPieces, d = unit(row, p);
    const int u = x.u0 - kHalo + row;
    int j, len, t = -1;
    if (row < x.n + 2 * kHalo && u >= 0 && u < view.T) view.locate(u, j, len, t);
    if (part == 0 && p == 0) s.tpos()[row] = t;
    const size_t src = static_cast<size_t>(t) * kPieces + p;
    if (row >= lo && row < hi) {
      cp_async16(a_dst + d, a_src + src);
      cp_async16(b_dst + d, b_src + src);
    } else {
      a_dst[d] = zero;
      b_dst[d] = zero;
    }
    if (kH7 && x.extra) {
      const bool in7 = row >= lo7 && row < hi7;
      if (part == 1) {
        if (in7) cp_async16(s.Q7() + d, a_src + next + src); else s.Q7()[d] = zero;
      }
      uint4* b7 = part == 0 ? s.V7() : s.G7();
      if (in7) cp_async16(b7 + d, b_src + next + src); else b7[d] = zero;
    }
  }
}

// Scores of 16 staged queries m0 .. m0 + 15 of one head (slot-0 offset f)
// on the tensor cores: q . k over the 24 key rows m0 + f .. m0 + f + 23 (a
// query's 5 slots lie on a band of them), and q . er from the head's er
// rows (bf16 hi and lo). Writes the band: P[m][a] = q . k[m + f + a] +
// q . er_a (unscaled, every slot; the softmax pass masks).
__device__ __forceinline__ void score_task(const uint4* qs, const uint4* ks, const uint4* er_rows,
                                           float* P, int m0, int f) {
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int tr = lane % 8, tm = lane / 8;
  uint32_t a[2][4], b[4];
#pragma unroll
  for (int st = 0; st < 2; ++st)
    ldsm_x4(smem_addr(qs + unit(m0 + tr + (tm & 1) * 8, 2 * st + (tm >> 1))), a[st]);
  float acc[4][4] = {};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    ldsm_x4(smem_addr(ks + unit(m0 + f + 8 * j + tr, tm)), b);
    mma_bf16(acc[j], a[0], b[0], b[1]);
    mma_bf16(acc[j], a[1], b[2], b[3]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {                  // er rounded, then its rest: one sum
    ldsm_x4(smem_addr(er_rows + unit(8 * j + tr, tm)), b);
    mma_bf16(acc[3], a[0], b[0], b[1]);
    mma_bf16(acc[3], a[1], b[2], b[3]);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = g + (e >> 1) * 8, a_slot = 8 * j + 2 * tig + (e & 1) - i;
      if (a_slot >= 0 && a_slot < kAttnLen) P[(m0 + i) * kAttnLen + a_slot] = acc[j][e];
    }
  __syncwarp();
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = g + (e >> 1) * 8, c = 2 * tig + (e & 1);
    if (c < kAttnLen) P[(m0 + i) * kAttnLen + c] += acc[3][e];
  }
}

// dO . v over the band of 16 staged queries: DS[m][a] = dO_m . v[m + f + a].
__device__ __forceinline__ void dp_task(const uint4* gs, const uint4* vs, float* DS, int m0, int f) {
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int tr = lane % 8, tm = lane / 8;
  uint32_t a[2][4], b[4];
#pragma unroll
  for (int st = 0; st < 2; ++st)
    ldsm_x4(smem_addr(gs + unit(m0 + tr + (tm & 1) * 8, 2 * st + (tm >> 1))), a[st]);
  float acc[3][4] = {};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    ldsm_x4(smem_addr(vs + unit(m0 + f + 8 * j + tr, tm)), b);
    mma_bf16(acc[j], a[0], b[0], b[1]);
    mma_bf16(acc[j], a[1], b[2], b[3]);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = g + (e >> 1) * 8, a_slot = 8 * j + 2 * tig + (e & 1) - i;
      if (a_slot >= 0 && a_slot < kAttnLen) DS[(m0 + i) * kAttnLen + a_slot] = acc[j][e];
    }
}

// The forward's f32 softmax and its gradient for the staged row m of one
// head, in place: P[m] holds the logits' sums, DS[m] dO . v; out come p and
// ds (zero on an invalid slot). The query's own row is always a valid slot.
__device__ __forceinline__ void softmax_row(float* P, float* DS, int m, int t, int f, int dilation,
                                            int T, float inv_sqrt_d) {
  float p[kAttnLen], dp[kAttnLen];
  bool valid[kAttnLen];
  float mx = -INFINITY;
#pragma unroll
  for (int a = 0; a < kAttnLen; ++a) {
    const int tk = t + (f + a) * dilation;
    valid[a] = tk >= 0 && tk < T;
    p[a] = P[m * kAttnLen + a] * inv_sqrt_d;
    dp[a] = DS[m * kAttnLen + a];
    if (valid[a]) mx = fmaxf(mx, p[a]);
  }
  float denom = 0.f;
#pragma unroll
  for (int a = 0; a < kAttnLen; ++a) {
    p[a] = valid[a] ? expf(p[a] - mx) : 0.f;
    denom += p[a];
  }
  const float inv_denom = 1.0f / denom;
  float pdp = 0.f;
#pragma unroll
  for (int a = 0; a < kAttnLen; ++a) {
    p[a] *= inv_denom;
    pdp = fmaf(p[a], dp[a], pdp);
  }
#pragma unroll
  for (int a = 0; a < kAttnLen; ++a) {
    P[m * kAttnLen + a] = p[a];
    DS[m * kAttnLen + a] = p[a] * (dp[a] - pdp);
  }
}

// Writes rows m0 + g and m0 + g + 8 of a 16x32 f32 product (4 n-tiles, as
// mma leaves them) times `scale` to a [T, d] bf16 plane, for the rows below
// `end`.
__device__ __forceinline__ void store_rows(const float (*acc)[4], float scale, const int* tpos,
                                           int m0, int end, __nv_bfloat16* plane) {
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + g + 8 * half;
    if (m >= end) continue;
    uint32_t* row = reinterpret_cast<uint32_t*>(plane + static_cast<size_t>(tpos[m]) * kHeadDim);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      row[4 * j + tig] = bits(__floats2bfloat162_rn(acc[j][2 * half] * scale,
                                                    acc[j][2 * half + 1] * scale));
  }
}

// acc (16 x 32: 4 n-tiles of 8 dims) += A . B over the k-step k0 .. k0 + 15.
// A(i, c) = val(i, c), an f32 band (p or ds) split into bf16 hi + lo; B's
// row kk is a staged bf16 row in [kk, d] layout, addr(kk, piece) its
// 16-byte pieces, transposed into fragments by ldmatrix.
template <class Val, class Addr>
__device__ __forceinline__ void band_mma(float (*acc)[4], int k0, Val val, Addr addr) {
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int tr = lane % 8, tm = lane / 8;
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = g + (r & 1) * 8, c = k0 + 2 * tig + (r >> 1) * 8;
    split2(val(i, c), val(i, c + 1), hi[r], lo[r]);
  }
#pragma unroll
  for (int jp = 0; jp < 2; ++jp) {
    uint32_t b[4];
    ldsm_x4_trans(smem_addr(addr(k0 + tr + (tm & 1) * 8, 2 * jp + (tm >> 1))), b);
    mma_bf16(acc[2 * jp], hi, b[0], b[1]);
    mma_bf16(acc[2 * jp], lo, b[0], b[1]);
    mma_bf16(acc[2 * jp + 1], hi, b[2], b[3]);
    mma_bf16(acc[2 * jp + 1], lo, b[2], b[3]);
  }
}

// Persistent blocks: block b computes tiles w = b, b + gridDim.x, ... and
// stages tile w + gridDim.x into the other stage while it computes tile w.
template <bool kH7>   // head7_from6 with 8 heads
__global__ void __launch_bounds__(kThreads, 3)
dilated_attention_bwd_kernel(const __nv_bfloat16* __restrict__ q,    // [B*H, T, d]
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const void* __restrict__ er,            // [H, d, A]
                             const __nv_bfloat16* __restrict__ dout, // [B*H, T, d]
                             __nv_bfloat16* __restrict__ dq,         // [B*H, T, d]
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv,
                             float* __restrict__ der_part,           // [H, A, d, B * tiles]
                             int H, int T, int dilation, int er_bf16, HeadOffsets offsets,
                             float inv_sqrt_d, int tiles, int total) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool h7 = kH7;
  float* P = reinterpret_cast<float*>(smem + 2 * stage_bytes(h7));
  float* DS = P + kAlloc * kAttnLen;
  float* P7 = DS + kAlloc * kAttnLen;            // only under head7_from6
  float* DS7 = P7 + kAlloc * kAttnLen;
  float* der_groups = P + (h7 ? 4 : 2) * kAlloc * kAttnLen;   // [kGroups, A, d]
  uint4* er_rows = reinterpret_cast<uint4*>(der_groups + kGroups * kErSize);

  for (int part = 0; part < 2; ++part)
    stage_part<kH7>(part, locate_tile<kH7>(blockIdx.x, tiles, H, T, dilation, offsets),
                    Stage<kH7>{smem}, T, dilation, q, k, v, dout, threadIdx.x, kThreads);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // Every head's er as 16 bf16 rows: rows 0-4 er[:, a] rounded, rows 8-12
  // the rest, er - rounded (0 for bf16 er), the others 0.
  for (int e = threadIdx.x; e < kMaxHeads * kErRows * kPieces; e += kThreads) {
    const int hh = e / (kErRows * kPieces), row = e / kPieces % kErRows;
    const int pc = e % kPieces, a = row % 8;
    float x[8];
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      const size_t o = (static_cast<size_t>(hh) * kHeadDim + 8 * pc + y) * kAttnLen + a;
      x[y] = (hh < H && a < kAttnLen)
                 ? (er_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(er)[o])
                            : static_cast<const float*>(er)[o])
                 : 0.f;
    }
    uint4 packed;
    uint32_t* w4 = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      uint32_t hi, lo;
      split2(x[2 * y], x[2 * y + 1], hi, lo);
      w4[y] = row < 8 ? hi : lo;
    }
    er_rows[hh * kErRows * kPieces + unit(row, pc)] = packed;
  }

  // The tile's geometry lives in shared memory, read where it is used, so
  // that it holds no registers across the steps; two copies, so that tile
  // w + gridDim.x's is written while tile w's is still read.
  __shared__ Tile tiles_s[2];
  for (int w = blockIdx.x, it = 0; w < total; w += gridDim.x, ++it) {
    if (threadIdx.x == 0) tiles_s[it & 1] = locate_tile<kH7>(w, tiles, H, T, dilation, offsets);
    const Tile& x = tiles_s[it & 1];
    const int warp = threadIdx.x / 32;
    const Stage<kH7> s{smem + (it & 1) * stage_bytes(h7)};
    const int wn = w + gridDim.x;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");   // tile w
    __syncthreads();

    // 1. p and ds of every staged query, one task per 16 rows: scores and
    //    dO . v on the tensor cores, then the softmax, a lane per row. This
    //    head's rows, then (head 6's tile under head7_from6) head 7's against
    //    head 6's keys. The rows that no task covers are zeros, so that the
    //    band operands below need no test of the window. The warps without
    //    a task in the last round stage tile wn meanwhile: their loads wait
    //    for the memory, the tasks do not.
    const uint4* er_h = er_rows + x.h * kErRows * kPieces;
    const uint4* er_7 = er_rows + (kMaxHeads - 1) * kErRows * kPieces;
    const int groups = (x.q_hi - x.q_lo + 15) / 16, groups7 = (x.q7_hi - x.q7_lo + 15) / 16;
    const int tasks = groups + (x.extra ? groups7 : 0);
    for (int e = threadIdx.x; e < (x.extra ? 2 : 1) * kAlloc; e += kThreads) {
      const bool seven = e >= kAlloc;
      const int m = e % kAlloc, lo = seven ? x.q7_lo : x.q_lo;
      if (m >= lo && m < lo + 16 * (seven ? groups7 : groups)) continue;
      float* Pp = seven ? P7 : P;
      float* Dp = seven ? DS7 : DS;
#pragma unroll
      for (int a = 0; a < kAttnLen; ++a) Pp[m * kAttnLen + a] = Dp[m * kAttnLen + a] = 0.f;
    }
    for (int task = warp; task < tasks; task += kWarps) {
      const bool seven = task >= groups;
      const int lo = seven ? x.q7_lo : x.q_lo, hi = seven ? x.q7_hi : x.q_hi;
      const int m0 = lo + 16 * (seven ? task - groups : task), f = seven ? x.f7 : x.f;
      float* Pp = seven ? P7 : P;
      float* Dp = seven ? DS7 : DS;
      score_task(seven ? s.Q7() : s.Q(), s.K(), seven ? er_7 : er_h, Pp, m0, f);
      dp_task(seven ? s.G7() : s.G(), seven ? s.V7() : s.V(), Dp, m0, f);
      __syncwarp();
      const int lane = threadIdx.x % 32, m = m0 + lane;
      if (lane < 16) {
        if (m < hi) {
          softmax_row(Pp, Dp, m, s.tpos()[m], f, dilation, T, inv_sqrt_d);
        } else {
#pragma unroll
          for (int a = 0; a < kAttnLen; ++a) Pp[m * kAttnLen + a] = Dp[m * kAttnLen + a] = 0.f;
        }
      }
    }
    const int stagers = tasks % kWarps == 0 ? 0 : tasks % kWarps;   // first staging warp
    if (wn < total && warp >= stagers) {
      const Tile xn = locate_tile<kH7>(wn, tiles, H, T, dilation, offsets);
      const Stage<kH7> sn{smem + ((it + 1) & 1) * stage_bytes(h7)};
      for (int part = 0; part < 2; ++part)
        stage_part(part, xn, sn, T, dilation, q, k, v, dout, threadIdx.x - 32 * stagers,
                   kThreads - 32 * stagers);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");   // tile wn
    __syncthreads();

    // 2. One task per warp over 16 own rows m0 .. m0 + 15 (own rows are
    //    kHalo .. end): dq and der's partial of those queries, or dk and dv
    //    of those key rows.
    const size_t bh_off = static_cast<size_t>(x.bh) * T * kHeadDim;
    const int end = kHalo + x.n;
    const int grp = warp % kGroups, m0 = kHalo + 16 * grp;
    if (warp < kGroups) {
      float acc[4][4] = {};
      if (m0 < end) {
        // dq = ds . [k rows m0 + f .. m0 + f + 23; er rounded; er's rest],
        // k = 48 (the last 8 columns of A are 0).
        const int kb = m0 + x.f;
        auto val = [&](int i, int c) {
          const int a = c < 24 ? c - i : (c - 24) % 8;
          return (c < 40 && a >= 0 && a < kAttnLen) ? DS[(m0 + i) * kAttnLen + a] : 0.f;
        };
        auto addr = [&](int kk, int pc) {
          return kk < 24 ? s.K() + unit(kb + kk, pc) : er_h + unit(kk < 32 ? kk - 24 : 8 + kk % 8, pc);
        };
#pragma unroll
        for (int k0 = 0; k0 < 48; k0 += 16) band_mma(acc, k0, val, addr);
        store_rows(acc, inv_sqrt_d, s.tpos(), m0, end, dq + bh_off);
        // der's partial: rows = slots, k = the 16 queries (own ones only).
        float part[4][4] = {};
        band_mma(part, 0,
                 [&](int a, int c) {
                   return (a < kAttnLen && m0 + c < end) ? DS[(m0 + c) * kAttnLen + a] : 0.f;
                 },
                 [&](int kk, int pc) { return s.Q() + unit(m0 + kk, pc); });
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j][0] = part[j][0], acc[j][1] = part[j][1];
      }
      const int g = threadIdx.x % 32 / 4, tig = threadIdx.x % 4;
      if (g < kAttnLen) {                        // rows g of the partial (slot g); 0 if no own rows
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float2*>(der_groups + (grp * kAttnLen + g) * kHeadDim + 8 * j + 2 * tig) =
              m0 < end ? make_float2(acc[j][0], acc[j][1]) : make_float2(0.f, 0.f);
      }
      // der's partial of the tile: the groups summed in order, once the dq
      // warps (barrier 1) have written theirs; [H, A, d, B * tiles], so that
      // the wrapper sums along the last, contiguous axis.
      asm volatile("bar.sync 1, %0;\n" :: "n"(kGroups * 32) : "memory");
      const size_t n_part = static_cast<size_t>(total) / H;
      const size_t col = static_cast<size_t>(x.bh / H) * tiles + x.tile;
      for (int e = threadIdx.x; e < kErSize; e += kGroups * 32) {
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < kGroups; ++c) sum += der_groups[c * kErSize + e];
        der_part[(static_cast<size_t>(x.h) * kErSize + e) * n_part + col] = sum * inv_sqrt_d;
      }
    } else if (m0 < end) {
      // dk = ds^T . q and dv = p^T . dO over the queries m0 - f - 4 ..
      // m0 - f + 27 that reach key rows m0 .. m0 + 15 (slot i - c + 4).
      const int qb = m0 - x.f - kHalo;
      auto band = [&](const float* table, int base) {
        return [=](int i, int c) {
          const int a = i - c + kHalo;
          return (a >= 0 && a < kAttnLen) ? table[(base + c) * kAttnLen + a] : 0.f;
        };
      };
      float acc[4][4] = {};
      if (!(h7 && x.h == 7)) {                   // head 7's keys serve no query: dk = 0
#pragma unroll
        for (int k0 = 0; k0 < 32; k0 += 16)
          band_mma(acc, k0, band(DS, qb), [&](int kk, int pc) { return s.Q() + unit(qb + kk, pc); });
        if (x.extra) {
          const int qb7 = m0 - x.f7 - kHalo;
#pragma unroll
          for (int k0 = 0; k0 < 32; k0 += 16)
            band_mma(acc, k0, band(DS7, qb7), [&](int kk, int pc) { return s.Q7() + unit(qb7 + kk, pc); });
        }
      }
      store_rows(acc, inv_sqrt_d, s.tpos(), m0, end, dk + bh_off);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < 32; k0 += 16)
        band_mma(acc, k0, band(P, qb), [&](int kk, int pc) { return s.G() + unit(qb + kk, pc); });
      store_rows(acc, 1.0f, s.tpos(), m0, end, dv + bh_off);
    }
    // The barrier at the top of the next iteration frees this stage for tile
    // w + 2 * gridDim.x.
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 =
// launched). The caller checks shapes, types, contiguity and 16-byte
// alignment and allocates every output: dq, dk, dv like q; der_part f32
// [H, A, d, B * ceil(T / 64)]. er is [H, d, A], bf16 (er_bf16 = 1) or f32.
// `first` holds H slot-0 offsets (in strides), each in -4..0 so that every
// head's own row is a slot.
int dilated_attention_bwd_launch(const void* q, const void* k, const void* v,
                                 const void* er, const void* dout, void* dq, void* dk,
                                 void* dv, void* der_part, int B, int H, int T, int D, int A,
                                 int dilation, int head7_from6, int er_bf16, const int* first,
                                 void* stream) {
  const long long tiles = (T + kTile - 1) / kTile;
  if (D != kHeadDim || A != kAttnLen || B <= 0 || H <= 0 || H > kMaxHeads ||
      T <= 0 || dilation <= 0 || tiles * B * H > 0x7fffffffLL ||
      static_cast<long long>(T) * dilation > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  HeadOffsets offsets = {};
  for (int h = 0; h < H; ++h) {
    if (first[h] < -kHalo || first[h] > 0) return static_cast<int>(cudaErrorInvalidValue);
    offsets.first[h] = first[h];
  }
  const bool h7 = head7_from6 && H == kMaxHeads;
  const auto kernel = h7 ? dilated_attention_bwd_kernel<true> : dilated_attention_bwd_kernel<false>;
  const size_t smem = smem_bytes(h7);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  int device = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int total = static_cast<int>(tiles * B * H);
  const int grid = min(total, sms * per_sm);     // persistent: every block resident
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), er, static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), static_cast<float*>(der_part), H, T, dilation, er_bf16,
      offsets, 1.0f / sqrtf(static_cast<float>(D)), static_cast<int>(tiles), total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
