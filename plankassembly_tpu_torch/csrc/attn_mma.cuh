// Tensor-core attention tiles for Hopper: the bf16 route of the encoder's
// flash_attention (csrc/attention.cu) and of the training attention's
// forward, dQ and dK/dV kernels (csrc/flash_train.cu).
//
// Replaces, in their bf16 form: plankassembly_tpu/ops/attention.py::
// flash_attention (Pallas `_attn_kernel`) and plankassembly_tpu/ops/
// flash_train.py::fused_attention_train (`_fwd_kernel`, `_bwd_kernel`).
//
// What bounds it on an H100: operations. Each (b, h) pair does 4 (forward)
// or 10 (backward) * Lq * len * 64 flops over a few hundred KB of q/k/v,
// far above the card's ~295 flops/byte ridge, so the products belong on the
// tensor cores.
//
// Tile design: a block of 4 warps owns 64 rows (query rows, or key rows in
// dK/dV), 16 per warp. Tiles of 64 rows x 64 dims of bf16 are staged in
// shared memory with cp.async, double-buffered, in a layout whose eight
// 16-byte chunks per 128-byte row are XOR-swizzled by the row's low three
// bits, so that ldmatrix (and ldmatrix.trans, for operands read along
// their rows' other axis) is free of bank conflicts. Products run on
// mma.sync.m16n8k16 with bf16 operands and f32 accumulation. In the
// accumulator of a 16 x 8 product, lane t holds rows t/4 and t/4 + 8 and
// columns 2(t%4) and 2(t%4) + 1 (`frag_row`, `frag_col`); two neighbouring
// 16 x 8 accumulators are exactly the A operand of a product over their 16
// columns, so softmax weights never leave registers.
//
// The hi/lo split, and why: the reference takes every product in f32, and
// the port's bf16 checks rest on the kernel rounding once, at the end.
// q, k, v and do are bf16 already, so S = Q K^T and dP = dO V^T are exact
// products. The f32 weights P (and w, ds in the backward) are not: each is
// split into hi = bf16(x) and lo = bf16(x - hi), and both halves go through
// the tensor core into the same f32 accumulator. The weight then carries
// 16 significant bits, an error of about 2^-17 of x, where rounding it to
// bf16 alone (2^-9) would break the element-wise bounds. The low half costs
// half again the tensor work of a forward.
//
// Why f32 stays on the SIMT kernels: tensor cores take f32 only as TF32,
// which keeps 10 mantissa bits and would break the f32 bounds and goldens.
#pragma once

#include <math.h>

#include "common.cuh"

namespace plank {
namespace attn {

using bf16 = __nv_bfloat16;

constexpr int kDh = 64;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;  // rows of a block (16 per warp) and of a tile
constexpr float kNegInf = -1e9f;
// resident blocks per SM each kernel is compiled for (__launch_bounds__):
// register caps of 128 (forward, dQ) and 168 (dK/dV) registers a thread,
// which cost dQ 20 and dK/dV 36-52 bytes of spills (ptxas -v) and still
// run the encoder's forward and backward faster than uncapped on an H100
constexpr int kFwdBlocks = 4;
constexpr int kDqBlocks = 4;
constexpr int kDkdvBlocks = 3;

// --------------------------------------------------------------- dropout
struct Dropout {
  int enabled;
  unsigned int threshold;  // keep when hash >= threshold
  float one_minus_rate;
  int plan_block;          // the TPU plan's query block
};

__device__ __forceinline__ unsigned int cell_seed(int seed, int b, int h,
                                                  int qi) {
  return (unsigned int)seed + (unsigned int)b * 7919u +
         (unsigned int)h * 104729u + (unsigned int)qi * 1299721u;
}

// `_dropout_mask` of the TPU kernel: two xorshift-multiply rounds over
// (local row r, global column c, cell seed), all mod 2^32, given the
// three products rA = r * kHashR, cB = c * kHashC and cC = cell *
// kHashCell (each kernel hoists the ones that are fixed in its loops)
constexpr unsigned int kHashR = 0x9E3779B9u;
constexpr unsigned int kHashC = 0x85EBCA6Bu;
constexpr unsigned int kHashCell = 0xC2B2AE35u;

__device__ __forceinline__ bool keep_hash(unsigned int rA, unsigned int cB,
                                          unsigned int cC,
                                          unsigned int threshold) {
  unsigned int x = (rA ^ cB) + cC;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= threshold;
}

__device__ __forceinline__ bool keep_bit(unsigned int r, unsigned int c,
                                         unsigned int cell,
                                         unsigned int threshold) {
  return keep_hash(r * kHashR, c * kHashC, cell * kHashCell, threshold);
}

// end of the keys a query tile [row0, row0 + 64) must visit: every key
// when the row has no real key, else up to the length (and the tile's last
// row when causal); past it every weight is exactly 0
__device__ __forceinline__ int key_end(int len, int Lk, int Lq, int row0,
                                       int causal) {
  if (len <= 0) return Lk;
  int kend = min(Lk, len);
  if (causal) kend = min(kend, min(Lq, row0 + kTile));
  return kend;
}

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ unsigned int smem_u32(const void* p) {
  return static_cast<unsigned int>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned int (&r)[4],
                                        unsigned int addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned int (&r)[4],
                                              unsigned int addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16) . b (16 x 8, bf16)
__device__ __forceinline__ void mma(float (&c)[4], const unsigned int (&a)[4],
                                    unsigned int b0, unsigned int b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ----------------------------------------------------- shared-memory tiles
// 64 rows x 64 bf16, row-major, 16-byte chunk c of row r stored at chunk
// c ^ (r & 7): the eight rows one ldmatrix phase reads at one logical chunk
// fall in eight distinct groups of four banks
struct alignas(128) Tile {
  unsigned short x[kTile * kDh];  // bf16 bits
};

__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kDh + ((chunk ^ (row & 7)) << 3);
}

// rows [r0, r0 + 64) of a (L, 64) bf16 matrix; rows at or past L are zero
__device__ __forceinline__ void load_tile(Tile& t, const bf16* src, int r0,
                                          int L) {
#pragma unroll
  for (int i = 0; i < kTile * 8 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 3, c = idx & 7;
    const bool ok = r0 + r < L;
    const bf16* p = src + (long long)(ok ? r0 + r : 0) * kDh + c * 8;
    cp_async16(&t.x[swz(r, c)], p, ok ? 16 : 0);
  }
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// A operand: rows [r0, r0 + 16), dims [16 kc, 16 kc + 16) of a row-major tile
__device__ __forceinline__ void ld_a(unsigned int (&a)[4], const Tile& t,
                                     int r0, int kc) {
  const int l = lane_id();
  ldsm_x4(a, smem_u32(&t.x[swz(r0 + (l & 7) + ((l >> 3) & 1) * 8,
                                2 * kc + (l >> 4))]));
}

// B operands of two 16 x 8 products from a tile that holds B transposed
// (n-major, as K for Q K^T): n rows [n0, n0 + 16), k = dims [16 kc, +16);
// b[0], b[1] for n-tile n0, b[2], b[3] for n0 + 8
__device__ __forceinline__ void ld_b(unsigned int (&b)[4], const Tile& t,
                                     int n0, int kc) {
  const int l = lane_id();
  ldsm_x4(b, smem_u32(&t.x[swz(n0 + (l & 7) + (l >> 4) * 8,
                                2 * kc + ((l >> 3) & 1))]));
}

// B operands of two 16 x 8 products from a tile that holds B k-major (as V
// for P V): k rows [16 kk, 16 kk + 16), n = dims [16 np, 16 np + 16)
__device__ __forceinline__ void ld_b_trans(unsigned int (&b)[4],
                                           const Tile& t, int kk, int np) {
  const int l = lane_id();
  ldsm_x4_trans(b, smem_u32(&t.x[swz(16 * kk + (l & 7) + ((l >> 3) & 1) * 8,
                                      2 * np + (l >> 4))]));
}

// row within the warp's 16, and column within a 16 x 8 product, of
// accumulator element i of this lane
__device__ __forceinline__ int frag_row(int i) {
  return (lane_id() >> 2) + (i >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int i) {
  return ((lane_id() & 3) << 1) + (i & 1);
}

// ------------------------------------------------------------ products
// s (16 x 8 NT) = a (16 x 64, A fragments) . B^T, B's rows [n0, n0 + 8 NT)
// of a tile (n-major)
template <int NT>
__device__ __forceinline__ void mma_abt(float (&s)[NT][4],
                                        const unsigned int (&a)[4][4],
                                        const Tile& t, int n0) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np)
#pragma unroll
    for (int kc = 0; kc < kDh / 16; ++kc) {
      unsigned int b[4];
      ld_b(b, t, n0 + 16 * np, kc);
      mma(s[2 * np], a[kc], b[0], b[1]);
      mma(s[2 * np + 1], a[kc], b[2], b[3]);
    }
}

__device__ __forceinline__ unsigned int bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned int*>(&v);
}

// the A operand over the 16 columns of two neighbouring accumulators, as
// hi = bf16(x) and lo = bf16(x - hi)
__device__ __forceinline__ void split_a(const float (&c0)[4],
                                        const float (&c1)[4],
                                        unsigned int (&hi)[4],
                                        unsigned int (&lo)[4]) {
  const float x[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * r], x[2 * r + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[r] = bits(h);
    lo[r] = bits(__floats2bfloat162_rn(x[2 * r] - hf.x, x[2 * r + 1] - hf.y));
  }
}

// acc (16 x 64) += (hi + lo) (16 x 16) . B, B's k rows [16 kk, 16 kk + 16)
// of a k-major tile, all 64 of its columns
__device__ __forceinline__ void mma_split(float (&acc)[8][4],
                                          const unsigned int (&hi)[4],
                                          const unsigned int (&lo)[4],
                                          const Tile& t, int kk) {
#pragma unroll
  for (int np = 0; np < kDh / 16; ++np) {
    unsigned int b[4];
    ld_b_trans(b, t, kk, np);
    mma(acc[2 * np], hi, b[0], b[1]);
    mma(acc[2 * np + 1], hi, b[2], b[3]);
    mma(acc[2 * np], lo, b[0], b[1]);
    mma(acc[2 * np + 1], lo, b[2], b[3]);
  }
}

// acc += (the weights held as accumulators c[0..NT)) . B, B's k rows
// [k0, k0 + 8 NT) of a k-major tile (k0 a multiple of 16)
template <int NT>
__device__ __forceinline__ void mma_weights(float (&acc)[8][4],
                                            const float (&c)[NT][4],
                                            const Tile& t, int k0) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    unsigned int hi[4], lo[4];
    split_a(c[2 * kk], c[2 * kk + 1], hi, lo);
    mma_split(acc, hi, lo, t, k0 / 16 + kk);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------------------------------------- forward
struct FwdArgs {
  const bf16* q;   // (B, H, Lq, 64)
  const bf16* k;   // (B, Hkv, Lk, 64)
  const bf16* v;
  const int* kv_len;
  const int* seed;  // dropout only
  bf16* out;        // (B, H, Lq, 64)
  float2* stats;    // per-row (max, sum), or null
  int H, Hkv, Lq, Lk;
  int Lk_pad;  // a row with no real key averages over Lk_pad keys (v = 0
               // past Lk): Lk for flash_attention, the TPU plan's width for
               // the training forward
  float sm_scale;
  int causal;
  Dropout drop;
};

// One block of kThreads per (query tile of 64, query head h, batch row b)
// = (blockIdx.x, .y, .z). Online softmax over key tiles of 64: scores
// s_ij = (q_i . k_j) sm_scale, or -1e9 for masked keys (j >= kv_len[b], or
// j > i when causal) as in the plain version; keys past the tile's key end
// weigh exactly 0. It accumulates keep * exp(s - m) * v and the unmasked
// sum of exp(s - m) apart (dropout scales normalised weights), and writes
// o = acc / l / (1 - rate), and each row's (max, sum) where `stats` is
// given.
__device__ __forceinline__ void fwd_tile(const FwdArgs& p) {
  __shared__ Tile sq, sk[2], sv[2];

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int kvh = h / (p.H / p.Hkv);
  const long long bh = (long long)b * p.H + h;
  const bf16* kb = p.k + ((long long)b * p.Hkv + kvh) * p.Lk * kDh;
  const bf16* vb = p.v + ((long long)b * p.Hkv + kvh) * p.Lk * kDh;
  const int len = p.kv_len[b];
  const int kend = key_end(len, p.Lk, p.Lq, q0, p.causal);
  const int ntiles = (kend + kTile - 1) / kTile;

  load_tile(sq, p.q + bh * p.Lq * kDh, q0, p.Lq);
  load_tile(sk[0], kb, 0, p.Lk);
  load_tile(sv[0], vb, 0, p.Lk);
  cp_async_commit();

  // this lane's two rows, and their dropout hash terms
  int row[2];
  unsigned int rA[2] = {0u, 0u}, cC[2] = {0u, 0u};
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    row[r2] = q0 + warp * 16 + frag_row(2 * r2);
    if (p.drop.enabled) {
      const int i = min(row[r2], p.Lq - 1);
      rA[r2] = (unsigned int)(i % p.drop.plan_block) * kHashR;
      cC[r2] = cell_seed(p.seed[0], b, h, i / p.drop.plan_block) * kHashCell;
    }
  }
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  unsigned int qa[4][4];

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile(sk[(t + 1) & 1], kb, (t + 1) * kTile, p.Lk);
      load_tile(sv[(t + 1) & 1], vb, (t + 1) * kTile, p.Lk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kc = 0; kc < kDh / 16; ++kc) ld_a(qa[kc], sq, warp * 16, kc);
    }
    const int k0 = t * kTile;
    float s[8][4];
    mma_abt<8>(s, qa, sk[t & 1], 0);
    float mx[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + 8 * j + frag_col(i);
        float x = -INFINITY;
        if (key < kend)
          x = key < len && (!p.causal || key <= row[i >> 1])
                  ? s[j][i] * p.sm_scale
                  : kNegInf;
        s[j][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const float mnew = fmaxf(m[r2], quad_max(mx[r2]));
      alpha[r2] = __expf(m[r2] - mnew);
      m[r2] = mnew;
      l[r2] *= alpha[r2];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[j][i] *= alpha[i >> 1];
        const float e = __expf(s[j][i] - m[i >> 1]);
        l[i >> 1] += e;  // the softmax normaliser counts dropped weights too
        const bool keep =
            !p.drop.enabled ||
            keep_hash(rA[i >> 1],
                      (unsigned int)(k0 + 8 * j + frag_col(i)) * kHashC,
                      cC[i >> 1], p.drop.threshold);
        s[j][i] = keep ? e : 0.f;
      }
    mma_weights<8>(acc, s, sv[t & 1], 0);
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_async_wait<0>();  // nothing in flight at exit, even with no key tile

#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    l[r2] = quad_sum(l[r2]);
    // keys past Lk up to Lk_pad score -1e9 too (v = 0)
    if (p.Lk_pad > p.Lk)
      l[r2] += (float)(p.Lk_pad - p.Lk) * __expf(kNegInf - m[r2]);
  }
  const float div = p.drop.enabled ? p.drop.one_minus_rate : 1.f;
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    if (row[r2] >= p.Lq) continue;
    const long long at = (bh * p.Lq + row[r2]) * kDh;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = 8 * j + frag_col(0);
      const float o0 = acc[j][2 * r2] / l[r2] / div;
      const float o1 = acc[j][2 * r2 + 1] / l[r2] / div;
      *reinterpret_cast<__nv_bfloat162*>(p.out + at + d) =
          __floats2bfloat162_rn(o0, o1);
    }
    if (p.stats != nullptr && (lane_id() & 3) == 0)
      p.stats[bh * p.Lq + row[r2]] = make_float2(m[r2], l[r2]);
  }
}

// 16-byte alignment of every tile's rows (cp.async) and of the stores
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace attn
}  // namespace plank
