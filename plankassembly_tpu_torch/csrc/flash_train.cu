// Differentiable attention with in-kernel hashed dropout (training path):
// a forward kernel and two backward kernels.
//
// Replaces: plankassembly_tpu/ops/flash_train.py::fused_attention_train
// (Pallas `_fwd_kernel` and `_bwd_kernel` under a custom VJP), which holds
// one (batch, head)'s whole K/V in TPU VMEM per block of 512 queries and
// recomputes the softmax in the backward instead of storing anything.
//
// What it computes, per (b, query head h, query row i), with kv head
// h / (H / Hkv) read in place (grouped-query K/V is never repeated):
//   s_ij = (q_i . k_j) * sm_scale, or -1e9 where j >= kv_len[b] (or j > i
//          when causal); a = softmax_j(s) over Lk padded to a multiple of
//          128 (the TPU plan's key width: a row with no real key averages
//          over that padded width, the pad keys having v = 0);
//   w_ij = keep_ij ? a_ij / (1 - rate) : 0;  o_i = sum_j w_ij v_j.
// keep_ij is the TPU kernel's counter hash of (local row r, global column
// j, cell seed), where the TPU plan's query block (512 rows at Lq = 1199,
// 128 at Lq = 127) gives r = i % block and qi = i / block, and
// cell = seed + b*7919 + h*104729 + qi*1299721 in wrapping 32-bit
// arithmetic: the bits are JAX's, whatever this kernel's own tiling.
// Backward (as `_bwd_kernel`, which applies no mask to ds):
//   dv_j = sum_i w_ij do_i;  dw_ij = do_i . v_j;
//   da_ij = keep_ij ? dw_ij / (1 - rate) : 0;  ds_ij = a_ij (da_ij - D_i),
//   D_i = sum_j da_ij a_ij (summed, as the TPU kernel does, from the
//         same products as ds: a row with one real key gets ds = 0
//         exactly, as in the reference, where do_i . o_i would leave a
//         rounding residual that the sum over all rows carries into dk);
//   dq_i = sm_scale sum_j ds_ij k_j;  dk_j = sm_scale sum_i ds_ij q_i.
// All arithmetic is float32; o and dq are stored in q's type, dk and dv
// summed over the kv head's query-head group in float32 and stored once in
// k's type.
//
// What bounds it on an H100: arithmetic. Each (b, h) pair does 4 (forward)
// and 10 (backward) * Lq * len * 64 flops over a few hundred KB of q/k/v,
// far above the card's ~295 flops/byte ridge.
//
// Two routes, chosen by dtype alone; both have the same three kernels and
// the same plan: forward; dQ, one block per (b, h, 64 query rows), which
// first sums D over the keys, writes it, then adds up dq in a second
// pass; dK/dV, one block per (b, kv head, 64 keys), which loops
// over the group's G query heads and every query row and keeps dK and dV
// in registers: no atomics, a fixed summation order (the same result run
// after run), and the group sum of JAX's repeated K/V for free. Key tiles
// past kv_len[b], and (causal) rows before a key tile or keys past a query
// tile, are skipped when the row has a real key: their weights are exactly
// 0 there. A row with kv_len[b] == 0 is computed over every key, as the
// TPU kernel does.
// - bf16 (the training path): tensor cores, on the tile routines of
//   attn_mma.cuh. The forward is `fwd_tile`, shared with flash_attention.
//   dQ recomputes S = Q K^T and dP = dO V^T on mma.sync (exact products of
//   bf16 operands) per 64-key tile and forms a = exp(s - m) / l and the
//   keep bits on the accumulator fragments, in two passes over the keys:
//   the first sums D, the second adds ds K as the two bf16 halves (hi,
//   lo) of ds = a (da - D). dK/dV holds its 64 keys' K and V
//   as operand fragments, stages the query head's q, do and per-row
//   (max, 1/sum, D) 64 rows at a time, computes S^T = K Q^T and
//   dP^T = V dO^T, and adds w^T dO and ds^T Q, each weight split hi/lo:
//   16 significant bits per weight, so every product is f32-accurate as in
//   the reference (see attn_mma.cuh). The keep bit of each accumulator
//   element comes from its (row, column) under the m16n8k16 layout
//   (`frag_row`, `frag_col`) and the TPU plan's cell of that global row.
// - f32: SIMT, because tensor cores take f32 only as TF32 (10 mantissa
//   bits), which would break the f32 bounds and the f32 step golden. Every
//   row (a query row, or a key row in dK/dV) is owned by a PAIR of
//   threads, each holding half of the row's 64 dimensions (alternate
//   float4 chunks, so the pair reads neighbouring shared-memory banks) and
//   finishing each dot product with one shuffle. The forward stages K/V
//   tiles of 64 keys as f32 and runs the online softmax in chunks of 16
//   keys; dK/dV stages query tiles of 32.
#include <initializer_list>

#include "attn_mma.cuh"

namespace plank {
namespace ftrain {

constexpr int kDh = 64;
constexpr int kChunks = kDh / 4;   // float4 chunks per row
constexpr int kOwn = kChunks / 2;  // chunks each thread of a pair owns
constexpr int kRows = 64;          // rows per block, two threads each
constexpr int kThreads = 2 * kRows;
constexpr int kKTile = 64;         // keys staged per tile (forward, dQ)
constexpr int kQTile = 32;         // query rows staged per tile (dK/dV)
constexpr int kChunk = 16;         // keys per online-softmax update
constexpr float kNegInf = attn::kNegInf;
static_assert(kRows == attn::kTile, "key_end assumes 64-row tiles");

using attn::cell_seed;
using attn::Dropout;
using attn::keep_bit;
using attn::key_end;

// chunk index of a thread's i-th owned float4
__device__ __forceinline__ int own_chunk(int i, int half) {
  return 2 * i + half;
}

template <typename T>
__device__ __forceinline__ void load_own(const T* row, int half, float4* x) {
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const T* p = row + 4 * own_chunk(i, half);
    x[i] = make_float4(Elem<T>::load(p[0]), Elem<T>::load(p[1]),
                       Elem<T>::load(p[2]), Elem<T>::load(p[3]));
  }
}

template <typename T>
__device__ __forceinline__ void store_own(T* row, int half, const float4* x,
                                          float scale) {
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    T* p = row + 4 * own_chunk(i, half);
    p[0] = Elem<T>::store(x[i].x * scale);
    p[1] = Elem<T>::store(x[i].y * scale);
    p[2] = Elem<T>::store(x[i].z * scale);
    p[3] = Elem<T>::store(x[i].w * scale);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// full 64-wide dot product of a pair's row halves with a staged row; every
// lane of the warp must call it
__device__ __forceinline__ float pair_dot(const float4* x, const float4* row,
                                          int half) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kOwn; ++i) s += dot4(x[i], row[own_chunk(i, half)]);
  return s + __shfl_xor_sync(0xffffffffu, s, 1);
}

__device__ __forceinline__ void axpy_own(float4* acc, float a,
                                         const float4* row, int half) {
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const float4 r = row[own_chunk(i, half)];
    acc[i].x += a * r.x;
    acc[i].y += a * r.y;
    acc[i].z += a * r.z;
    acc[i].w += a * r.w;
  }
}

// stage rows [r0, r0 + n) of a (L, 64) matrix into shared memory as f32;
// rows at or past L are zero
template <typename T>
__device__ __forceinline__ void stage(float4 (*dst)[kChunks], const T* src,
                                      int r0, int n, int L) {
  for (int idx = threadIdx.x; idx < n * kDh; idx += blockDim.x) {
    const int j = idx / kDh, d = idx % kDh;
    reinterpret_cast<float*>(dst[j])[d] =
        r0 + j < L ? Elem<T>::load(src[(long long)(r0 + j) * kDh + d]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ kv_len,
               const int* __restrict__ seed_ptr, T* __restrict__ out,
               float2* __restrict__ stats, int H,
               int Hkv, int Lq, int Lk, int Lk_pad, float sm_scale, int causal,
               Dropout drop) {
  __shared__ float4 ks[kKTile][kChunks];
  __shared__ float4 vs[kKTile][kChunks];

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int half = threadIdx.x & 1;
  const int row = tile * kRows + (threadIdx.x >> 1);
  const bool active = row < Lq;
  const int srow = active ? row : Lq - 1;  // inactive pairs shadow a row

  const long long bh = (long long)b * H + h;
  const T* kb = k + ((long long)b * Hkv + kvh) * Lk * kDh;
  const T* vb = v + ((long long)b * Hkv + kvh) * Lk * kDh;

  float4 qr[kOwn], acc[kOwn];
  load_own(q + (bh * Lq + srow) * kDh, half, qr);
#pragma unroll
  for (int i = 0; i < kOwn; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = -1e30f, l = 0.f;

  const unsigned int r = (unsigned int)(srow % drop.plan_block);
  const unsigned int cell =
      cell_seed(seed_ptr[0], b, h, srow / drop.plan_block);
  const int len = kv_len[b];
  const int kend = key_end(len, Lk, Lq, tile * kRows, causal);

  for (int k0 = 0; k0 < kend; k0 += kKTile) {
    __syncthreads();  // previous tile fully consumed
    stage(ks, kb, k0, kKTile, Lk);
    stage(vs, vb, k0, kKTile, Lk);
    __syncthreads();
    const int nk = min(kKTile, kend - k0);
    for (int c0 = 0; c0 < nk; c0 += kChunk) {
      float s[kChunk];
      float cmax = -1e30f;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = c0 + jj;
        float dot = kNegInf;
        if (j < nk) {  // uniform over the block
          dot = pair_dot(qr, ks[j], half);
          const int key = k0 + j;
          const bool valid = key < len && (!causal || key <= srow);
          dot = valid ? dot * sm_scale : kNegInf;
          cmax = fmaxf(cmax, dot);
        }
        s[jj] = dot;
      }
      const float mnew = fmaxf(m, cmax);
      const float alpha = expf(m - mnew);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < kOwn; ++i) {
        acc[i].x *= alpha;
        acc[i].y *= alpha;
        acc[i].z *= alpha;
        acc[i].w *= alpha;
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = c0 + jj;
        if (j < nk) {
          const float p = expf(s[jj] - mnew);
          l += p;  // the softmax normaliser counts dropped weights too
          const bool keep =
              !drop.enabled ||
              keep_bit(r, (unsigned int)(k0 + j), cell, drop.threshold);
          if (keep) axpy_own(acc, p, vs[j], half);
        }
      }
      m = mnew;
    }
  }
  // keys past Lk up to the TPU plan's padded width score -1e9 too (v = 0)
  if (Lk_pad > Lk) l += (float)(Lk_pad - Lk) * expf(kNegInf - m);
  if (!active) return;
  // o = (sum keep p v) / l / (1 - rate), rounded once
  const float div = drop.enabled ? drop.one_minus_rate : 1.f;
  float4 o[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i)
    o[i] = make_float4(acc[i].x / l / div, acc[i].y / l / div,
                       acc[i].z / l / div, acc[i].w / l / div);
  store_own(out + (bh * Lq + row) * kDh, half, o, 1.f);
  if (half == 0) stats[bh * Lq + row] = make_float2(m, l);
}

// dQ, and D for the dK/dV kernel, in two passes over the keys: the first
// sums D_i = sum_j a_ij da_ij as the TPU kernel does (from the same dot
// products as ds, so a row with one real key gets ds = 0 exactly), the
// second adds ds k
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const int* __restrict__ kv_len,
              const int* __restrict__ seed_ptr,
              const float2* __restrict__ stats, float* __restrict__ dbuf,
              T* __restrict__ dq, int H, int Hkv, int Lq, int Lk,
              float sm_scale, int causal, Dropout drop) {
  __shared__ float4 ks[kKTile][kChunks];
  __shared__ float4 vs[kKTile][kChunks];

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int half = threadIdx.x & 1;
  const int row = tile * kRows + (threadIdx.x >> 1);
  const bool active = row < Lq;
  const int srow = active ? row : Lq - 1;

  const long long bh = (long long)b * H + h;
  const long long at = bh * Lq + srow;
  const T* kb = k + ((long long)b * Hkv + kvh) * Lk * kDh;
  const T* vb = v + ((long long)b * Hkv + kvh) * Lk * kDh;

  float4 qr[kOwn], dor[kOwn], acc[kOwn];
  load_own(q + at * kDh, half, qr);
  load_own(dout + at * kDh, half, dor);
#pragma unroll
  for (int i = 0; i < kOwn; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float2 ml = stats[at];

  const unsigned int r = (unsigned int)(srow % drop.plan_block);
  const unsigned int cell =
      cell_seed(seed_ptr[0], b, h, srow / drop.plan_block);
  const int len = kv_len[b];
  const int kend = key_end(len, Lk, Lq, tile * kRows, causal);

  float D = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < kend; k0 += kKTile) {
      __syncthreads();
      stage(ks, kb, k0, kKTile, Lk);
      stage(vs, vb, k0, kKTile, Lk);
      __syncthreads();
      const int nk = min(kKTile, kend - k0);
      for (int j = 0; j < nk; ++j) {
        const int key = k0 + j;
        float s = pair_dot(qr, ks[j], half);
        const float dw = pair_dot(dor, vs[j], half);
        const bool valid = key < len && (!causal || key <= srow);
        s = valid ? s * sm_scale : kNegInf;
        const float a = expf(s - ml.x) / ml.y;
        float da = dw;
        if (drop.enabled)
          da = keep_bit(r, (unsigned int)key, cell, drop.threshold)
                   ? dw / drop.one_minus_rate
                   : 0.f;
        if (pass == 0)
          D += a * da;
        else
          axpy_own(acc, a * (da - D), ks[j], half);
      }
    }
    if (pass == 0 && active && half == 0) dbuf[at] = D;
  }
  if (active) store_own(dq + at * kDh, half, acc, sm_scale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const int* __restrict__ kv_len,
                const int* __restrict__ seed_ptr,
                const float2* __restrict__ stats,
                const float* __restrict__ dbuf, T* __restrict__ dk,
                T* __restrict__ dv, int H, int Hkv, int Lq, int Lk,
                float sm_scale, int causal, Dropout drop) {
  __shared__ float4 qs[kQTile][kChunks];
  __shared__ float4 dos[kQTile][kChunks];
  __shared__ float2 mls[kQTile];
  __shared__ float ds_[kQTile];

  const int tile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int half = threadIdx.x & 1;
  const int key = tile * kRows + (threadIdx.x >> 1);
  const bool active = key < Lk;
  const int skey = active ? key : Lk - 1;
  const long long kvrow = ((long long)b * Hkv + kvh) * Lk + skey;

  float4 dka[kOwn], dva[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    dka[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    dva[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int len = kv_len[b];
  // with a real key in every row, keys past the length get weight 0 from
  // every row, and (causal) rows before this tile see none of its keys
  const bool skip_all = len > 0 && tile * kRows >= min(Lk, len);
  if (!skip_all) {
    float4 kr[kOwn], vr[kOwn];
    load_own(k + kvrow * kDh, half, kr);
    load_own(v + kvrow * kDh, half, vr);
    const int i_begin = (len > 0 && causal) ? min(Lq, tile * kRows) : 0;
    const int seed = seed_ptr[0];
    for (int g = 0; g < G; ++g) {
      const int h = kvh * G + g;
      const long long bh = (long long)b * H + h;
      for (int i0 = i_begin; i0 < Lq; i0 += kQTile) {
        const int nq = min(kQTile, Lq - i0);
        __syncthreads();
        stage(qs, q + bh * Lq * kDh, i0, kQTile, Lq);
        stage(dos, dout + bh * Lq * kDh, i0, kQTile, Lq);
        for (int t = threadIdx.x; t < nq; t += blockDim.x) {
          mls[t] = stats[bh * Lq + i0 + t];
          ds_[t] = dbuf[bh * Lq + i0 + t];
        }
        __syncthreads();
        for (int ii = 0; ii < nq; ++ii) {
          const int i = i0 + ii;
          float s = pair_dot(kr, qs[ii], half);
          const float dw = pair_dot(vr, dos[ii], half);
          const bool valid = skey < len && (!causal || skey <= i);
          s = valid ? s * sm_scale : kNegInf;
          const float2 ml = mls[ii];
          const float a = expf(s - ml.x) / ml.y;
          float w = a, da = dw;
          if (drop.enabled) {
            const bool keep = keep_bit(
                (unsigned int)(i % drop.plan_block), (unsigned int)skey,
                cell_seed(seed, b, h, i / drop.plan_block), drop.threshold);
            w = keep ? a / drop.one_minus_rate : 0.f;
            da = keep ? dw / drop.one_minus_rate : 0.f;
          }
          axpy_own(dva, w, dos[ii], half);
          axpy_own(dka, a * (da - ds_[ii]), qs[ii], half);
        }
      }
    }
  }
  if (!active) return;
  store_own(dk + kvrow * kDh, half, dka, sm_scale);
  store_own(dv + kvrow * kDh, half, dva, 1.f);
}

// ---------------------------------------------------------- bf16 route
using attn::bf16;

__global__ void __launch_bounds__(attn::kThreads, attn::kFwdBlocks)
    train_fwd_mma_kernel(attn::FwdArgs p) {
  attn::fwd_tile(p);
}

struct BwdArgs {
  const bf16* q;     // (B, H, Lq, 64)
  const bf16* k;     // (B, Hkv, Lk, 64)
  const bf16* v;
  const bf16* dout;  // (B, H, Lq, 64)
  const int* kv_len;
  const int* seed;
  const float2* stats;  // the forward's per-row (max, sum)
  float* dbuf;          // (B, H, Lq): D, written by dQ, read by dK/dV
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int H, Hkv, Lq, Lk;
  float sm_scale;
  int causal;
  Dropout drop;
};

// dQ and D: one block per (query tile of 64, query head, batch row). Two
// passes over the row block's key tiles: the first sums
// D_i = sum_j a_ij da_ij, as the TPU kernel forms it, from the same
// tensor-core products as ds (so a row whose softmax is one key gets
// ds = da - D = 0 exactly, as in the reference); the second adds ds K.
__global__ void __launch_bounds__(attn::kThreads, attn::kDqBlocks)
    train_dq_mma_kernel(BwdArgs p) {
  using namespace attn;
  __shared__ Tile sk[2], sv[2];

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int kvh = h / (p.H / p.Hkv);
  const long long bh = (long long)b * p.H + h;
  const bf16* kb = p.k + ((long long)b * p.Hkv + kvh) * p.Lk * kDh;
  const bf16* vb = p.v + ((long long)b * p.Hkv + kvh) * p.Lk * kDh;
  const int len = p.kv_len[b];
  const int kend = key_end(len, p.Lk, p.Lq, q0, p.causal);
  const int ntiles = (kend + kTile - 1) / kTile;

  // q and do go through the second stage's buffers
  load_tile(sk[1], p.q + bh * p.Lq * kDh, q0, p.Lq);
  load_tile(sv[1], p.dout + bh * p.Lq * kDh, q0, p.Lq);
  load_tile(sk[0], kb, 0, p.Lk);
  load_tile(sv[0], vb, 0, p.Lk);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  unsigned int qa[4][4], da[4][4];
#pragma unroll
  for (int kc = 0; kc < kDh / 16; ++kc) {
    ld_a(qa[kc], sk[1], warp * 16, kc);
    ld_a(da[kc], sv[1], warp * 16, kc);
  }
  int row[2];
  float D[2] = {0.f, 0.f}, m[2], inv_l[2];
  unsigned int rA[2] = {0u, 0u}, cC[2] = {0u, 0u};
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    row[r2] = q0 + warp * 16 + frag_row(2 * r2);
    const int i = min(row[r2], p.Lq - 1);
    const float2 ml = p.stats[bh * p.Lq + i];
    m[r2] = ml.x;
    inv_l[r2] = 1.f / ml.y;
    if (p.drop.enabled) {
      rA[r2] = (unsigned int)(i % p.drop.plan_block) * kHashR;
      cC[r2] = cell_seed(p.seed[0], b, h, i / p.drop.plan_block) * kHashCell;
    }
  }
  __syncthreads();  // the second stage is refilled below
  // a product, not a division, per element
  const float inv_keep = 1.f / p.drop.one_minus_rate;
  float dq[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[j][i] = 0.f;

  // step u visits key tile u % ntiles in pass u / ntiles
  for (int u = 0; u < 2 * ntiles; ++u) {
    const int t = u % ntiles, pass = u / ntiles;
    if (u + 1 < 2 * ntiles) {
      const int tn = (u + 1) % ntiles;
      load_tile(sk[(u + 1) & 1], kb, tn * kTile, p.Lk);
      load_tile(sv[(u + 1) & 1], vb, tn * kTile, p.Lk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (u == ntiles) {  // D complete
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        D[r2] = quad_sum(D[r2]);
        if ((lane_id() & 3) == 0 && row[r2] < p.Lq)
          p.dbuf[bh * p.Lq + row[r2]] = D[r2];
      }
    }
    const Tile& K = sk[u & 1];
#pragma unroll
    for (int c0 = 0; c0 < kTile; c0 += 32) {  // 32 keys at a time
      float s[4][4], dp[4][4];
      mma_abt<4>(s, qa, K, c0);
      mma_abt<4>(dp, da, sv[u & 1], c0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = t * kTile + c0 + 8 * j + frag_col(i);
          const int r2 = i >> 1;
          float a = 0.f, dw = 0.f;
          if (key < kend) {
            const float x = key < len && (!p.causal || key <= row[r2])
                                ? s[j][i] * p.sm_scale
                                : kNegInf;
            a = __expf(x - m[r2]) * inv_l[r2];
            dw = dp[j][i];
            if (p.drop.enabled)
              dw = keep_hash(rA[r2], (unsigned int)key * kHashC, cC[r2],
                             p.drop.threshold)
                       ? dw * inv_keep
                       : 0.f;
          }
          if (pass == 0)
            D[r2] += a * dw;
          else
            s[j][i] = a * (dw - D[r2]);  // ds
        }
      if (pass == 1) mma_weights<4>(dq, s, K, c0);  // dq += ds K
    }
    __syncthreads();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    if (row[r2] >= p.Lq) continue;
    bf16* out = p.dq + (bh * p.Lq + row[r2]) * kDh;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + frag_col(0)) =
          __floats2bfloat162_rn(dq[j][2 * r2] * p.sm_scale,
                                dq[j][2 * r2 + 1] * p.sm_scale);
  }
}

// dK and dV: one block per (key tile of 64, kv head, batch row); it walks
// (query head of the group, query tile of 64) in order
__global__ void __launch_bounds__(attn::kThreads, attn::kDkdvBlocks)
    train_dkdv_mma_kernel(BwdArgs p) {
  using namespace attn;
  __shared__ Tile sq[2], sdo[2];
  __shared__ float sm[2][kTile], sil[2][kTile], sD[2][kTile];

  const int key0 = blockIdx.x * kTile, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int G = p.H / p.Hkv;
  const long long kvoff = ((long long)b * p.Hkv + kvh) * p.Lk * kDh;
  const int len = p.kv_len[b];
  int key[2];
  unsigned int kB[2];  // the hash's column products
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    key[r2] = key0 + warp * 16 + frag_row(2 * r2);
    kB[r2] = (unsigned int)key[r2] * kHashC;
  }
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[j][i] = dv[j][i] = 0.f;

  // with a real key in every row, keys past the length get weight 0 from
  // every row
  if (!(len > 0 && key0 >= min(p.Lk, len))) {
    load_tile(sq[0], p.k + kvoff, key0, p.Lk);
    load_tile(sdo[0], p.v + kvoff, key0, p.Lk);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    unsigned int ka[4][4], va[4][4];
#pragma unroll
    for (int kc = 0; kc < kDh / 16; ++kc) {
      ld_a(ka[kc], sq[0], warp * 16, kc);
      ld_a(va[kc], sdo[0], warp * 16, kc);
    }
    __syncthreads();
    // (causal) rows before this tile see none of its keys
    const int i_begin = (len > 0 && p.causal) ? min(p.Lq, key0) : 0;
    const int nq = (p.Lq - i_begin + kTile - 1) / kTile;
    const int items = G * nq;
    const float inv_keep = 1.f / p.drop.one_minus_rate;
    // q, do and the per-row (max, 1/sum, D) of item `it` into stage st;
    // rows past Lq get weight 0
    auto stage = [&](int it, int st) {
      const int i0 = i_begin + (it % nq) * kTile;
      const long long bh = (long long)b * p.H + kvh * G + it / nq;
      load_tile(sq[st], p.q + bh * p.Lq * kDh, i0, p.Lq);
      load_tile(sdo[st], p.dout + bh * p.Lq * kDh, i0, p.Lq);
      if (threadIdx.x < kTile) {
        const int i = i0 + threadIdx.x;
        const bool ok = i < p.Lq;
        const float2 ml = ok ? p.stats[bh * p.Lq + i] : make_float2(0.f, 1.f);
        sm[st][threadIdx.x] = ml.x;
        sil[st][threadIdx.x] = ok ? 1.f / ml.y : 0.f;
        sD[st][threadIdx.x] = ok ? p.dbuf[bh * p.Lq + i] : 0.f;
      }
    };
    if (items > 0) stage(0, 0);
    cp_async_commit();
    for (int t = 0; t < items; ++t) {
      if (t + 1 < items) stage(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const int st = t & 1;
      const int h = kvh * G + t / nq, i0 = i_begin + (t % nq) * kTile;
      // the tile's 64 rows lie in one cell of the TPU plan (its query
      // block is a multiple of 64): local row r0 + c, one cell seed
      const int r0 = p.drop.enabled ? i0 % p.drop.plan_block : 0;
      const unsigned int cC =
          p.drop.enabled
              ? cell_seed(p.seed[0], b, h, i0 / p.drop.plan_block) * kHashCell
              : 0u;
#pragma unroll
      for (int c0 = 0; c0 < kTile; c0 += 32) {  // 32 query rows at a time
        float s[4][4], dp[4][4];
        mma_abt<4>(s, ka, sq[st], c0);   // S^T = K Q^T
        mma_abt<4>(dp, va, sdo[st], c0);  // dP^T = V dO^T
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = c0 + 8 * j + frag_col(i), qi = i0 + c;
            const int kj = key[i >> 1];
            const float x = kj < len && (!p.causal || kj <= qi)
                                ? s[j][i] * p.sm_scale
                                : kNegInf;
            const float a = __expf(x - sm[st][c]) * sil[st][c];
            float w = a, dw = dp[j][i];
            if (p.drop.enabled) {
              const bool keep = keep_hash((unsigned int)(r0 + c) * kHashR,
                                          kB[i >> 1], cC, p.drop.threshold);
              w = keep ? a * inv_keep : 0.f;
              dw = keep ? dw * inv_keep : 0.f;
            }
            s[j][i] = w;
            dp[j][i] = a * (dw - sD[st][c]);
          }
        mma_weights<4>(dv, s, sdo[st], c0);  // dv += w^T do
        mma_weights<4>(dk, dp, sq[st], c0);  // dk += ds^T q
      }
      __syncthreads();
    }
    cp_async_wait<0>();
  }
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    if (key[r2] >= p.Lk) continue;
    const long long at = kvoff + (long long)key[r2] * kDh;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = 8 * j + frag_col(0);
      *reinterpret_cast<__nv_bfloat162*>(p.dk + at + d) =
          __floats2bfloat162_rn(dk[j][2 * r2] * p.sm_scale,
                                dk[j][2 * r2 + 1] * p.sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + at + d) =
          __floats2bfloat162_rn(dv[j][2 * r2], dv[j][2 * r2 + 1]);
    }
  }
}

inline dim3 grid_of(long long rows, long long heads, long long B) {
  return dim3((unsigned)((rows + kRows - 1) / kRows), (unsigned)heads,
              (unsigned)B);
}

}  // namespace ftrain
}  // namespace plank

using plank::ftrain::Dropout;

static Dropout make_dropout(int enabled, unsigned int threshold,
                            float one_minus_rate, long long plan_block) {
  Dropout d;
  d.enabled = enabled;
  d.threshold = threshold;
  d.one_minus_rate = one_minus_rate;
  d.plan_block = (int)plan_block;
  return d;
}

static bool all_aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (!plank::attn::aligned16(p)) return false;
  return true;
}

extern "C" int plank_flash_train_fwd(
    const void* q, const void* k, const void* v, const void* kv_len,
    const void* seed, void* out, void* stats, long long B,
    long long H, long long Hkv, long long Lq, long long Lk, long long Dh,
    long long Lk_pad, float sm_scale, int causal, int dropout,
    unsigned int threshold, float one_minus_rate, long long plan_block,
    int is_bf16, void* stream) {
  using namespace plank::ftrain;
  if (Dh != kDh || Hkv <= 0 || H % Hkv != 0 || plan_block <= 0)
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Lq == 0 || Lk == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout d = make_dropout(dropout, threshold, one_minus_rate, plan_block);
  const int* lens = static_cast<const int*>(kv_len);
  const int* sd = static_cast<const int*>(seed);
  if (is_bf16) {  // tensor cores
    if (!all_aligned16({q, k, v, out, stats}))
      return cudaErrorMisalignedAddress;
    plank::attn::FwdArgs p{};
    p.q = static_cast<const bf16*>(q);
    p.k = static_cast<const bf16*>(k);
    p.v = static_cast<const bf16*>(v);
    p.kv_len = lens;
    p.seed = sd;
    p.out = static_cast<bf16*>(out);
    p.stats = static_cast<float2*>(stats);
    p.H = (int)H;
    p.Hkv = (int)Hkv;
    p.Lq = (int)Lq;
    p.Lk = (int)Lk;
    p.Lk_pad = (int)Lk_pad;
    p.sm_scale = sm_scale;
    p.causal = causal;
    p.drop = d;
    train_fwd_mma_kernel<<<grid_of(Lq, H, B), plank::attn::kThreads, 0, s>>>(
        p);
  } else {  // SIMT
    fwd_kernel<float><<<grid_of(Lq, H, B), kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), lens, sd, static_cast<float*>(out),
        static_cast<float2*>(stats), (int)H,
        (int)Hkv, (int)Lq, (int)Lk, (int)Lk_pad, sm_scale, causal, d);
  }
  return (int)cudaGetLastError();
}

// dq (then dk and dv); `dbuf` is (B, H, Lq) float32 scratch for D
extern "C" int plank_flash_train_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* kv_len, const void* seed, const void* stats,
    void* dbuf, void* dq, void* dk, void* dv, long long B, long long H,
    long long Hkv, long long Lq, long long Lk, long long Dh, float sm_scale,
    int causal, int dropout, unsigned int threshold, float one_minus_rate,
    long long plan_block, int is_bf16, void* stream) {
  using namespace plank::ftrain;
  if (Dh != kDh || Hkv <= 0 || H % Hkv != 0 || plan_block <= 0)
    return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Lq == 0 || Lk == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout d = make_dropout(dropout, threshold, one_minus_rate, plan_block);
  const int* lens = static_cast<const int*>(kv_len);
  const int* sd = static_cast<const int*>(seed);
  const float2* st = static_cast<const float2*>(stats);
  float* D = static_cast<float*>(dbuf);
  if (is_bf16) {  // tensor cores
    if (plan_block % plank::attn::kTile != 0) return cudaErrorInvalidValue;
    if (!all_aligned16({q, k, v, dout, dq, dk, dv}))
      return cudaErrorMisalignedAddress;
    BwdArgs p{};
    p.q = static_cast<const bf16*>(q);
    p.k = static_cast<const bf16*>(k);
    p.v = static_cast<const bf16*>(v);
    p.dout = static_cast<const bf16*>(dout);
    p.kv_len = lens;
    p.seed = sd;
    p.stats = st;
    p.dbuf = D;
    p.dq = static_cast<bf16*>(dq);
    p.dk = static_cast<bf16*>(dk);
    p.dv = static_cast<bf16*>(dv);
    p.H = (int)H;
    p.Hkv = (int)Hkv;
    p.Lq = (int)Lq;
    p.Lk = (int)Lk;
    p.sm_scale = sm_scale;
    p.causal = causal;
    p.drop = d;
    train_dq_mma_kernel<<<grid_of(Lq, H, B), plank::attn::kThreads, 0, s>>>(
        p);
    train_dkdv_mma_kernel<<<grid_of(Lk, Hkv, B), plank::attn::kThreads, 0,
                            s>>>(p);
  } else {  // SIMT
    using T = float;
    dq_kernel<T><<<grid_of(Lq, H, B), kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lens, sd,
        st, D, static_cast<T*>(dq), (int)H, (int)Hkv, (int)Lq, (int)Lk,
        sm_scale, causal, d);
    dkdv_kernel<T><<<grid_of(Lk, Hkv, B), kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lens, sd, st,
        D, static_cast<T*>(dk), static_cast<T*>(dv), (int)H, (int)Hkv,
        (int)Lq, (int)Lk, sm_scale, causal, d);
  }
  return (int)cudaGetLastError();
}
