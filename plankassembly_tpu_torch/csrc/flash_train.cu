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
//   D_i = sum_j da_ij a_ij = do_i . o_i (o in float32, since o = W V);
//   dq_i = sm_scale sum_j ds_ij k_j;  dk_j = sm_scale sum_i ds_ij q_i.
// All arithmetic is float32; o and dq are stored in q's type, dk and dv
// summed over the kv head's query-head group in float32 and stored once in
// k's type.
//
// What bounds it on an H100: arithmetic. Each (b, h) pair does 4 (forward)
// and 10 (backward) * Lq * len * 64 flops over a few hundred KB of q/k/v,
// far above the card's ~295 flops/byte ridge.
//
// Design (the simple SIMT version; tensor cores are later work): every row
// (a query row, or a key row in the dK/dV kernel) is owned by a PAIR of
// threads, each holding half of the row's 64 dimensions (alternate float4
// chunks, so the pair reads neighbouring shared-memory banks) and finishing
// each dot product with one shuffle. That keeps four 64-wide f32 rows in
// registers in the dK/dV kernel.
// - forward: one block per (b, h, 64 query rows); K/V tiles of 64 keys
//   staged in shared memory as f32; online softmax in chunks of 16 keys
//   that accumulates keep * exp(s - m) * v and the UNMASKED sum of
//   exp(s - m) apart, since dropout scales normalised weights. It stores
//   o, a float32 copy of o (bf16 only) and each row's (max, sum) for the
//   backward.
// - dQ: one block per (b, h, 64 query rows): D_i from do and the f32 o,
//   then one pass over the keys. It also writes D for the next kernel.
// - dK/dV: one block per (b, kv head, 64 keys). It loops over the group's
//   G query heads and over every query row (tiles of 32 staged in shared
//   memory) and keeps dK and dV in registers: no atomics, a fixed
//   summation order, and the group sum of JAX's repeated K/V for free.
// Key tiles past kv_len[b], and (causal) rows before a key tile or keys
// past a query tile, are skipped when the row has a real key: their
// weights are exactly 0 there. A row with kv_len[b] == 0 is computed over
// every key, as the TPU kernel does.
#include "common.cuh"

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
constexpr float kNegInf = -1e9f;

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
// (local row, global column, cell seed), all mod 2^32.
__device__ __forceinline__ bool keep_bit(unsigned int r, unsigned int c,
                                         unsigned int cell,
                                         unsigned int threshold) {
  unsigned int x = r * 0x9E3779B9u;
  x ^= c * 0x85EBCA6Bu;
  x += cell * 0xC2B2AE35u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= threshold;
}

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

// end of the keys a query tile [row0, row0 + kRows) must visit: every key
// when the row has no real key, else up to the length (and the tile's last
// row when causal)
__device__ __forceinline__ int key_end(int len, int Lk, int Lq, int row0,
                                       int causal) {
  if (len <= 0) return Lk;
  int kend = min(Lk, len);
  if (causal) kend = min(kend, min(Lq, row0 + kRows));
  return kend;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ kv_len,
               const int* __restrict__ seed_ptr, T* __restrict__ out,
               float* __restrict__ out32, float2* __restrict__ stats, int H,
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
  if (out32 != nullptr) store_own(out32 + (bh * Lq + row) * kDh, half, o, 1.f);
  if (half == 0) stats[bh * Lq + row] = make_float2(m, l);
}

// dQ, and D_i = do_i . o_i for the dK/dV kernel
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ o32, const int* __restrict__ kv_len,
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
  load_own(o32 + at * kDh, half, acc);  // o, only to form D
  float D = 0.f;
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    D += dot4(dor[i], acc[i]);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  D += __shfl_xor_sync(0xffffffffu, D, 1);
  if (active && half == 0) dbuf[at] = D;
  const float2 ml = stats[at];

  const unsigned int r = (unsigned int)(srow % drop.plan_block);
  const unsigned int cell =
      cell_seed(seed_ptr[0], b, h, srow / drop.plan_block);
  const int len = kv_len[b];
  const int kend = key_end(len, Lk, Lq, tile * kRows, causal);

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
      axpy_own(acc, a * (da - D), ks[j], half);
    }
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

extern "C" int plank_flash_train_fwd(
    const void* q, const void* k, const void* v, const void* kv_len,
    const void* seed, void* out, void* out32, void* stats, long long B,
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
  const dim3 grid = grid_of(Lq, H, B);
  const int* lens = static_cast<const int*>(kv_len);
  const int* sd = static_cast<const int*>(seed);
  if (is_bf16) {
    using T = __nv_bfloat16;
    fwd_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), lens, sd, static_cast<T*>(out),
        static_cast<float*>(out32), static_cast<float2*>(stats), (int)H,
        (int)Hkv, (int)Lq, (int)Lk, (int)Lk_pad, sm_scale, causal, d);
  } else {
    fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), lens, sd, static_cast<float*>(out),
        static_cast<float*>(out32), static_cast<float2*>(stats), (int)H,
        (int)Hkv, (int)Lq, (int)Lk, (int)Lk_pad, sm_scale, causal, d);
  }
  return (int)cudaGetLastError();
}

// dq (then dk and dv); `dbuf` is (B, H, Lq) float32 scratch for D
extern "C" int plank_flash_train_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* o32, const void* kv_len, const void* seed, const void* stats,
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
  const float* o = static_cast<const float*>(o32);
  if (is_bf16) {
    using T = __nv_bfloat16;
    dq_kernel<T><<<grid_of(Lq, H, B), kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), o, lens, sd,
        st, D, static_cast<T*>(dq), (int)H, (int)Hkv, (int)Lq, (int)Lk,
        sm_scale, causal, d);
    dkdv_kernel<T><<<grid_of(Lk, Hkv, B), kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lens, sd, st,
        D, static_cast<T*>(dk), static_cast<T*>(dv), (int)H, (int)Hkv,
        (int)Lq, (int)Lk, sm_scale, causal, d);
  } else {
    using T = float;
    dq_kernel<T><<<grid_of(Lq, H, B), kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), o, lens, sd,
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
