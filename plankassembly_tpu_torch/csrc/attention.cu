// Fused softmax attention for the encoder.
//
// Replaces: plankassembly_tpu/ops/attention.py::flash_attention (Pallas
// kernel `_attn_kernel`), which holds one (batch, head)'s whole K/V in
// TPU VMEM and takes one exact softmax per 128-query block.
//
// What bounds it on an H100: arithmetic. At the encoder's shapes (Lq = Lk
// up to 1280, Dh = 64) each (b, h) does 4 * Lq * len * 64 flops over only
// 3 * L * 64 * 2 bytes of q/k/v, far above the card's ~295 flops/byte
// ridge, so the kernel is bound by how fast it multiplies, not by memory.
//
// Two routes, chosen by dtype alone:
// - bf16 (the serving path): `flash_mma_kernel`, the tensor-core tile
//   routine of attn_mma.cuh (`fwd_tile`): 4 warps per 64 query rows,
//   K/V tiles of 64 keys staged with cp.async into swizzled shared memory,
//   S = Q K^T on mma.sync (exact: q and k are bf16), the online softmax on
//   the accumulator fragments, and P V as two bf16 products, P's high and
//   low halves, into one f32 accumulator, so that P keeps 16 significant
//   bits where bf16 alone would keep 8 (see attn_mma.cuh).
// - f32: the SIMT kernel below, because tensor cores take f32 only as
//   TF32 (10 mantissa bits), which would break the f32 bounds. One block
//   of 128 threads per (b, h, tile of 128 queries); each thread owns one
//   query row, keeps q and its output accumulator in registers, and walks
//   the keys in tiles of 64 staged in shared memory, so every thread of a
//   warp reads the same key at the same time (a broadcast).
// Both are exact softmaxes with an online max: a masked key scores -1e9
// like the plain version, so once a row has seen a real key the masked
// ones add exactly 0, and a row whose keys are all masked averages V
// uniformly over Lk instead of giving NaN. Key tiles past kv_lengths[b]
// (and past the tile's last row when causal) are skipped when the row has
// a real key, which is exact for the same reason. The kv head of query
// head h is h / (H / Hkv): grouped-query K/V is read in place, never
// repeated.
#include "attn_mma.cuh"

namespace plank {

constexpr int kDh = 64;
constexpr int kQTile = 128;  // queries per block, one per thread
constexpr int kKTile = 64;   // keys staged per shared-memory tile
constexpr int kChunk = 16;   // keys per online-softmax update

template <typename T>
__global__ void __launch_bounds__(kQTile)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ kv_len,
                      T* __restrict__ out, int H, int Hkv, int Lq, int Lk,
                      float sm_scale, int causal) {
  __shared__ float4 ks[kKTile][kDh / 4];
  __shared__ float4 vs[kKTile][kDh / 4];

  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int row = tile * kQTile + threadIdx.x;
  const bool active = row < Lq;

  const T* qrow = q + (((long long)b * H + h) * Lq + (active ? row : 0)) * kDh;
  const T* kb = k + ((long long)b * Hkv + kvh) * Lk * kDh;
  const T* vb = v + ((long long)b * Hkv + kvh) * Lk * kDh;

  float qr[kDh], acc[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) {
    qr[d] = Elem<T>::load(qrow[d]);
    acc[d] = 0.f;
  }
  float m = -1e30f, l = 0.f;

  const int len = kv_len[b];
  int kend = Lk;
  if (len > 0) {
    kend = min(Lk, len);
    if (causal) kend = min(kend, min(Lq, (tile + 1) * kQTile));
  }

  for (int k0 = 0; k0 < kend; k0 += kKTile) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = threadIdx.x; idx < kKTile * kDh; idx += blockDim.x) {
      int j = idx / kDh, d = idx % kDh;
      float kv = 0.f, vv = 0.f;
      if (k0 + j < Lk) {
        kv = Elem<T>::load(kb[(long long)(k0 + j) * kDh + d]);
        vv = Elem<T>::load(vb[(long long)(k0 + j) * kDh + d]);
      }
      reinterpret_cast<float*>(ks[j])[d] = kv;
      reinterpret_cast<float*>(vs[j])[d] = vv;
    }
    __syncthreads();
    if (!active) continue;
    const int nk = min(kKTile, kend - k0);
    for (int c0 = 0; c0 < nk; c0 += kChunk) {
      float s[kChunk];
      float cmax = -1e30f;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = c0 + jj;
        float dot = 0.f;
        if (j < nk) {
#pragma unroll
          for (int d4 = 0; d4 < kDh / 4; ++d4) {
            float4 kk = ks[j][d4];
            dot += qr[4 * d4] * kk.x + qr[4 * d4 + 1] * kk.y +
                   qr[4 * d4 + 2] * kk.z + qr[4 * d4 + 3] * kk.w;
          }
          const int key = k0 + j;
          const bool valid = key < len && (!causal || key <= row);
          dot = valid ? dot * sm_scale : -1e9f;
          cmax = fmaxf(cmax, dot);
        }
        s[jj] = dot;
      }
      const float mnew = fmaxf(m, cmax);
      const float alpha = __expf(m - mnew);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < kDh; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = c0 + jj;
        if (j < nk) {
          const float p = __expf(s[jj] - mnew);
          l += p;
#pragma unroll
          for (int d4 = 0; d4 < kDh / 4; ++d4) {
            float4 vv = vs[j][d4];
            acc[4 * d4] += p * vv.x;
            acc[4 * d4 + 1] += p * vv.y;
            acc[4 * d4 + 2] += p * vv.z;
            acc[4 * d4 + 3] += p * vv.w;
          }
        }
      }
      m = mnew;
    }
  }
  if (!active) return;
  T* orow = out + (((long long)b * H + h) * Lq + row) * kDh;
  const float inv = 1.f / l;
#pragma unroll
  for (int d = 0; d < kDh; ++d) orow[d] = Elem<T>::store(acc[d] * inv);
}

__global__ void __launch_bounds__(attn::kThreads, attn::kFwdBlocks)
    flash_mma_kernel(attn::FwdArgs p) {
  attn::fwd_tile(p);
}

static void launch_f32(const void* q, const void* k, const void* v,
                       const int* kv_len, void* out, long long B, long long H,
                       long long Hkv, long long Lq, long long Lk,
                       float sm_scale, int causal, cudaStream_t stream) {
  dim3 grid((unsigned)((Lq + kQTile - 1) / kQTile), (unsigned)H, (unsigned)B);
  flash_attn_kernel<float><<<grid, kQTile, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), kv_len, static_cast<float*>(out), (int)H,
      (int)Hkv, (int)Lq, (int)Lk, sm_scale, causal);
}

static int launch_bf16(const void* q, const void* k, const void* v,
                       const int* kv_len, void* out, long long B, long long H,
                       long long Hkv, long long Lq, long long Lk,
                       float sm_scale, int causal, cudaStream_t stream) {
  using attn::bf16;
  if (!attn::aligned16(q) || !attn::aligned16(k) || !attn::aligned16(v) ||
      !attn::aligned16(out))
    return cudaErrorMisalignedAddress;
  attn::FwdArgs p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.kv_len = kv_len;
  p.out = static_cast<bf16*>(out);
  p.H = (int)H;
  p.Hkv = (int)Hkv;
  p.Lq = (int)Lq;
  p.Lk = (int)Lk;
  p.Lk_pad = (int)Lk;  // a row with no real key averages over Lk
  p.sm_scale = sm_scale;
  p.causal = causal;
  dim3 grid((unsigned)((Lq + attn::kTile - 1) / attn::kTile), (unsigned)H,
            (unsigned)B);
  flash_mma_kernel<<<grid, attn::kThreads, 0, stream>>>(p);
  return cudaSuccess;
}

}  // namespace plank

extern "C" int plank_flash_attention(const void* q, const void* k,
                                     const void* v, const void* kv_len,
                                     void* out, long long B, long long H,
                                     long long Hkv, long long Lq, long long Lk,
                                     long long Dh, float sm_scale, int causal,
                                     int is_bf16, void* stream) {
  if (Dh != plank::kDh || Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Lq == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_len);
  if (is_bf16) {
    const int code = plank::launch_bf16(q, k, v, lens, out, B, H, Hkv, Lq, Lk,
                                        sm_scale, causal, s);
    if (code != cudaSuccess) return code;
  } else {
    plank::launch_f32(q, k, v, lens, out, B, H, Hkv, Lq, Lk, sm_scale, causal,
                      s);
  }
  return (int)cudaGetLastError();
}
