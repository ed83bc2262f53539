// One decode step of cross-attention for every (batch, head) row.
//
// Replaces: plankassembly_tpu/ops/cross_decode.py::cross_attn_decode
// (Pallas `_kernel`), which on the TPU takes 16 rows per grid step with K
// head-major and Dh-major, (BH, Dh, Li), for its lane tiling.
//
// Per row r: scores_j = (q . k_j) * (sm_scale * k_scale_r) + bias_j, a
// max-subtracted softmax p, out = (sum_j p_j v_j) * v_scale_r; K/V int8
// (one symmetric scale per row) or in the query's dtype (scales 1), all
// arithmetic in f32, f32 output.
//
// What bounds it on an H100: bytes. A row reads its Li x Dh K and V once
// (int8: 2 * Li * Dh bytes) and does 4 * Li * Dh flops: ~2 flops per byte,
// far below the ridge. So the design is one block per row (B * H = 256
// blocks at the serving batch of 32), K and V both key-major (BH, Li, Dh)
// so a thread that scores one key reads its Dh values in 16-byte pieces
// and a warp reads contiguous memory; the scores stay in shared memory
// (Li floats); for p.V, 256 / Dh groups of threads each take every
// (256 / Dh)-th key for one column d and add up in group order at the end.
// A plain SIMT kernel; no tensor cores (the work is a GEMV per row).
#include "common.cuh"

namespace plank {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

constexpr int kCrossDecodeThreads = 256;

template <typename QT, typename KV>
__global__ void __launch_bounds__(kCrossDecodeThreads)
    cross_attn_decode_kernel(const QT* __restrict__ q,
                             const KV* __restrict__ k,
                             const KV* __restrict__ v,
                             const float* __restrict__ bias,
                             const float* __restrict__ ks,
                             const float* __restrict__ vs, float* out,
                             int Li, int Dh, float sm_scale) {
  extern __shared__ float sm[];
  __shared__ float red[32];
  const int r = blockIdx.x, tid = threadIdx.x;
  float* qf = sm;          // Dh
  float* sc = qf + Dh;     // Li scores, then weights
  float* part = sc + Li;   // (blockDim / Dh) * Dh partial outputs
  for (int d = tid; d < Dh; d += blockDim.x)
    qf[d] = to_f(q[(long long)r * Dh + d]);
  __syncthreads();

  constexpr int E = 16 / sizeof(KV);  // values per 16-byte piece
  const float kscale = sm_scale * ks[r];
  const KV* kr = k + (long long)r * Li * Dh;
  const float* br = bias + (long long)r * Li;
  float m = -INFINITY;
  for (int j = tid; j < Li; j += blockDim.x) {
    const KV* row = kr + (long long)j * Dh;
    float s = 0.f;
    for (int d0 = 0; d0 < Dh; d0 += E) {
      const int4 raw = *reinterpret_cast<const int4*>(row + d0);
      const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
      for (int i = 0; i < E; ++i) s += qf[d0 + i] * to_f(e[i]);
    }
    s = s * kscale + br[j];
    sc[j] = s;
    m = fmaxf(m, s);
  }
  m = block_max(m, red);
  float sum = 0.f;
  for (int j = tid; j < Li; j += blockDim.x) {
    const float e = expf(sc[j] - m);
    sc[j] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  for (int j = tid; j < Li; j += blockDim.x) sc[j] = sc[j] / sum;
  __syncthreads();

  const int groups = blockDim.x / Dh, g = tid / Dh, d = tid % Dh;
  const KV* vr = v + (long long)r * Li * Dh;
  if (g < groups) {
    float o = 0.f;
    for (int j = g; j < Li; j += groups)
      o += sc[j] * to_f(vr[(long long)j * Dh + d]);
    part[g * Dh + d] = o;
  }
  __syncthreads();
  if (tid < Dh) {
    float o = 0.f;
    for (int gg = 0; gg < groups; ++gg) o += part[gg * Dh + tid];
    out[(long long)r * Dh + tid] = o * vs[r];
  }
}

template <typename QT, typename KV>
static int launch(const void* q, const void* k, const void* v,
                  const float* bias, const float* ks, const float* vs,
                  float* out, int BH, int Li, int Dh, float sm_scale,
                  cudaStream_t s) {
  const size_t smem =
      (size_t)(Dh + Li + (kCrossDecodeThreads / Dh) * Dh) * sizeof(float);
  cross_attn_decode_kernel<QT, KV><<<BH, kCrossDecodeThreads, smem, s>>>(
      static_cast<const QT*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), bias, ks, vs, out, Li, Dh, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace plank

// q (BH, Dh) f32 or bf16; k, v (BH, Li, Dh) int8 or q's type; bias (BH,
// Li), ks, vs (BH) f32; out (BH, Dh) f32. Launches on `stream`; does not
// synchronise.
extern "C" int plank_cross_attn_decode(const void* q, const void* k,
                                       const void* v, const float* bias,
                                       const float* ks, const float* vs,
                                       float* out, long long BH, long long Li,
                                       long long Dh, float sm_scale,
                                       int q_bf16, int kv_int8,
                                       void* stream) {
  const size_t kv_size = kv_int8 ? 1 : (q_bf16 ? 2 : 4);
  if (BH <= 0 || Li <= 0 || Dh <= 0 || Dh > plank::kCrossDecodeThreads ||
      (Dh * kv_size) % 16 ||
      (Dh + Li + plank::kCrossDecodeThreads) * sizeof(float) > 48 * 1024)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = (int)BH, li = (int)Li, dh = (int)Dh;
  if (q_bf16)
    return kv_int8
               ? plank::launch<__nv_bfloat16, int8_t>(q, k, v, bias, ks, vs,
                                                      out, bh, li, dh,
                                                      sm_scale, s)
               : plank::launch<__nv_bfloat16, __nv_bfloat16>(
                     q, k, v, bias, ks, vs, out, bh, li, dh, sm_scale, s);
  return kv_int8 ? plank::launch<float, int8_t>(q, k, v, bias, ks, vs, out,
                                                bh, li, dh, sm_scale, s)
                 : plank::launch<float, float>(q, k, v, bias, ks, vs, out,
                                               bh, li, dh, sm_scale, s);
}
