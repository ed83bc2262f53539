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
// What bounds it on an H100: bytes. A row reads its K and V once (int8:
// 2 * Dh bytes a key) and does 4 * Dh flops a key: ~2 flops per byte, far
// below the ridge. The work is a GEMV per row, so no tensor cores; the aim
// is many bytes in flight, on real keys only, and a short chain of waits:
//
// - Key split: a thread-block cluster of 2 blocks per row (512 blocks at
//   the serving shape, all resident at once); rank c takes the spans of
//   `span` keys c, c + 2, ... (round robin: padded rows keep their real
//   keys in the first spans, so both ranks get a share), and each of its
//   4 warps every 4th of the spans it keeps. A warp works through its
//   spans alone, with no block barrier: on the H100 a block-wide pass over
//   one span at a time left every span waiting on ~5 barriers.
// - Real keys only: a key whose bias is at most NEG_INF / 2 is masked.
//   Each rank reads its spans' bias first (4 bytes a key); a span with no
//   real key is skipped, without reading its K/V, when any rank of the row
//   found a real key (a flag each rank publishes in distributed shared
//   memory). Exact: a masked key's score lies ~1e9 below the row's best
//   real score, so its weight exp(s - m) is exactly 0 in f32. A row with
//   no real key keeps the full average over its Li keys, as the JAX
//   kernel does.
// - Asynchronous, coalesced loads: a span of K and of V are contiguous in
//   the key-major (BH, Li, Dh) layout; a warp stages its spans with
//   16-byte cp.async in two stages (the next span's copy in flight while
//   one is scored), with an online softmax over its spans. Scores take the
//   lanes across Dh (16 bytes a lane, Dh * size / 16 lanes a key, reduced
//   by shuffles); p . V reads V as 16-byte vectors along Dh.
// - Combine: a rank adds its warps' (m, l, o[Dh]) in warp order and
//   publishes the sum in distributed shared memory; rank 0 adds the ranks'
//   in rank order, each exp(m - M) weighted, and divides once:
//   deterministic, no workspace or atomics, and only the f32 summation
//   order differs from the plain version.
#include <cooperative_groups.h>

#include "attn_mma.cuh"

namespace plank {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the 16 / sizeof(KV) values of a 16-byte piece as floats, by bit
// operations on its four words (exact: an int8, or a bf16 as the top half
// of an f32)
__device__ __forceinline__ void unpack(const int4& raw, float (&f)[16]) {
  const unsigned w[4] = {(unsigned)raw.x, (unsigned)raw.y, (unsigned)raw.z,
                         (unsigned)raw.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = (float)((int)(w[i / 4] << (24 - 8 * (i % 4))) >> 24);
}
__device__ __forceinline__ void unpack(const int4& raw, float (&f)[8]) {
  const unsigned w[4] = {(unsigned)raw.x, (unsigned)raw.y, (unsigned)raw.z,
                         (unsigned)raw.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    f[i] = __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
}
__device__ __forceinline__ void unpack(const int4& raw, float (&f)[4]) {
  f[0] = __int_as_float(raw.x);
  f[1] = __int_as_float(raw.y);
  f[2] = __int_as_float(raw.z);
  f[3] = __int_as_float(raw.w);
}

constexpr int kCrossThreads = 128;
constexpr int kWarps = kCrossThreads / 32;
constexpr int kRanks = 2;             // blocks (cluster ranks) per row
constexpr int kStages = 2;            // spans of K and V in flight a warp
constexpr int kMaxSpansPerRank = 64;  // bits of a rank's span masks
constexpr float kMaskedBias = -5e8f;  // NEG_INF / 2: at or below, masked

// One cluster of CL blocks per row r: grid (CL, BH), cluster (CL, 1, 1);
// rank c takes the spans c, c + CL, ... of `span` keys, and its warp w
// every kWarps-th of the spans it keeps. Shared: each warp's kStages of a
// span's K and V and its span of weights; the bias of the rank's spans.
template <typename QT, typename KV>
__global__ void __launch_bounds__(kCrossThreads)
    cross_attn_cluster_kernel(const QT* __restrict__ q,
                              const KV* __restrict__ k,
                              const KV* __restrict__ v,
                              const float* __restrict__ bias,
                              const float* __restrict__ ks,
                              const float* __restrict__ vs, float* out,
                              int Li, int Dh, int span, float sm_scale) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long real_mask;
  __shared__ int x_real;              // published: a span here has a real key
  __shared__ float x_m, x_l;          // published: this rank's max and sum
  __shared__ float x_o[128];          // published: this rank's o (Dh <= 128)
  __shared__ float w_m[kWarps], w_l[kWarps], w_o[kWarps][128];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int E = 16 / sizeof(KV);  // values per 16-byte piece
  const int rank = (int)cluster.block_rank(), CL = (int)cluster.num_blocks();
  const int r = blockIdx.y, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const int P = Dh / E;  // pieces (lanes) per key, a power of two <= 32
  const int nsp = (Li + span - 1) / span;
  const int mine = rank < nsp ? (nsp - rank + CL - 1) / CL : 0;
  KV* stage = reinterpret_cast<KV*>(smem) + warp * kStages * 2 * span * Dh;
  float* sb = reinterpret_cast<float*>(reinterpret_cast<KV*>(smem) +
                                       kWarps * kStages * 2 * span * Dh);
  float* sc = sb + mine * span + warp * span;  // this warp's weights
  const float* br = bias + (long long)r * Li;
  const long long row0 = (long long)r * Li * Dh;

  // 1. this rank's spans' bias, and which of them have a real key
  if (tid == 0) real_mask = 0;
  __syncthreads();
  unsigned long long bits = 0;
  for (int idx = tid; idx < mine * span; idx += kCrossThreads) {
    const int key = (rank + idx / span * CL) * span + idx % span;
    if (key < Li) {
      sb[idx] = br[key];
      if (sb[idx] > kMaskedBias) bits |= 1ull << (idx / span);
    }
  }
  const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)bits);
  const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(bits >> 32));
  if (lane == 0 && (lo | hi))
    atomicOr(&real_mask, (unsigned long long)hi << 32 | lo);
  __syncthreads();
  const unsigned long long mask = real_mask;
  if (tid == 0) x_real = mask != 0;
  cluster.sync();
  int any = 0;
  for (int c = 0; c < CL; ++c) any |= *cluster.map_shared_rank(&x_real, c);
  // no real key in the row: every span, as the plain version
  const unsigned long long todo =
      any ? mask : (mine == 64 ? ~0ull : (1ull << mine) - 1);
  // this warp's spans: every kWarps-th of the rank's, from the warp-th
  unsigned long long own = 0;
  int cnt = 0;
  for (unsigned long long t = todo; t; t &= t - 1, ++cnt)
    if (cnt % kWarps == warp) own |= t & (~t + 1);

  // copies of the warp's next span still to be issued (one group per
  // call; an empty group once every span is issued, so the groups count on)
  unsigned long long to_issue = own;
  int issued = 0;
  auto issue_next = [&]() {
    if (to_issue) {
      const int i = __ffsll((long long)to_issue) - 1;
      to_issue &= to_issue - 1;
      const int j0 = (rank + i * CL) * span, n = min(span, Li - j0);
      KV* Ks = stage + (issued % kStages) * 2 * span * Dh;
      KV* Vs = Ks + span * Dh;
      for (int p = lane; p < n * P; p += 32) {
        attn::cp_async16(Ks + p * E, k + row0 + (long long)j0 * Dh + p * E,
                         16);
        attn::cp_async16(Vs + p * E, v + row0 + (long long)j0 * Dh + p * E,
                         16);
      }
      ++issued;
    }
    attn::cp_async_commit();
  };

  // 2. each warp on its own spans, kStages - 1 copies ahead, with an
  // online softmax over them and no block barrier
  const int piece = lane % P, g = lane / P, groups = 32 / P;
  float qf[E];
#pragma unroll
  for (int e = 0; e < E; ++e)
    qf[e] = to_f(q[(long long)r * Dh + piece * E + e]);
  const float kscale = sm_scale * (ks ? ks[r] : 1.f);
  float m_run = -INFINITY, l_t = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  for (int s = 0; s < kStages - 1; ++s) issue_next();
  unsigned long long left = own;
  for (int done = 0; left; ++done) {
    const int cur = __ffsll((long long)left) - 1;
    left &= left - 1;
    issue_next();
    attn::cp_async_wait<kStages - 1>();  // span `done` has landed
    __syncwarp();
    const int j0 = (rank + cur * CL) * span, n = min(span, Li - j0);
    const KV* Ks = stage + (done % kStages) * 2 * span * Dh;
    const KV* Vs = Ks + span * Dh;
    const float* sbi = sb + cur * span;
    // scores: 32 / P keys a pass, the lanes of a key across Dh
    for (int jb = 0; jb < n; jb += groups) {
      const int j = jb + g;
      float s = 0.f;
      if (j < n) {
        float kf[E];
        unpack(*reinterpret_cast<const int4*>(Ks + j * Dh + piece * E), kf);
#pragma unroll
        for (int i = 0; i < E; ++i) s += qf[i] * kf[i];
      }
      for (int o = P / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (j < n && piece == 0) sc[j] = s * kscale + sbi[j];
    }
    __syncwarp();
    float ms = -INFINITY;
    for (int j = lane; j < n; j += 32) ms = fmaxf(ms, sc[j]);
    const float m_new = fmaxf(m_run, warp_max(ms));
    const float alpha = expf(m_run - m_new);  // 0 for the first span
    m_run = m_new;
    l_t *= alpha;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(sc[j] - m_new);
      sc[j] = e;
      l_t += e;
    }
    __syncwarp();
    // p . V: the warp's 32 / P key groups take every (32 / P)-th key, a
    // lane the E columns of its piece
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
    for (int j = g; j < n; j += groups) {
      float vf[E];
      unpack(*reinterpret_cast<const int4*>(Vs + j * Dh + piece * E), vf);
      const float p = sc[j];
#pragma unroll
      for (int i = 0; i < E; ++i) acc[i] += p * vf[i];
    }
    __syncwarp();  // this stage and sc are rewritten next
  }

  // 3. each warp's (m, l, o), then the rank's: the warps' in warp order,
  // exp(m_w - M) weighted; published for rank 0
  const float lw = warp_sum(l_t);
#pragma unroll
  for (int e = 0; e < E; ++e)
    for (int o = P; o < 32; o <<= 1)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  if (lane < P)
#pragma unroll
    for (int e = 0; e < E; ++e) w_o[warp][piece * E + e] = acc[e];
  if (lane == 0) {
    w_m[warp] = m_run;
    w_l[warp] = lw;
  }
  __syncthreads();
  if (tid < Dh) {
    float M = -INFINITY;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, w_m[w]);
    float o = 0.f, l = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      if (w_m[w] == -INFINITY) continue;
      const float c = expf(w_m[w] - M);
      o += c * w_o[w][tid];
      l += c * w_l[w];
    }
    x_o[tid] = o;
    if (tid == 0) {
      x_m = M;
      x_l = l;
    }
  }
  cluster.sync();

  // 4. rank 0 adds the ranks' partials in rank order
  if (rank == 0 && tid < Dh) {
    float M = -INFINITY;
    for (int c = 0; c < CL; ++c)
      M = fmaxf(M, *cluster.map_shared_rank(&x_m, c));
    float num = 0.f, den = 0.f;
    for (int c = 0; c < CL; ++c) {
      const float mc = *cluster.map_shared_rank(&x_m, c);
      if (mc == -INFINITY) continue;
      const float w = expf(mc - M);
      den += w * *cluster.map_shared_rank(&x_l, c);
      num += w * cluster.map_shared_rank(x_o, c)[tid];
    }
    out[(long long)r * Dh + tid] = num / den * (vs ? vs[r] : 1.f);
  }
  cluster.sync();  // the other ranks' shared memory stays until read
}

// keys per span: 64, halved while a warp's stages of K and V would pass
// 8 KB (so that enough blocks stay resident), but at least 16
static int span_keys(int Dh, int kv_size) {
  int span = 64;
  while (span > 16 && (size_t)2 * kStages * span * Dh * kv_size > 8 * 1024)
    span /= 2;
  return span;
}

static void cross_split(int Li, int span, int& CL, int& npr) {
  const int nsp = (Li + span - 1) / span;
  CL = nsp < kRanks ? nsp : kRanks;
  npr = (nsp + CL - 1) / CL;
}

template <typename QT, typename KV>
static int launch(const void* q, const void* k, const void* v,
                  const float* bias, const float* ks, const float* vs,
                  float* out, int BH, int Li, int Dh, float sm_scale,
                  cudaStream_t s) {
  const int span = span_keys(Dh, sizeof(KV));
  int CL, npr;
  cross_split(Li, span, CL, npr);
  if (npr > kMaxSpansPerRank) return cudaErrorInvalidValue;
  const size_t smem =
      (size_t)kWarps * 2 * kStages * span * Dh * sizeof(KV) +
      (size_t)(npr + kWarps) * span * sizeof(float);
  auto kernel = cross_attn_cluster_kernel<QT, KV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, BH);
  cfg.blockDim = dim3(kCrossThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<const QT*>(q),
                                 static_cast<const KV*>(k),
                                 static_cast<const KV*>(v), bias, ks, vs,
                                 out, Li, Dh, span, sm_scale);
}

}  // namespace plank

// q (BH, Dh) f32 or bf16; k, v (BH, Li, Dh) int8 or q's type; bias (BH,
// Li) f32; ks, vs (BH) f32, or null for scales of 1; out (BH, Dh) f32.
// cudaErrorInvalidValue when a row has more spans than the cluster's
// ranks hold (Li past kRanks * kMaxSpansPerRank spans). Launches on
// `stream`; does not synchronise.
extern "C" int plank_cross_attn_decode(const void* q, const void* k,
                                       const void* v, const float* bias,
                                       const float* ks, const float* vs,
                                       float* out, long long BH, long long Li,
                                       long long Dh, float sm_scale,
                                       int q_bf16, int kv_int8,
                                       void* stream) {
  const int kv_size = kv_int8 ? 1 : (q_bf16 ? 2 : 4);
  const long long P = Dh * kv_size / 16;
  if (BH <= 0 || BH > 65535 || Li <= 0 || Li > (1 << 24) || Dh <= 0 ||
      (Dh * kv_size) % 16 || P > 32 || (P & (P - 1)) || Dh > 128)
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
