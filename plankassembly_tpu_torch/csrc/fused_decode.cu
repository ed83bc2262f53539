// One whole decoder layer of one decode step over int8 self and cross
// caches, and its feed-forward sublayer.
//
// Replaces: plankassembly_tpu/ops/fused_decode.py::fused_decoder_layer
// (Pallas `_kernel`) and fused_ffn (`_ffn_kernel`). The TPU kernel runs the
// layer for a block of rows in one grid step and gets its attention onto
// the MXU by scattering every (row, head) query into a block-diagonal
// matrix (Qbig) and every weight row into P_big, with int8 dots. Those are
// TPU devices; what they compute, per (row, head), is kept exactly:
//
// - q, the cross query and the self-attention weights are quantized to int8
//   per (row, head) (the weights after their keys' V scales fold in, the
//   cross weights per chunk of CH keys on their own scale), and every
//   q . K and p . V runs as an integer sum, here on __dp4a (four int8
//   products into int32 per instruction). Integer sums are exact, so only
//   the float work around them is in another order than the TPU's;
// - the new token's K/V are quantized per head and returned; its own score
//   uses the f32 q against its dequantized k, its weight stays f32;
// - the products with weights take A and W in the compute dtype T, sum in
//   f32 and add an f32 bias with no rounding to T (split-K GEMMs with
//   their own epilogue, not the decode loop's rounding one).
//
// What bounds it on an H100: bytes. A call reads the layer's weights once
// (~5 MB in bf16), the int8 cross K/V of every row's real keys (2 * Dh
// bytes a key and head) and the self cache so far, and does ~2 operations
// per byte. The layer is a chain of kernels on one stream: QKV GEMM (LN1 in
// its prologue) -> self kernel -> wo GEMM (+residual) -> cross-q GEMM (LN2
// in its prologue) -> cross kernel -> woc GEMM (+residual); `fused_ffn` is
// w1 GEMM (LN3 in its prologue, relu) -> w2 GEMM (+residual). The GEMMs
// are csrc/gemm_mma.cuh's (32 x 32 tiles, split K over a cluster,
// cp.async): in bf16, woc, w1 and w2 on the tensor cores (mma.sync), QKV,
// wo and cross-q in the SIMT GEMM's order of f32 sums (`product` says
// why); every f32 product in that order, since the tensor cores take f32
// only as TF32.
// The self kernel takes one block per (head, row): 256 blocks at the serving
// batch of 32. The cross kernel takes a cluster of blocks per (head, row),
// which split the row's chunks of CH keys and skip the chunks with no real
// key (below). Layouts (ops/fused_decode.py): self K (B, H, S, Dh) and cross
// K (B, H, Li, Dh) with a key's Dh values contiguous, self V (B, H, Dh, S)
// and cross V (B, H, Dh, Li) with a column's keys contiguous, so each
// integer sum reads 4-byte words along its contraction.
#include <cooperative_groups.h>

#include <type_traits>

#include "gemm_mma.cuh"

namespace plank {

constexpr int kAttnThreads = 128;

__device__ __forceinline__ float quant_scale(float absmax) {
  return fmaxf(absmax / 127.f, 1e-8f);
}

__device__ __forceinline__ int8_t quant(float v, float scale) {
  return (int8_t)rintf(v / scale);  // round half to even, as jnp.round
}

// y = acc + bias[n] in f32, then relu / a residual add / nothing, stored
// in OutT at out[m * ldo + n] (resid has the same layout as out).
template <typename OutT, int EPI>
struct F32Epilogue {
  const float* bias;
  const float* resid;
  OutT* out;
  long long ldo;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    float y = acc + bias[n];
    if constexpr (EPI == kRelu) y = fmaxf(y, 0.f);
    if constexpr (EPI == kResidual) y = resid[(long long)m * ldo + n] + y;
    out[(long long)m * ldo + n] = Elem<OutT>::store(y);
  }
};

// ------------------------------------------------------- self-attention
// One block per (head h, row b), the new token at position t. Shared: S
// scores (then weights), q as int8 words, S int8 weights.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    fused_self_kernel(const float* __restrict__ qkv,
                      const int8_t* __restrict__ kc,
                      const int8_t* __restrict__ vc,
                      const float* __restrict__ ksc,
                      const float* __restrict__ vsc, T* att, int8_t* nk,
                      int8_t* nv, float* nks, float* nvs, int t, int S, int H,
                      int Dh, float sm_scale) {
  extern __shared__ float sm[];
  __shared__ float red[32];
  __shared__ float pt_s;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int D = H * Dh;
  const long long bh = (long long)b * H + h;
  float* sc = sm;
  int* qw = reinterpret_cast<int*>(sc + S);
  int8_t* pw = reinterpret_cast<int8_t*>(qw + Dh / 4);

  // the new token's q, k, v of this head: quantize k, v (returned) and q
  const float* row = qkv + (long long)b * 3 * D + h * Dh;
  float q = 0.f, k = 0.f, v = 0.f;
  if (tid < Dh) {
    q = row[tid];
    k = row[D + tid];
    v = row[2 * D + tid];
  }
  const float ks = quant_scale(block_max(fabsf(k), red));
  const float vs = quant_scale(block_max(fabsf(v), red));
  const float qs = quant_scale(block_max(fabsf(q), red));
  int8_t k8 = 0, v8 = 0;
  if (tid < Dh) {
    k8 = quant(k, ks);
    v8 = quant(v, vs);
    nk[(long long)b * D + h * Dh + tid] = k8;
    nv[(long long)b * D + h * Dh + tid] = v8;
    reinterpret_cast<int8_t*>(qw)[tid] = quant(q, qs);
  }
  if (tid == 0) {
    nks[bh] = ks;
    nvs[bh] = vs;
  }
  // its own score: f32 q against the dequantized k (block_sum syncs, so
  // the int8 q is in place after it)
  const float own =
      block_sum(tid < Dh ? q * ((float)k8 * ks) : 0.f, red) * sm_scale;

  // cached keys s < t: integer q . k, times the query's and the key's scales
  const float qscale = qs * sm_scale;
  const int n4 = Dh / 4;
  const int8_t* kb = kc + bh * S * Dh;
  const float* ksr = ksc + bh * S;
  for (int s = tid; s < t; s += blockDim.x) {
    const int* kr = reinterpret_cast<const int*>(kb + (long long)s * Dh);
    int acc = 0;
    for (int i = 0; i < n4; ++i) acc = __dp4a(qw[i], kr[i], acc);
    sc[s] = ((float)acc * qscale) * ksr[s];
  }
  if (tid == 0) sc[t] = own;
  __syncthreads();
  float m = -INFINITY;
  for (int s = tid; s <= t; s += blockDim.x) m = fmaxf(m, sc[s]);
  m = block_max(m, red);
  float sum = 0.f;
  for (int s = tid; s <= t; s += blockDim.x) {
    const float e = expf(sc[s] - m);
    sc[s] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  // weights: the new token's stays f32; the others take their V scale and
  // are quantized on the row's absmax
  const float* vsr = vsc + bh * S;
  float pmax = 0.f;
  for (int s = tid; s <= t; s += blockDim.x) {
    const float p = sc[s] / sum;
    if (s == t) pt_s = p;
    const float pv = s == t ? 0.f : p * vsr[s];
    sc[s] = pv;
    pmax = fmaxf(pmax, fabsf(pv));
  }
  const float ps = quant_scale(block_max(pmax, red));
  for (int s = tid; s < S; s += blockDim.x)
    pw[s] = s < t ? quant(sc[s], ps) : (int8_t)0;
  __syncthreads();

  // o_d = (sum_s p8_s v8_sd) * ps + pt * (v8_d * vs)
  if (tid < Dh) {
    const int* vr = reinterpret_cast<const int*>(vc + (bh * Dh + tid) * S);
    const int* pr = reinterpret_cast<const int*>(pw);
    int acc = 0;
    for (int i = 0; i < (t + 3) / 4; ++i) acc = __dp4a(pr[i], vr[i], acc);
    const float o = (float)acc * ps + pt_s * ((float)v8 * vs);
    att[(long long)b * D + h * Dh + tid] = Elem<T>::store(o);
  }
}

// ------------------------------------------------------ cross-attention
// A thread-block cluster of CL blocks per (head h, row b): grid (CL, H, B),
// cluster (CL, 1, 1). Rank r takes the chunks of CH keys r, r + CL, ...
// (round robin: padded rows have their real keys in the first chunks, so
// every rank gets a share of them).
//
// 1. Each rank reads its chunks' bias. A chunk with no real key (bias at
//    most NEG_INF / 2 everywhere) is skipped without reading its K/V when
//    the row has a real key in any rank's chunks (a flag each rank
//    publishes in distributed shared memory). Exact: such a chunk's
//    exp(s - max) are all exactly 0 in f32, so its weights quantize to 0
//    and it adds exactly 0 to l and o. A row with no real key takes every
//    chunk, as the plain version.
// 2. The chunks it takes: K (CH x Dh int8, contiguous) and V columns (Dh
//    rows of CH contiguous int8) staged by 16-byte cp.async; scores from
//    integer q . k on __dp4a, the lanes of a key across Dh (16 bytes a
//    lane) and their int32 parts added by shuffles, exactly.
// 3. The row max over every rank's scores, through distributed shared
//    memory; then per chunk, as the plain version: exp(s - max) added to l
//    unquantized, quantized on the chunk's own absmax, and weighing the
//    int8 V in integer sums (the lanes of a column across the chunk).
// 4. Rank 0 adds the chunks' (l, o) in chunk order, as the plain version,
//    and writes o * v_scale / l: the float work is the one-block kernel's,
//    operation for operation.
constexpr int kMaxChunksPerRank = 8;
constexpr float kMaskedBias = -5e8f;  // NEG_INF / 2: at or below, masked

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    fused_cross_split_kernel(const float* __restrict__ q2,
                             const int8_t* __restrict__ ck,
                             const int8_t* __restrict__ cv,
                             const float* __restrict__ cks,
                             const float* __restrict__ cvs,
                             const float* __restrict__ cbias, T* att, int H,
                             int Dh, int Li, int CH, int npr,
                             float sm_scale) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[32];
  __shared__ int qw[32];            // q as int8 words (Dh <= 128)
  __shared__ int x_real;            // published: a chunk here has a real key
  __shared__ float x_max;           // published: max of this rank's scores
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), CL = (int)cluster.num_blocks();
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int D = H * Dh, nch = Li / CH;
  const long long bh = (long long)b * H + h;
  int8_t* Kst = reinterpret_cast<int8_t*>(smem);          // npr x CH x Dh
  int8_t* Vst = Kst + (size_t)npr * CH * Dh;              // npr x Dh x CH
  float* sc = reinterpret_cast<float*>(Vst + (size_t)npr * Dh * CH);
  int8_t* pw = reinterpret_cast<int8_t*>(sc + npr * CH);  // CH weights
  // published: each of this rank's chunks' l, weight scale and integer
  // p . v sums as floats (all 0 when skipped)
  float* x_part = reinterpret_cast<float*>(pw + CH);  // npr x (2 + Dh)
  const int XP = 2 + Dh;

  const float q = tid < Dh ? q2[(long long)b * D + h * Dh + tid] : 0.f;
  const float qs = quant_scale(block_max(fabsf(q), red));
  if (tid < Dh) reinterpret_cast<int8_t*>(qw)[tid] = quant(q, qs);
  for (int i = tid; i < npr * XP; i += kAttnThreads) x_part[i] = 0.f;

  // 1. this rank's chunks: bias into sc, which of them have a real key
  const float* br = cbias + (long long)b * Li;
  int mine = 0, real = 0;
  for (int i = 0; i < npr && rank + i * CL < nch; ++i) {
    const int c0 = (rank + i * CL) * CH;
    bool r = false;
    for (int j = tid; j < CH; j += kAttnThreads) {
      sc[i * CH + j] = br[c0 + j];
      r |= sc[i * CH + j] > kMaskedBias;
    }
    if (__syncthreads_or(r)) real |= 1 << i;
    ++mine;
  }
  const int8_t* kb = ck + bh * Li * Dh;
  const int8_t* vb = cv + bh * Dh * Li;
  auto stage = [&](int i) {
    const int c0 = (rank + i * CL) * CH;
    const int pk = CH * Dh / 16, pv = CH / 16;
    for (int p = tid; p < pk; p += kAttnThreads)
      attn::cp_async16(Kst + (size_t)i * CH * Dh + p * 16,
                       kb + (long long)c0 * Dh + p * 16, 16);
    for (int p = tid; p < Dh * pv; p += kAttnThreads) {
      const int d = p / pv, w = p % pv;
      attn::cp_async16(Vst + ((size_t)i * Dh + d) * CH + w * 16,
                       vb + (long long)d * Li + c0 + w * 16, 16);
    }
  };
  for (int i = 0; i < mine; ++i)
    if (real >> i & 1) stage(i);
  attn::cp_async_commit();
  if (tid == 0) x_real = real != 0;
  cluster.sync();
  int any = 0;
  for (int rr = 0; rr < CL; ++rr) any |= *cluster.map_shared_rank(&x_real, rr);
  int todo = real;
  if (!any) {  // no real key in the row: every chunk, as the plain version
    todo = (1 << mine) - 1;
    for (int i = 0; i < mine; ++i) stage(i);
    attn::cp_async_commit();
  }
  attn::cp_async_wait<0>();
  __syncthreads();

  // 2. scores: lanes of a key across Dh, 16 bytes (four words) each
  const float qscale = qs * sm_scale, kscale = cks[bh];
  const int PK = Dh / 16, LK = pow2_at_least(PK);
  const int kpw = 32 / LK, pk = lane % LK;
  float m = -INFINITY;
  for (int i = 0; i < mine; ++i) {
    if (!(todo >> i & 1)) continue;
    for (int jb = 0; jb < CH; jb += kpw * (kAttnThreads / 32)) {
      const int j = jb + warp * kpw + lane / LK;
      int acc = 0;
      if (j < CH && pk < PK) {
        const int4 kw = *reinterpret_cast<const int4*>(
            Kst + ((size_t)i * CH + j) * Dh + pk * 16);
        acc = __dp4a(qw[pk * 4], kw.x, acc);
        acc = __dp4a(qw[pk * 4 + 1], kw.y, acc);
        acc = __dp4a(qw[pk * 4 + 2], kw.z, acc);
        acc = __dp4a(qw[pk * 4 + 3], kw.w, acc);
      }
      for (int o = LK / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (j < CH && pk == 0) {
        const float s = ((float)acc * qscale) * kscale + sc[i * CH + j];
        sc[i * CH + j] = s;
        m = fmaxf(m, s);
      }
    }
  }
  m = block_max(m, red);
  if (tid == 0) x_max = m;
  cluster.sync();
  for (int rr = 0; rr < CL; ++rr)
    m = fmaxf(m, *cluster.map_shared_rank(&x_max, rr));

  // 3. chunk by chunk: l, the chunk's weights, integer p . v
  const int PV = CH / 16, LV = pow2_at_least(PV);
  const int dpw = 32 / LV, pv = lane % LV;
  for (int i = 0; i < mine; ++i) {
    if (!(todo >> i & 1)) continue;
    float* s = sc + i * CH;
    float csum = 0.f, cmax = 0.f;
    for (int j = tid; j < CH; j += kAttnThreads) {
      const float e = expf(s[j] - m);
      s[j] = e;
      csum += e;
      cmax = fmaxf(cmax, e);
    }
    const float lc = block_sum(csum, red);
    const float cs = quant_scale(block_max(cmax, red));
    if (tid == 0) {
      x_part[i * XP] = lc;
      x_part[i * XP + 1] = cs;
    }
    for (int j = tid; j < CH; j += kAttnThreads) pw[j] = quant(s[j], cs);
    __syncthreads();
    for (int db = 0; db < Dh; db += dpw * (kAttnThreads / 32)) {
      const int d = db + warp * dpw + lane / LV;
      int acc = 0;
      if (d < Dh && pv < PV) {
        const int4 vw = *reinterpret_cast<const int4*>(
            Vst + ((size_t)i * Dh + d) * CH + pv * 16);
        const int4 pw4 = *reinterpret_cast<const int4*>(pw + pv * 16);
        acc = __dp4a(pw4.x, vw.x, acc);
        acc = __dp4a(pw4.y, vw.y, acc);
        acc = __dp4a(pw4.z, vw.z, acc);
        acc = __dp4a(pw4.w, vw.w, acc);
      }
      for (int o = LV / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (d < Dh && pv == 0) x_part[i * XP + 2 + d] = (float)acc;
    }
    __syncthreads();  // pw is rewritten by the next chunk
  }

  // 4. rank 0 adds the chunks' l and o in chunk order, o by the fused
  // multiply-add of the one-block kernel (o += sum * cs); a skipped
  // chunk's zeros add exactly nothing. The loads of 8 chunks at a time are
  // issued together.
  cluster.sync();
  if (rank == 0 && tid < Dh) {
    float lt = 0.f, o = 0.f;
    for (int c0 = 0; c0 < nch; c0 += 8) {
      float lv[8], cv8[8], tv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (c0 + u < nch) {
          const int c = c0 + u;
          const float* p =
              cluster.map_shared_rank(x_part + c / CL * XP, c % CL);
          lv[u] = p[0];
          cv8[u] = p[1];
          tv[u] = p[2 + tid];
        }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (c0 + u < nch) {
          lt += lv[u];
          o = fmaf(tv[u], cv8[u], o);
        }
    }
    att[(long long)b * D + h * Dh + tid] = Elem<T>::store(o * (cvs[bh] / lt));
  }
  cluster.sync();  // the other ranks' shared memory stays until read
}

// ranks per (head, row) and chunks per rank for Li / CH chunks
static void cross_split(int nch, int& CL, int& npr) {
  npr = (nch + 7) / 8;
  CL = (nch + npr - 1) / npr;
}

static size_t cross_smem(int npr, int CH, int Dh) {
  return (size_t)npr * CH * Dh * 2 + (size_t)npr * CH * 4 + CH +
         (size_t)npr * (2 + Dh) * 4;
}

template <typename T>
static int launch_cross(const float* q2, const int8_t* ck, const int8_t* cv,
                        const float* cks, const float* cvs,
                        const float* cbias, T* att, int B, int H, int Dh,
                        int Li, int CH, float sm_scale, cudaStream_t s) {
  int CL, npr;
  cross_split(Li / CH, CL, npr);
  const size_t smem = cross_smem(npr, CH, Dh);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_cross_split_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, H, B);
  cfg.blockDim = dim3(kAttnThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, fused_cross_split_kernel<T>, q2, ck,
                                 cv, cks, cvs, cbias, att, H, Dh, Li, CH, npr,
                                 sm_scale);
}

// The products: gemm_mma.cuh's cluster GEMM, with the layer norm in its
// prologue, on the tensor cores (kTC, bf16 only) or in the SIMT GEMM's
// order of f32 sums (every f32 product: TF32 would break the f32 bounds).
// A sum in another order than the plain version's lands a value on the
// other side of a rounding tie now and then (QKV and the cross query are
// quantized to int8, wo's and woc's sums reach the bf16 output of the next
// layer norm, w1's are stored in bf16), and the flip moves its row by
// 1e-4-1e-3 of its largest value. Along the plain version's decode
// (chip_smoke.py's trajectory check: 1536 (point, row) pairs, at most 2%
// past the fused row tolerance) the bf16 layer with every product in the
// SIMT order puts 24 pairs past it; QKV or the cross query on the tensor
// cores 11-22 more (and QKV flips new K/V int8 values, which stay in the
// cache), each of wo, woc and w1 2-4 more, w2 none. So QKV, cross-q and
// wo, which adds the most of the three, take the SIMT order; woc, w1 and
// w2 run on the tensor cores (28 pairs).
template <bool kTC, typename T, typename Epi>
static int product(const float* ln_x, const float* ln_p, const T* A,
                   const void* W, int M, int N, int K, Epi epi,
                   cudaStream_t s) {
  constexpr bool tc = kTC && std::is_same<T, __nv_bfloat16>::value;
  if (ln_x != nullptr)
    return gemm::cluster_gemm<tc, T, true>(nullptr, 0, {ln_x, ln_p, ln_p + K},
                                           W, M, N, K, epi, s);
  return gemm::cluster_gemm<tc, T, false>(A, K, {}, W, M, N, K, epi, s);
}

template <typename T>
static int layer(const float* x, const void* wqkv, const float* bqkv,
                 const void* wos, const float* bos, const void* wqc,
                 const float* bqc, const void* woc, const float* boc,
                 const float* ln, const int8_t* kc, const int8_t* vc,
                 const float* ksc, const float* vsc, const int8_t* ck,
                 const int8_t* cv, const float* cks, const float* cvs,
                 const float* cbias, float* x_out, int8_t* nk, int8_t* nv,
                 float* nks, float* nvs, float* qkv, void* h_buf,
                 float* x_mid, int B, int H, int Dh, int S, int Li, int CH,
                 int t, float sm_scale, cudaStream_t s) {
  const int D = H * Dh;
  T* h = static_cast<T*>(h_buf);  // the attention outputs
  const size_t self_smem = (size_t)S * 4 + Dh + S;

  int e = product<false, T>(x, ln, nullptr, wqkv, B, 3 * D, D,
                            F32Epilogue<float, kStore>{bqkv, nullptr, qkv,
                                                       3 * D},
                            s);
  if (e != 0) return e;
  fused_self_kernel<T><<<dim3(H, B), kAttnThreads, self_smem, s>>>(
      qkv, kc, vc, ksc, vsc, h, nk, nv, nks, nvs, t, S, H, Dh, sm_scale);
  if ((e = (int)cudaGetLastError()) != 0) return e;
  e = product<false, T>(nullptr, nullptr, h, wos, B, D, D,
                       F32Epilogue<float, kResidual>{bos, x, x_mid, D}, s);
  if (e != 0) return e;
  float* q2 = qkv;  // (B, D), the QKV rows are consumed
  e = product<false, T>(x_mid, ln + 2 * D, nullptr, wqc, B, D, D,
                        F32Epilogue<float, kStore>{bqc, nullptr, q2, D}, s);
  if (e != 0) return e;
  e = launch_cross<T>(q2, ck, cv, cks, cvs, cbias, h, B, H, Dh, Li, CH,
                      sm_scale, s);
  if (e != 0) return e;
  return product<true, T>(nullptr, nullptr, h, woc, B, D, D,
                          F32Epilogue<float, kResidual>{boc, x_mid, x_out, D},
                          s);
}

template <typename T>
static int ffn(const float* x, const void* w1, const float* b1,
               const void* w2, const float* b2, const float* ln3,
               void* h_buf, float* out, int B, int D, int F, cudaStream_t s) {
  T* z = static_cast<T*>(h_buf);  // (B, F) relu(LN3(x) @ w1 + b1)
  const int e = product<true, T>(x, ln3, nullptr, w1, B, F, D,
                                 F32Epilogue<T, kRelu>{b1, nullptr, z, F}, s);
  if (e != 0) return e;
  return product<true, T>(nullptr, nullptr, z, w2, B, D, F,
                          F32Epilogue<float, kResidual>{b2, x, out, D}, s);
}

}  // namespace plank

// The attention part of one decoder layer at step t (everything but the
// FFN): x (B, D) f32 -> x_out (B, D) f32, and the new token's int8 K/V rows
// nk, nv (B, D) with their scales nks, nvs (B, H). Weights in the compute
// dtype (is_bf16), biases and `ln` (6, D) f32; caches and cross K/V in the
// layouts above. Scratch: qkv (B, 3D) f32, h (B, D) compute dtype, x_mid
// (B, D) f32. Launches on `stream`; does not synchronise.
extern "C" int plank_fused_layer(
    const float* x, const void* wqkv, const float* bqkv, const void* wos,
    const float* bos, const void* wqc, const float* bqc, const void* woc,
    const float* boc, const float* ln, const int8_t* kc, const int8_t* vc,
    const float* ksc, const float* vsc, const int8_t* ck, const int8_t* cv,
    const float* cks, const float* cvs, const float* cbias, float* x_out,
    int8_t* nk, int8_t* nv, float* nks, float* nvs, float* qkv, void* h,
    float* x_mid, long long B, long long H,
    long long Dh, long long S, long long Li, long long CH, long long t,
    float sm_scale, int is_bf16, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || Dh <= 0 || Dh % 16 ||
      Dh > plank::kAttnThreads || S % 4 || S * 4 > 40 * 1024 || CH <= 0 ||
      CH % 16 || CH > 512 || Li % CH ||
      Li / CH > 8 * plank::kMaxChunksPerRank ||
      t < 0 || t >= S ||
      (H * Dh) % 128 || H * Dh > 1024)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = is_bf16 ? &plank::layer<__nv_bfloat16> : &plank::layer<float>;
  return run(x, wqkv, bqkv, wos, bos, wqc, bqc, woc, boc, ln, kc, vc, ksc,
             vsc, ck, cv, cks, cvs, cbias, x_out, nk, nv, nks, nvs, qkv, h,
             x_mid, (int)B, (int)H, (int)Dh, (int)S, (int)Li,
             (int)CH, (int)t, sm_scale, s);
}

// fused_ffn: out = x + relu(LN3(x) @ w1 + b1) @ w2 + b2 on x (B, D) f32;
// ln3 (2, D); D and F multiples of 128, at most 1024. Scratch: h (B, F)
// compute dtype. Launches on `stream`; does not synchronise.
extern "C" int plank_fused_ffn(const float* x, const void* w1,
                               const float* b1, const void* w2,
                               const float* b2, const float* ln3, void* h,
                               float* out, long long B, long long D,
                               long long F, int is_bf16, void* stream) {
  if (B <= 0 || D <= 0 || F <= 0 || D % 128 || D > 1024 || F % 128 ||
      F > 1024)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? plank::ffn<__nv_bfloat16>(x, w1, b1, w2, b2, ln3, h, out,
                                             (int)B, (int)D, (int)F, s)
                 : plank::ffn<float>(x, w1, b1, w2, b2, ln3, h, out, (int)B,
                                     (int)D, (int)F, s);
}
