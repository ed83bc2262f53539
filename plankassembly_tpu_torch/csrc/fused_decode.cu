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
//   f32 and add an f32 bias with no rounding to T (the split-K GEMM of
//   common.cuh with its own epilogue, not the decode loop's rounding one).
//
// What bounds it on an H100: bytes. A call reads the layer's weights once
// (~5 MB in bf16), the int8 cross K/V of every row (2 * B * Li * D bytes,
// ~38 MB at B=32, Li=1152) and the self cache so far, and does ~2
// operations per byte. The layer is a chain of simple kernels on one
// stream, as the decode loop of decode.cu: LN1 -> QKV GEMM -> self kernel
// -> wo GEMM (+residual) -> LN2 -> cross-q GEMM -> cross kernel -> woc GEMM
// (+residual); `fused_ffn` is LN3 -> w1 GEMM (relu) -> w2 GEMM
// (+residual). The attention kernels take one block per (head, row):
// 256 blocks at the serving batch of 32. Layouts (ops/fused_decode.py):
// self K (B, H, S, Dh) and cross K (B, H, Li, Dh) with a key's Dh values
// contiguous, self V (B, H, Dh, S) and cross V (B, H, Dh, Li) with a
// column's keys contiguous, so each integer sum reads 4-byte words along
// its contraction.
#include "common.cuh"

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
// One block per (head h, row b). Pass 1 scores every key (integer q . k)
// and takes the row max; pass 2 walks chunks of CH keys: the chunk's
// exp(s - max) add to l unquantized, are quantized on the chunk's own
// absmax, and weigh the int8 V in integer sums (the block's thread groups
// split a chunk's words and add their int32 parts, exactly). Shared: Li
// scores, q as int8 words, CH int8 weights.
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    fused_cross_kernel(const float* __restrict__ q2,
                       const int8_t* __restrict__ ck,
                       const int8_t* __restrict__ cv,
                       const float* __restrict__ cks,
                       const float* __restrict__ cvs,
                       const float* __restrict__ cbias, T* att, int H, int Dh,
                       int Li, int CH, float sm_scale) {
  extern __shared__ float sm[];
  __shared__ float red[32];
  __shared__ int part[kAttnThreads];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int D = H * Dh;
  const long long bh = (long long)b * H + h;
  float* sc = sm;
  int* qw = reinterpret_cast<int*>(sc + Li);
  int8_t* pw = reinterpret_cast<int8_t*>(qw + Dh / 4);

  const float q = tid < Dh ? q2[(long long)b * D + h * Dh + tid] : 0.f;
  const float qs = quant_scale(block_max(fabsf(q), red));
  if (tid < Dh) reinterpret_cast<int8_t*>(qw)[tid] = quant(q, qs);
  __syncthreads();

  const float qscale = qs * sm_scale, kscale = cks[bh];
  const int n4 = Dh / 4;
  const int8_t* kb = ck + bh * Li * Dh;
  const float* br = cbias + (long long)b * Li;
  float m = -INFINITY;
  for (int j = tid; j < Li; j += blockDim.x) {
    const int* kr = reinterpret_cast<const int*>(kb + (long long)j * Dh);
    int acc = 0;
    for (int i = 0; i < n4; ++i) acc = __dp4a(qw[i], kr[i], acc);
    const float s = ((float)acc * qscale) * kscale + br[j];
    sc[j] = s;
    m = fmaxf(m, s);
  }
  m = block_max(m, red);

  const int nd = blockDim.x / Dh, g = tid / Dh, d = tid % Dh;
  const int8_t* vb = cv + bh * Dh * Li;
  float l = 0.f, o = 0.f;
  for (int c0 = 0; c0 < Li; c0 += CH) {
    float csum = 0.f, cmax = 0.f;
    for (int j = tid; j < CH; j += blockDim.x) {
      const float e = expf(sc[c0 + j] - m);
      sc[c0 + j] = e;
      csum += e;
      cmax = fmaxf(cmax, e);
    }
    l += block_sum(csum, red);
    const float cs = quant_scale(block_max(cmax, red));
    for (int j = tid; j < CH; j += blockDim.x) pw[j] = quant(sc[c0 + j], cs);
    __syncthreads();
    if (g < nd) {
      const int* vr = reinterpret_cast<const int*>(vb + (long long)d * Li + c0);
      const int* pr = reinterpret_cast<const int*>(pw);
      int acc = 0;
      for (int i = g; i < CH / 4; i += nd) acc = __dp4a(pr[i], vr[i], acc);
      part[tid] = acc;
    }
    __syncthreads();
    if (tid < Dh) {
      int tot = 0;
      for (int gg = 0; gg < nd; ++gg) tot += part[gg * Dh + tid];
      o += (float)tot * cs;
    }
    __syncthreads();  // pw and part are rewritten by the next chunk
  }
  if (tid < Dh)
    att[(long long)b * D + h * Dh + tid] = Elem<T>::store(o * (cvs[bh] / l));
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
                 float* x_mid, float* ws, int* counters, int B, int H, int Dh,
                 int S, int Li, int CH, int t, float sm_scale,
                 cudaStream_t s) {
  const int D = H * Dh;
  T* h = static_cast<T*>(h_buf);  // LN outputs, then attention outputs
  const dim3 grid(H, B);
  const size_t self_smem = (size_t)S * 4 + Dh + S;
  const size_t cross_smem = (size_t)Li * 4 + Dh + CH;

  layernorm_kernel<T><<<B, 128, 0, s>>>(x, ln, ln + D, h, D, D, nullptr);
  splitk_gemm<T>(h, D, wqkv, B, 3 * D, D,
                 F32Epilogue<float, kStore>{bqkv, nullptr, qkv, 3 * D}, ws,
                 counters, nullptr, s);
  fused_self_kernel<T><<<grid, kAttnThreads, self_smem, s>>>(
      qkv, kc, vc, ksc, vsc, h, nk, nv, nks, nvs, t, S, H, Dh, sm_scale);
  splitk_gemm<T>(h, D, wos, B, D, D,
                 F32Epilogue<float, kResidual>{bos, x, x_mid, D}, ws,
                 counters, nullptr, s);
  layernorm_kernel<T><<<B, 128, 0, s>>>(x_mid, ln + 2 * D, ln + 3 * D, h, D,
                                        D, nullptr);
  float* q2 = qkv;  // (B, D), the QKV rows are consumed
  splitk_gemm<T>(h, D, wqc, B, D, D,
                 F32Epilogue<float, kStore>{bqc, nullptr, q2, D}, ws,
                 counters, nullptr, s);
  fused_cross_kernel<T><<<grid, kAttnThreads, cross_smem, s>>>(
      q2, ck, cv, cks, cvs, cbias, h, H, Dh, Li, CH, sm_scale);
  splitk_gemm<T>(h, D, woc, B, D, D,
                 F32Epilogue<float, kResidual>{boc, x_mid, x_out, D}, ws,
                 counters, nullptr, s);
  return (int)cudaGetLastError();
}

template <typename T>
static int ffn(const float* x, const void* w1, const float* b1,
               const void* w2, const float* b2, const float* ln3,
               void* h_buf, float* out, float* ws, int* counters, int B,
               int D, int F, cudaStream_t s) {
  T* h = static_cast<T*>(h_buf);  // (B, D) LN3 output
  T* z = h + (long long)B * D;    // (B, F) relu(h @ w1 + b1)
  layernorm_kernel<T><<<B, 128, 0, s>>>(x, ln3, ln3 + D, h, D, D, nullptr);
  splitk_gemm<T>(h, D, w1, B, F, D, F32Epilogue<T, kRelu>{b1, nullptr, z, F},
                 ws, counters, nullptr, s);
  splitk_gemm<T>(z, F, w2, B, D, F,
                 F32Epilogue<float, kResidual>{b2, x, out, D}, ws, counters,
                 nullptr, s);
  return (int)cudaGetLastError();
}

}  // namespace plank

// The attention part of one decoder layer at step t (everything but the
// FFN): x (B, D) f32 -> x_out (B, D) f32, and the new token's int8 K/V rows
// nk, nv (B, D) with their scales nks, nvs (B, H). Weights in the compute
// dtype (is_bf16), biases and `ln` (6, D) f32; caches and cross K/V in the
// layouts above. Scratch: qkv (B, 3D) f32, h (B, D) compute dtype, x_mid
// (B, D) f32, the GEMM workspace and its zeroed counters. Launches on
// `stream`; does not synchronise.
extern "C" int plank_fused_layer(
    const float* x, const void* wqkv, const float* bqkv, const void* wos,
    const float* bos, const void* wqc, const float* bqc, const void* woc,
    const float* boc, const float* ln, const int8_t* kc, const int8_t* vc,
    const float* ksc, const float* vsc, const int8_t* ck, const int8_t* cv,
    const float* cks, const float* cvs, const float* cbias, float* x_out,
    int8_t* nk, int8_t* nv, float* nks, float* nvs, float* qkv, void* h,
    float* x_mid, float* ws, int* counters, long long B, long long H,
    long long Dh, long long S, long long Li, long long CH, long long t,
    float sm_scale, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || Dh <= 0 || Dh % 4 || Dh > plank::kAttnThreads ||
      S % 4 || Li % 4 || CH <= 0 || CH % 4 || Li % CH || t < 0 || t >= S ||
      (S + Li) * 4 > 40 * 1024)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = is_bf16 ? &plank::layer<__nv_bfloat16> : &plank::layer<float>;
  return run(x, wqkv, bqkv, wos, bos, wqc, bqc, woc, boc, ln, kc, vc, ksc,
             vsc, ck, cv, cks, cvs, cbias, x_out, nk, nv, nks, nvs, qkv, h,
             x_mid, ws, counters, (int)B, (int)H, (int)Dh, (int)S, (int)Li,
             (int)CH, (int)t, sm_scale, s);
}

// fused_ffn: out = x + relu(LN3(x) @ w1 + b1) @ w2 + b2 on x (B, D) f32;
// ln3 (2, D). Scratch: h (B, D + F) compute dtype, the GEMM workspace and
// its zeroed counters. Launches on `stream`; does not synchronise.
extern "C" int plank_fused_ffn(const float* x, const void* w1,
                               const float* b1, const void* w2,
                               const float* b2, const float* ln3, void* h,
                               float* out, float* ws, int* counters,
                               long long B, long long D, long long F,
                               int is_bf16, void* stream) {
  if (B <= 0 || D <= 0 || F <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? plank::ffn<__nv_bfloat16>(x, w1, b1, w2, b2, ln3, h, out,
                                             ws, counters, (int)B, (int)D,
                                             (int)F, s)
                 : plank::ffn<float>(x, w1, b1, w2, b2, ln3, h, out, ws,
                                     counters, (int)B, (int)D, (int)F, s);
}
