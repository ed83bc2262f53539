// One step of the greedy decode loop, as a sequence of simple kernels.
//
// Replaces: plankassembly_tpu/ops/persistent_decode.py::
// persistent_greedy_decode (Pallas kernel `_make_kernel`), which runs all
// 128 decode steps inside ONE launch on the TPU's single sequential core.
// A literal port would need every block of the grid to wait for the others
// between layers and steps; on a GPU a spin-wait over blocks that are not
// all resident deadlocks. So here the loop over steps runs on the host
// (`ops/persistent_decode.py`), and `plank_decode_step` launches, on one
// stream, kernels that each finish on their own: no grid-wide barrier, no
// cooperative launch, no flag in global memory that a block waits on.
//
// Per step: embed -> 6 x [LN -> QKV GEMM -> self-attention over the
// compute-dtype cache appended at t -> wo GEMM (+residual); LN -> cross-q
// GEMM -> cross-attention over int8 K/V (K scale folded into the scores, V
// scale into the output) -> wo GEMM (+residual); LN -> w1 GEMM (relu) ->
// w2 GEMM (+residual)] -> final LN into the f32 hidden cache -> f32 head
// GEMM (vocab | pointer | switch) -> sampling tail -> done check.
//
// What bounds it on an H100: memory, then latency. Each step must read
// the decoder weights (~12 MB in bf16 for the flagship) and the int8 cross
// K/V (L * B * Li * 2 * Dkv bytes, ~57 MB at B=32, Li=1152), and does only
// ~2 flops per weight byte per row: far below the ridge, so the floor is
// a few tens of microseconds per step. At serving batch sizes the grids
// are small and each kernel is a short chain of dependent phases, so in
// practice the step is bound by those latencies and by its ~72 launches
// (one ctypes call launches them all from C). The skinny GEMMs split K
// across blocks and cross-attention stages K/V through shared memory for
// that reason; tools/profile_torch_serve.py shows where the step's device
// time goes.
//
// Early exit without a barrier: every kernel of a step returns at once when
// the device flag `halt` is set. The last kernel of a step sets it once
// every row has emitted END, so steps after that are empty launches, and
// the host reads the flag every few steps to stop the loop. Tokens,
// trailing tokens and `num_steps` are those of the JAX while_loop.
//
// Numerics follow decode.greedy_decode(kv_quant=True, self_quant=False):
// products in the compute dtype T with f32 accumulation, each product
// rounded to T and its bias added in T; residual stream, layer norms,
// softmaxes and the heads in f32.
#include "common.cuh"

namespace plank {

// Mirrors the ctypes Structure in ops/persistent_decode.py: every field is
// 8 bytes wide, so both sides agree on the layout without padding rules.
struct DecodeArgs {
  long long B, S, D, H, kvH, Dh, F, V, L, Li, dof, end_token, is_bf16,
      early_exit;
  // compute-dtype weights, layer-stacked; projections act as x @ W
  const void *wqkv, *bqkv, *wo, *bo, *cwq, *cbq, *cwo, *cbo, *w1, *b1, *w2,
      *b2;
  const float* ln;          // (L, 6, D): norm1/2/3 scale and bias
  const float* final_ln;    // (2, D)
  const float* head_w;      // (D, V + D + 1): vocab | pointer | switch
  const float* head_b;      // (V + D + 1)
  const float* emb_value;   // (V, D)
  const float* emb_coord;   // (dof, D)
  const float* emb_pos;     // (ceil(S / dof), D)
  const float* struct_mask; // (S, S)
  const int8_t* ck;         // (L, B, Li, Dkv)
  const int8_t* cv;         // (L, B, Li, Dkv)
  const float* ck_scale;    // (L, B, kvH)
  const float* cv_scale;    // (L, B, kvH)
  const uint8_t* mem_mask;  // (B, Li), 1 = pad
  void *k_cache, *v_cache;  // (L, B, S, Dkv) T
  float* h_cache;           // (B, S, D)
  float* x;                 // (B, D) residual stream
  void* h;                  // (B, D) T, layer-norm output
  void* qkv;                // (B, D + 2 Dkv) T
  void* att;                // (B, D) T, attention output
  void* q2;                 // (B, D) T
  void* z;                  // (B, F) T
  float* head_out;          // (B, V + D + 1)
  float* gemm_ws;           // split-K partial tiles, see gemm_kernel
  int* gemm_counters;       // per output tile, zero between products
  float* attn_ws;           // cross-attention parts, see cross_attn_kernel
  int* attn_counters;       // per (row, kv head), zero between layers
  int *output, *attach, *done, *halt, *num_steps;
};

constexpr float kNegInf = -1e9f;
constexpr float kEps = 1e-6f;
constexpr int kMaxGroup = 8;  // query heads per kv head

// ---------------------------------------------------------------- embed
__global__ void embed_kernel(const float* __restrict__ value,
                             const float* __restrict__ coord,
                             const float* __restrict__ pos,
                             const int* __restrict__ output, float* x, int t,
                             int S, int D, int V, int dof, const int* halt) {
  if (*halt) return;
  const int b = blockIdx.x;
  int prev = t > 0 ? output[(long long)b * S + t - 1] : 0;
  prev = min(max(prev, 0), V - 1);
  const int c = t > 0 ? (t - 1) % dof : 0, p = t > 0 ? (t - 1) / dof : 0;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    x[(long long)b * D + d] =
        t == 0 ? 0.f
               : (value[(long long)prev * D + d] + coord[c * D + d]) +
                     pos[p * D + d];
  }
}

// ----------------------------------------------------------------- GEMM
// The split-K GEMM of common.cuh, with this loop's epilogue: the product
// rounds to T, then its bias adds in T (as x @ W + b does in the compute
// dtype), then relu, a residual add into the f32 stream, or a store.
template <typename T, typename OutT, int EPI>
struct RoundedEpilogue {
  const T* bias;
  OutT* out;
  long long ldo;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    float y = Elem<T>::round(Elem<T>::round(acc) + Elem<T>::load(bias[n]));
    if constexpr (EPI == kRelu) y = fmaxf(y, 0.f);
    OutT* dst = out + (long long)m * ldo + n;
    if constexpr (EPI == kResidual)
      *dst += y;  // OutT is float here
    else
      *dst = Elem<OutT>::store(y);
  }
};

template <typename T, typename OutT, int EPI>
static void gemm(const void* A, long long lda, const void* W,
                 const void* bias, int M, int N, int K, void* out,
                 long long ldo, float* ws, int* counters, const int* halt,
                 cudaStream_t s) {
  RoundedEpilogue<T, OutT, EPI> epi{static_cast<const T*>(bias),
                                    static_cast<OutT*>(out), ldo};
  splitk_gemm<T>(A, lda, W, M, N, K, epi, ws, counters, halt, s);
}

// ------------------------------------------------------- self-attention
// One block per (kv head c, row b): appends this step's K/V of kv head c
// at position t, then attends the G query heads of the group over keys
// 0..t (later keys are masked to -1e9 in the plain version and weigh
// exactly 0 there).
template <typename T>
__global__ void self_attn_kernel(const T* __restrict__ qkv, T* kc, T* vc,
                                 T* att, int t, int S, int D, int H, int kvH,
                                 int Dh, float scale, const int* halt) {
  extern __shared__ float sm[];
  if (*halt) return;
  const int c = blockIdx.x, b = blockIdx.y;
  const int G = H / kvH, Dkv = kvH * Dh, W = D + 2 * Dkv;
  const T* row = qkv + (long long)b * W;
  T* kb = kc + (long long)b * S * Dkv;
  T* vb = vc + (long long)b * S * Dkv;
  float* q = sm;           // G * Dh
  float* sc = sm + G * Dh;  // G * S
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    kb[(long long)t * Dkv + c * Dh + d] = row[D + c * Dh + d];
    vb[(long long)t * Dkv + c * Dh + d] = row[D + Dkv + c * Dh + d];
  }
  for (int i = threadIdx.x; i < G * Dh; i += blockDim.x)
    q[i] = Elem<T>::load(row[c * G * Dh + i]);
  __syncthreads();
  const int n = t + 1;
  for (int i = threadIdx.x; i < G * n; i += blockDim.x) {
    int g = i / n, j = i % n;
    const T* kr = kb + (long long)j * Dkv + c * Dh;
    float s = 0.f;
    for (int d = 0; d < Dh; ++d) s += q[g * Dh + d] * Elem<T>::load(kr[d]);
    sc[g * S + j] = s * scale;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int g = warp; g < G; g += nwarps) {
    float* sg = sc + g * S;
    float m = -1e30f;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, sg[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) sum += expf(sg[j] - m);
    sum = warp_sum(sum);
    __syncwarp();
    for (int j = lane; j < n; j += 32)
      sg[j] = Elem<T>::round(expf(sg[j] - m) / sum);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * Dh; i += blockDim.x) {
    int g = i / Dh, d = i % Dh;
    const float* sg = sc + g * S;
    float o = 0.f;
    for (int j = 0; j < n; ++j)
      o += sg[j] * Elem<T>::load(vb[(long long)j * Dkv + c * Dh + d]);
    att[(long long)b * D + (c * G + g) * Dh + d] = Elem<T>::store(o);
  }
}

// ------------------------------------------------------ cross-attention
// Over int8 K/V with one scale per (layer, row, kv head): scores =
// (q . k_int8) * k_scale * scale + mask bias; output = (sum_j w_j v_int8_j)
// * v_scale. One block per (kv head c, row b, split z of the keys): at
// serving batch sizes (b, c) alone gives fewer blocks than the card has
// SMs, so the keys are split in kKeyChunk-wide parts, as in split-K
// ("flash-decoding"). A block stages its part of K, then of V, in shared
// memory (8 bytes per thread per copy, rows padded by 8 bytes so a warp's
// per-key reads hit distinct banks), scores its keys for all G heads of
// the group (one thread per key), takes the part's max m and sum l of
// exp(s - m) per head, and accumulates the unnormalised output (blockDim /
// Dh groups of threads each take a strided share of the keys for all G
// heads of one column, then add up in group order). It writes (m, l, o) to
// the workspace; the last block of (b, c) to finish — it learns so from an
// atomic counter, it never waits — rescales and sums the parts in split
// order (deterministic). Unlike the plain version, the weights are not
// rounded to T before the V product: the normalisation is only known once
// all parts are in.
constexpr int kCrossThreads = 256;
constexpr int kKeyChunk = 256;

__host__ __device__ inline int cross_float_words(int G, int Dh) {
  // q, scores, per-group partial outputs; a multiple of 4 floats so the
  // int8 tile that follows is 16-byte aligned
  int n = G * Dh + G * kKeyChunk + (kCrossThreads / Dh) * G * Dh + 2 * G;
  return (n + 3) / 4 * 4;
}

static size_t cross_attn_smem(int G, int Dh) {
  return (size_t)cross_float_words(G, Dh) * sizeof(float) +
         (size_t)kKeyChunk * (Dh + 8);
}

// floats of workspace per (row, kv head, split): G x (m, l, o[Dh])
__host__ __device__ inline int cross_part_words(int G, int Dh) {
  return G * (Dh + 2);
}

template <typename T>
__global__ void __launch_bounds__(kCrossThreads)
    cross_attn_kernel(const T* __restrict__ q2, const int8_t* __restrict__ ck,
                      const int8_t* __restrict__ cv,
                      const float* __restrict__ ks,
                      const float* __restrict__ vs,
                      const uint8_t* __restrict__ mask, T* att, int Li, int D,
                      int H, int kvH, int Dh, float scale, float* ws,
                      int* counters, const int* halt) {
  extern __shared__ float sm[];
  __shared__ int is_last;
  if (*halt) return;
  const int c = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int nsplit = gridDim.z;
  const int G = H / kvH, Dkv = kvH * Dh;
  const int RS = Dh + 8;     // tile row stride, bytes
  const int units = Dh / 8;  // 8-byte units per key row
  const int j0 = z * kKeyChunk, nk = min(kKeyChunk, Li - j0);
  float* q = sm;                      // G * Dh
  float* sc = q + G * Dh;             // G * kKeyChunk
  float* psum = sc + G * kKeyChunk;   // (blockDim / Dh) * G * Dh
  float* ml = psum + (kCrossThreads / Dh) * G * Dh;  // G maxima, G sums
  int8_t* tile = reinterpret_cast<int8_t*>(sm + cross_float_words(G, Dh));
  const int8_t* kb = ck + ((long long)b * Li + j0) * Dkv + c * Dh;
  const int8_t* vb = cv + ((long long)b * Li + j0) * Dkv + c * Dh;
  const uint8_t* mb = mask + (long long)b * Li + j0;
  const float kscale = ks[b * kvH + c] * scale;

  for (int i = threadIdx.x; i < G * Dh; i += blockDim.x)
    q[i] = Elem<T>::load(q2[(long long)b * D + c * G * Dh + i]);
  for (int u = threadIdx.x; u < nk * units; u += blockDim.x) {
    const int r = u / units, p = u % units;
    *reinterpret_cast<int2*>(tile + r * RS + p * 8) =
        *reinterpret_cast<const int2*>(kb + (long long)r * Dkv + p * 8);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nk; r += blockDim.x) {
    float acc[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;
    for (int p = 0; p < units; ++p) {
      const int2 raw = *reinterpret_cast<const int2*>(tile + r * RS + p * 8);
      const int8_t* k8 = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float kval = (float)k8[e];
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < G) acc[g] += q[g * Dh + p * 8 + e] * kval;
      }
    }
    const float bias = mb[r] ? kNegInf : 0.f;
    for (int g = 0; g < G; ++g) sc[g * kKeyChunk + r] = acc[g] * kscale + bias;
  }
  __syncthreads();  // scores done, K tile free
  for (int u = threadIdx.x; u < nk * units; u += blockDim.x) {
    const int r = u / units, p = u % units;
    *reinterpret_cast<int2*>(tile + r * RS + p * 8) =
        *reinterpret_cast<const int2*>(vb + (long long)r * Dkv + p * 8);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int g = warp; g < G; g += nwarps) {
    float* sg = sc + g * kKeyChunk;
    float m = -1e30f;
    for (int j = lane; j < nk; j += 32) m = fmaxf(m, sg[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(sg[j] - m);
      sg[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ml[g] = m;
      ml[G + g] = sum;
    }
  }
  __syncthreads();  // V tile and exp weights ready
  const int groups = blockDim.x / Dh, grp = threadIdx.x / Dh,
            d = threadIdx.x % Dh;
  float o[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) o[g] = 0.f;
  for (int r = grp; r < nk; r += groups) {
    const float vj = (float)tile[r * RS + d];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < G) o[g] += sc[g * kKeyChunk + r] * vj;
  }
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
    if (g < G) psum[(grp * G + g) * Dh + d] = o[g];
  __syncthreads();

  // this part's (m, l, o) -> workspace [b][c][z][g][m, l, o[Dh]]
  const int pw = cross_part_words(G, Dh);
  float* part = ws + (((long long)b * kvH + c) * nsplit + z) * pw;
  for (int i = threadIdx.x; i < G * Dh; i += blockDim.x) {
    int g = i / Dh, dd = i % Dh;
    float sum = 0.f;
    for (int r = 0; r < groups; ++r) sum += psum[(r * G + g) * Dh + dd];
    part[g * (Dh + 2) + 2 + dd] = sum;
  }
  if (threadIdx.x < G) {
    part[threadIdx.x * (Dh + 2)] = ml[threadIdx.x];
    part[threadIdx.x * (Dh + 2) + 1] = ml[G + threadIdx.x];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(&counters[b * kvH + c], 1) == nsplit - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float vscale = vs[b * kvH + c];
  const float* parts = ws + ((long long)b * kvH + c) * nsplit * pw;
  for (int i = threadIdx.x; i < G * Dh; i += blockDim.x) {
    int g = i / Dh, dd = i % Dh;
    float mmax = -1e30f;
    for (int zz = 0; zz < nsplit; ++zz)
      mmax = fmaxf(mmax, __ldcg(&parts[zz * pw + g * (Dh + 2)]));
    float l = 0.f, acc = 0.f;
    for (int zz = 0; zz < nsplit; ++zz) {
      const float* pg = parts + zz * pw + g * (Dh + 2);
      const float w = expf(__ldcg(&pg[0]) - mmax);
      l += __ldcg(&pg[1]) * w;
      acc += __ldcg(&pg[2 + dd]) * w;
    }
    att[(long long)b * D + (c * G + g) * Dh + dd] =
        Elem<T>::store(acc / l * vscale);
  }
  if (threadIdx.x == 0) counters[b * kvH + c] = 0;  // ready for next use
}

// -------------------------------------------------------- sampling tail
// One block per row: vocab softmax, switch sigmoid, pointer logits / D
// against the hidden cache, the triu mask, the structural eps-fill, the
// first-plank vocab argmax, argmax with the first index on ties, pointer
// copy and the done flag.
__global__ void sample_kernel(const float* __restrict__ head_out,
                              const float* __restrict__ h_cache,
                              const float* __restrict__ struct_mask,
                              int* output, int* attach, int* done, int t,
                              int S, int D, int V, int dof, int end_token,
                              const int* halt) {
  __shared__ float sv[32];
  __shared__ int si[32];
  extern __shared__ float pl[];  // S pointer logits
  if (*halt) return;
  const int b = blockIdx.x;
  const int NH = V + D + 1;
  const float* row = head_out + (long long)b * NH;
  const float* feat = row + V;
  const float prob = 1.f / (1.f + expf(-row[V + D]));

  // vocab: argmax of the logits, softmax, argmax of probs * (1 - prob)
  float lv = -INFINITY;
  int li = 0x7fffffff;
  for (int v = threadIdx.x; v < V; v += blockDim.x) arg_better(lv, li, row[v], v);
  block_argmax(lv, li, sv, si);
  const float vmax = lv;
  const int vocab_idx = li;
  float s = 0.f;
  for (int v = threadIdx.x; v < V; v += blockDim.x) s += expf(row[v] - vmax);
  const float vsum = block_sum(s, sv);
  float mv = -INFINITY;
  int mi = 0x7fffffff;
  for (int v = threadIdx.x; v < V; v += blockDim.x)
    arg_better(mv, mi, expf(row[v] - vmax) / vsum * (1.f - prob), v);
  block_argmax(mv, mi, sv, si);

  // pointer logits for s < t (keys s >= t are masked by the triu bias)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int p = warp; p < t; p += nwarps) {
    const float* hr = h_cache + ((long long)b * S + p) * D;
    float dot = 0.f;
    for (int d = lane; d < D; d += 32) dot += feat[d] * hr[d];
    dot = warp_sum(dot);
    if (lane == 0) pl[p] = dot / D;
  }
  __syncthreads();
  float pm = -INFINITY;
  for (int p = threadIdx.x; p < t; p += blockDim.x) pm = fmaxf(pm, pl[p]);
  pm = block_max(pm, sv);
  float ps = 0.f;
  for (int p = threadIdx.x; p < t; p += blockDim.x) ps += expf(pl[p] - pm);
  ps = block_sum(ps, sv);
  float bp = -INFINITY;
  int bi = 0x7fffffff;
  for (int p = threadIdx.x; p <= t; p += blockDim.x) {
    // at t == 0 every key is masked and the plain softmax is uniform
    float pp = t == 0 ? 1.f / S : (p < t ? expf(pl[p] - pm) / ps : 0.f);
    pp *= prob;
    if (struct_mask[(long long)t * S + p] == 0.f) pp = kEps;
    arg_better(bp, bi, pp, p);
  }
  block_argmax(bp, bi, sv, si);

  if (threadIdx.x == 0) {
    const int mixed = bp > mv ? V + bi : mi;
    const int idx = t + 1 < dof ? vocab_idx : mixed;
    const bool is_ptr = idx >= V;
    const int ptr = min(max(idx - V, 0), S - 1);
    const int token = is_ptr ? output[(long long)b * S + ptr] : idx;
    output[(long long)b * S + t] = token;
    attach[(long long)b * S + t] = is_ptr ? ptr : -1;
    if (token == end_token) done[b] = 1;
  }
}

// One block: records that step t ran and, in early-exit mode, sets the
// halt flag once every row is done.
__global__ void done_kernel(const int* done, int* halt, int* num_steps, int t,
                            int B, int early_exit) {
  if (*halt) return;
  int all = 1;
  for (int b = threadIdx.x; b < B; b += blockDim.x) all &= done[b] != 0;
  all = __syncthreads_and(all);
  if (threadIdx.x == 0) {
    *num_steps = t + 1;
    if (early_exit && all) *halt = 1;
  }
}

template <typename T>
static int decode_step(const DecodeArgs& a, int t, cudaStream_t s) {
  const int B = (int)a.B, S = (int)a.S, D = (int)a.D, H = (int)a.H,
            kvH = (int)a.kvH, Dh = (int)a.Dh, F = (int)a.F, V = (int)a.V,
            Li = (int)a.Li;
  const int Dkv = kvH * Dh, W = D + 2 * Dkv, NH = V + D + 1, G = H / kvH;
  const float scale = 1.f / sqrtf((float)Dh);
  const int* halt = a.halt;
  const T* wqkv = static_cast<const T*>(a.wqkv);
  const T* bqkv = static_cast<const T*>(a.bqkv);
  const T* wo = static_cast<const T*>(a.wo);
  const T* bo = static_cast<const T*>(a.bo);
  const T* cwq = static_cast<const T*>(a.cwq);
  const T* cbq = static_cast<const T*>(a.cbq);
  const T* cwo = static_cast<const T*>(a.cwo);
  const T* cbo = static_cast<const T*>(a.cbo);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* b1 = static_cast<const T*>(a.b1);
  const T* w2 = static_cast<const T*>(a.w2);
  const T* b2 = static_cast<const T*>(a.b2);
  T* kc = static_cast<T*>(a.k_cache);
  T* vc = static_cast<T*>(a.v_cache);
  const size_t self_smem = (size_t)(G * Dh + G * S) * sizeof(float);
  const size_t cross_smem = cross_attn_smem(G, Dh);
  const int nsplit = (Li + kKeyChunk - 1) / kKeyChunk;

  embed_kernel<<<B, 128, 0, s>>>(a.emb_value, a.emb_coord, a.emb_pos,
                                 a.output, a.x, t, S, D, V, (int)a.dof, halt);
  for (int l = 0; l < (int)a.L; ++l) {
    const float* ln = a.ln + (long long)l * 6 * D;
    // self-attention
    layernorm_kernel<T><<<B, 128, 0, s>>>(a.x, ln, ln + D,
                                          static_cast<T*>(a.h), D, D, halt);
    gemm<T, T, kStore>(a.h, D, wqkv + (long long)l * D * W,
                       bqkv + (long long)l * W, B, W, D, a.qkv, W,
                       a.gemm_ws, a.gemm_counters, halt, s);
    self_attn_kernel<T><<<dim3(kvH, B), 256, self_smem, s>>>(
        static_cast<const T*>(a.qkv), kc + (long long)l * B * S * Dkv,
        vc + (long long)l * B * S * Dkv, static_cast<T*>(a.att), t, S, D, H,
        kvH, Dh, scale, halt);
    gemm<T, float, kResidual>(a.att, D, wo + (long long)l * D * D,
                              bo + (long long)l * D, B, D, D, a.x, D,
                              a.gemm_ws, a.gemm_counters, halt, s);
    // cross-attention
    layernorm_kernel<T><<<B, 128, 0, s>>>(a.x, ln + 2 * D, ln + 3 * D,
                                          static_cast<T*>(a.h), D, D, halt);
    gemm<T, T, kStore>(a.h, D, cwq + (long long)l * D * D,
                       cbq + (long long)l * D, B, D, D, a.q2, D,
                       a.gemm_ws, a.gemm_counters, halt, s);
    cross_attn_kernel<T><<<dim3(kvH, B, nsplit), kCrossThreads, cross_smem,
                           s>>>(
        static_cast<const T*>(a.q2), a.ck + (long long)l * B * Li * Dkv,
        a.cv + (long long)l * B * Li * Dkv, a.ck_scale + (long long)l * B * kvH,
        a.cv_scale + (long long)l * B * kvH, a.mem_mask,
        static_cast<T*>(a.att), Li, D, H, kvH, Dh, scale, a.attn_ws,
        a.attn_counters, halt);
    gemm<T, float, kResidual>(a.att, D, cwo + (long long)l * D * D,
                              cbo + (long long)l * D, B, D, D, a.x, D,
                              a.gemm_ws, a.gemm_counters, halt, s);
    // feed-forward
    layernorm_kernel<T><<<B, 128, 0, s>>>(a.x, ln + 4 * D, ln + 5 * D,
                                          static_cast<T*>(a.h), D, D, halt);
    gemm<T, T, kRelu>(a.h, D, w1 + (long long)l * D * F,
                      b1 + (long long)l * F, B, F, D, a.z, F,
                      a.gemm_ws, a.gemm_counters, halt, s);
    gemm<T, float, kResidual>(a.z, F, w2 + (long long)l * F * D,
                              b2 + (long long)l * D, B, D, F, a.x, D,
                              a.gemm_ws, a.gemm_counters, halt, s);
  }
  // final norm straight into the f32 hidden cache at column t
  layernorm_kernel<float><<<B, 128, 0, s>>>(
      a.x, a.final_ln, a.final_ln + D, a.h_cache + (long long)t * D,
      (long long)S * D, D, halt);
  gemm<float, float, kStore>(a.h_cache + (long long)t * D, (long long)S * D,
                             a.head_w, a.head_b, B, NH, D, a.head_out, NH,
                             a.gemm_ws, a.gemm_counters, halt, s);
  sample_kernel<<<B, 256, S * sizeof(float), s>>>(
      a.head_out, a.h_cache, a.struct_mask, a.output, a.attach, a.done, t, S,
      D, V, (int)a.dof, (int)a.end_token, halt);
  done_kernel<<<1, 256, 0, s>>>(a.done, a.halt, a.num_steps, t, B,
                                (int)a.early_exit);
  return (int)cudaGetLastError();
}

template <typename T>
static int setup(const DecodeArgs& a) {
  const int G = (int)(a.H / a.kvH);
  const size_t cross_smem = cross_attn_smem(G, (int)a.Dh);
  const size_t self_smem = (size_t)(G * a.Dh + G * a.S) * sizeof(float);
  if (cross_smem > 48 * 1024)
    cudaFuncSetAttribute(cross_attn_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)cross_smem);
  if (self_smem > 48 * 1024)
    cudaFuncSetAttribute(self_attn_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)self_smem);
  return (int)cudaGetLastError();
}

static bool valid(const DecodeArgs& a) {
  return a.kvH > 0 && a.H % a.kvH == 0 && a.H / a.kvH <= kMaxGroup &&
         a.Dh % 8 == 0 && a.Dh / 8 <= 32 && 32 % (a.Dh / 8) == 0 &&
         a.D == a.H * a.Dh;
}

}  // namespace plank

// Once per decode call, before the first step: raises the dynamic shared
// memory limit where a long memory needs more than 48 KB.
extern "C" int plank_decode_setup(const void* args) {
  const plank::DecodeArgs& a = *static_cast<const plank::DecodeArgs*>(args);
  if (!plank::valid(a)) return cudaErrorInvalidValue;
  return a.is_bf16 ? plank::setup<__nv_bfloat16>(a) : plank::setup<float>(a);
}

// Launches every kernel of decode step t on `stream`; does not synchronise.
extern "C" int plank_decode_step(const void* args, long long t, void* stream) {
  const plank::DecodeArgs& a = *static_cast<const plank::DecodeArgs*>(args);
  if (!plank::valid(a) || t < 0 || t >= a.S) return cudaErrorInvalidValue;
  if (a.B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.is_bf16 ? plank::decode_step<__nv_bfloat16>(a, (int)t, s)
                   : plank::decode_step<float>(a, (int)t, s);
}
