// The greedy decode loop, captured as a CUDA graph of CHECK_EVERY steps
// on a shape's first call, kept with the shape's stream, events and plan
// for its later calls (`State`), and replayed until every row is done.
// Two routes, which the caller chooses (`step`, from
// plank_decode_step_plan): one kernel a step (bf16, where the card holds
// every cluster of the step's plan at once; csrc/decode_step.cu), or a
// chain of 52 kernels a step (f32, and bf16 past one wave), here. Each is
// the faster on its side: the step's time grows with its rows a cluster
// and, past one wave, with the waves, while the chain's kernels spread a
// large batch over every SM (on an H100 the step is the faster up to
// B=128, the chain from B=160). What the two share is in
// csrc/decode_common.cuh.
//
// Replaces: plankassembly_tpu/ops/persistent_decode.py::
// persistent_greedy_decode (Pallas kernel `_make_kernel`), which runs all
// S decode steps inside ONE launch on the TPU's single sequential core.
//
// Why the loop stays host-driven: a literal port would make every block
// of a grid wait for the others between layers and steps, and on a GPU a
// spin-wait on blocks that are not all resident deadlocks. So no kernel
// here waits on a block outside its own thread-block cluster, whose
// blocks the hardware schedules together: each launch follows the
// previous one in stream order, and the only barriers inside a kernel are
// a block's and its cluster's. The step number lives in device memory
// (`num_steps`), read by every kernel and advanced by the step's last
// one, so one captured graph serves every step.
//
// What bounds a step on an H100: latency, not bytes. A step reads the
// bf16 decoder weights (2.23 M per layer x 6 = 26.7 MB), the f32 heads
// (2.1 MB), which fit together in the 50 MB L2, and the int8 cross K/V of
// the real keys (L * B * Li * 2 * Dkv bytes for the whole bucket: 113 MB
// at B=64, Li=1152, 2 kv heads of 64; the drawings fill ~45% of it), with
// ~2 flops a weight byte per row, far below the ridge.
//
// The chain: 8 kernels a layer and 4 after the layers: 6 x [QKV GEMM
// (LN1 in its prologue; its epilogue writes this step's K/V into the self
// cache) -> self-attention over keys 0..t -> wo GEMM (+residual) ->
// cross-q GEMM (LN2 in its prologue) -> cross-attention over int8 K/V ->
// cross wo GEMM (+residual) -> w1 GEMM (LN3 in its prologue, relu) -> w2
// GEMM (+residual)] -> final LN into the f32 hidden cache -> f32 head GEMM
// (vocab | pointer | switch) -> pointer logits -> sampling, which also
// embeds the sampled token as the next step's input and, in its last
// block, advances the step and sets the halt flag:
//
// - Products: csrc/gemm_mma.cuh's split-K cluster GEMM (partials added in
//   distributed shared memory), the layer norms in the prologues of QKV,
//   cross-q and w1. bf16 products run on mma.sync, every f32 product in
//   the SIMT GEMM's order of f32 sums.
//   The head (N = V + D + 1) has its weights padded to a multiple of 32
//   columns; its epilogue drops the pad.
// - Cross-attention (GQA): a cluster of up to kCrossRanks blocks per (row,
//   kv head); spans of kSpan keys dealt round robin to the ranks; a span
//   with no real key (any mask) skipped without reading its K/V; 16-byte
//   cp.async in two stages; each K/V span read once for all G query heads
//   of the group (a warp each); the ranks' (m, l, o) combined in rank
//   order through distributed shared memory.
// - Self-attention: one block per (row, kv head), keys 0..t of the
//   compute-dtype cache staged once for the group by 16-byte cp.async, one
//   warp per query head of the group.
// - Pointer logits: one warp per (row, key), so that the hidden cache
//   streams through every SM; the sampling kernel reads them.
// - Each kernel is a programmatic dependent launch: it starts while the
//   previous one ends, issues what needs no earlier result (a GEMM's
//   weights), then waits for the previous kernel (griddepcontrol.wait)
//   before it reads anything else.
//
// The step kernel repeats the chain's arithmetic phase by phase (its
// products' K slices are the chain's split-K slices, added in the same
// order; the other phases lane for lane), so it gives the bits the bf16
// chain gives.
//
// Early exit without a barrier: every kernel returns at once when the
// device flag `halt` is set, once every row has emitted END (early_exit)
// or the last step ran, so the steps of a replay after that are empty
// launches. Tokens, trailing tokens, `num_steps` and the zero hidden
// columns after `num_steps` are those of the JAX while_loop.
//
// Numerics follow decode.greedy_decode(kv_quant=True, self_quant=False):
// products in the compute dtype T with f32 accumulation, each product
// rounded to T and its bias added in T; residual stream, layer norms,
// softmaxes and the heads in f32. int8 cross K/V with one scale per
// (layer, row, kv head): the K scale folds into the scores, the V scale
// into the output.
#include <chrono>
#include <new>
#include <type_traits>
#include <vector>

#include "decode_common.cuh"

namespace plank {

constexpr int kMaxGroup = 8;  // query heads per kv head

// ----------------------------------------------------------------- GEMM
// The epilogues of this loop's products (gemm_mma.cuh's kernel calls them
// once per output): the product rounds to T, then its bias adds in T (as
// x @ W + b does in the compute dtype), then relu, a residual add into
// the f32 stream, or a store; outputs at n >= n_end (the head's pad) are
// dropped. Their `halt` member marks them as this loop's: the GEMM then
// follows the previous kernel and returns at once while `halt` is set
// (gemm_mma.cuh's Halts).
template <typename T, typename OutT, int EPI>
struct RoundedEpilogue {
  const T* bias;
  OutT* out;
  long long ldo;
  int n_end;
  const int* halt;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    if (n >= n_end) return;
    float y = Elem<T>::round(Elem<T>::round(acc) + Elem<T>::load(bias[n]));
    if constexpr (EPI == kRelu) y = fmaxf(y, 0.f);
    OutT* dst = out + (long long)m * ldo + n;
    if constexpr (EPI == kResidual)
      *dst += y;  // OutT is float here
    else
      *dst = Elem<OutT>::store(y);
  }
};

// QKV: the query to `q`, this step's K and V straight into the self cache
// at the step (columns [D, D + Dkv) and [D + Dkv, D + 2 Dkv)).
template <typename T>
struct QkvEpilogue {
  const T* bias;
  T* q;
  T* kc;  // this layer's (B, S, Dkv)
  T* vc;
  int D, Dkv, S;
  const int* step;
  const int* halt;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    const T y = Elem<T>::store(
        Elem<T>::round(Elem<T>::round(acc) + Elem<T>::load(bias[n])));
    if (n < D) {
      q[(long long)m * D + n] = y;
      return;
    }
    const int c = n - D;
    T* cache = c < Dkv ? kc : vc;
    cache[((long long)m * S + *step) * Dkv + c % Dkv] = y;
  }
};

// One product of the chain: A (M x K, T) or, with LN, LayerNorm(x) of the
// f32 stream with `ln_p` = (scale, bias); bf16 on mma.sync, f32 in the
// SIMT GEMM's order; overlapping the previous kernel's end.
template <typename T, bool LN, typename Epi>
static int product(const float* x, const float* ln_p, const void* A,
                   const void* W, int M, int N, int K, Epi epi,
                   cudaStream_t s) {
  constexpr bool kTC = std::is_same<T, __nv_bfloat16>::value;
  const gemm::LnArgs ln{x, ln_p, ln_p == nullptr ? nullptr : ln_p + K};
  return gemm::cluster_gemm<kTC, T, LN>(A, K, ln, W, M, N, K, epi, s, true);
}

// A kernel of the loop without a cluster on `s`, overlapping the previous
// kernel's end
template <typename... Params, typename... Args>
static int launch(void (*kernel)(Params...), dim3 grid, int threads,
                  size_t smem, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// ------------------------------------------------------- self-attention
// dynamic shared memory of the self kernel, bytes: K and V rows 0..S-1
// (padded), the group's queries and scores
template <typename T>
__host__ __device__ inline size_t self_smem(int G, int S, int Dh) {
  return (size_t)2 * S * (Dh + 16 / sizeof(T)) * sizeof(T) +
         (size_t)4 * G * (Dh + S);
}

// One block per (kv head c, row b), one warp per query head c * G + g of
// the group, over keys 0..t of the compute-dtype cache (this step's K/V
// are in it already; later keys are masked to -1e9 in the plain version
// and weigh exactly 0 there). The block stages keys 0..t of kv head c's K
// and V into shared memory once for the group, by 16-byte cp.async all in
// flight at once (rows padded by 16 bytes, so that lanes on different
// keys read different banks); then a warp scores its head with one lane
// per key, takes the softmax, rounds the weights to T (as the plain
// version) and adds p . V with one lane per column. Each score adds its
// Dh products in order and each output its t + 1 terms in order.
template <typename T>
__global__ void __launch_bounds__(32 * kMaxGroup)
    self_attn_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                     const T* __restrict__ vc, T* att, int S, int D, int kvH,
                     int Dh, float scale, const int* step, const int* halt) {
  extern __shared__ __align__(16) unsigned char smem[];
  follow_previous();
  if (*halt) return;
  constexpr int E = 16 / sizeof(T);
  const int t = *step, n = t + 1;
  const int c = blockIdx.x, b = blockIdx.y, G = blockDim.x / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Dkv = kvH * Dh, P = Dh / E, RS = Dh + E;
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + (size_t)S * RS;
  float* qs = reinterpret_cast<float*>(Vs + (size_t)S * RS);  // G x Dh
  float* sc = qs + G * Dh;                                    // G x S
  const T* kb = kc + (long long)b * S * Dkv + c * Dh;
  const T* vb = vc + (long long)b * S * Dkv + c * Dh;
  for (int i = tid; i < n * P; i += blockDim.x) {
    const int j = i / P, p = i % P;
    attn::cp_async16(Ks + j * RS + p * E, kb + (long long)j * Dkv + p * E,
                     16);
    attn::cp_async16(Vs + j * RS + p * E, vb + (long long)j * Dkv + p * E,
                     16);
  }
  attn::cp_async_commit();
  for (int i = tid; i < G * Dh; i += blockDim.x)
    qs[i] = Elem<T>::load(q[(long long)b * D + c * G * Dh + i]);
  attn::cp_async_wait<0>();
  __syncthreads();
  const int h = c * G + warp;
  const float* qw = qs + warp * Dh;
  float* sw = sc + warp * S;
  for (int j = lane; j < n; j += 32) {
    const T* kr = Ks + j * RS;
    float s = 0.f;
    for (int p = 0; p < P; ++p) {
      float kf[E];
      load16(kr + p * E, kf);
#pragma unroll
      for (int e = 0; e < E; ++e) s += qw[p * E + e] * kf[e];
    }
    sw[j] = s * scale;
  }
  __syncwarp();
  float m = -INFINITY;
  for (int j = lane; j < n; j += 32) m = fmaxf(m, sw[j]);
  m = warp_max(m);
  float sum = 0.f;
  for (int j = lane; j < n; j += 32) sum += expf(sw[j] - m);
  sum = warp_sum(sum);
  for (int j = lane; j < n; j += 32)
    sw[j] = Elem<T>::round(expf(sw[j] - m) / sum);
  __syncwarp();
  for (int d = lane; d < Dh; d += 32) {
    float o = 0.f;
    for (int j = 0; j < n; ++j) o += sw[j] * Elem<T>::load(Vs[j * RS + d]);
    att[(long long)b * D + h * Dh + d] = Elem<T>::store(o);
  }
}

// ------------------------------------------------------ cross-attention
// Over int8 K/V with one scale per (layer, row, kv head): scores =
// (q . k_int8) * k_scale * scale + mask bias; output = (sum_j p_j
// v_int8_j) / l * v_scale, for the G query heads of kv head c.
//
// One cluster of CL = min(kCrossRanks, spans) blocks per (kv head c, row
// b): grid (CL, kvH, B), a block of one warp per query head of the group.
// Rank r takes the spans r, r + CL, ... of kSpan keys (a padded row keeps
// its real keys in the first spans, so every rank gets a share). Each
// rank reads the row's mask bytes first; a span with no real key is
// skipped, without reading its K/V, when the row has a real key. Exact: a
// masked key's score lies ~1e9 below the row's best real score, so its
// weight exp(s - m) is exactly 0 in f32; a row with no real key keeps the
// full average over its Li keys, as the plain version.
//
// The block stages its spans' K and V with 16-byte cp.async, the next
// span's copy in flight while one is used (two stages; rows padded by 16
// bytes, so that lanes on different keys read different banks): each K/V
// span is read from device memory once for the whole group. Warp g then
// runs query head g over the span: one lane per key for the scores (its
// query in registers), an online softmax over the rank's spans, for p . V
// one lane per 8 columns and every (32 / (Dh / 8))-th key. Combine: rank
// r finishes its share of the G * Dh outputs by adding the ranks' (m, l,
// o) in rank order, each exp(m - M) weighted, through distributed shared
// memory: deterministic, no workspace or atomics in device memory. Unlike
// the plain version, the weights are not rounded to T before the V
// product (the normalisation is known only once all spans are in).
constexpr int kCrossStages = 2;
constexpr int kMaxSpansPerRank = 64;  // bits of a rank's span mask

// dynamic shared memory of the cross kernel, bytes: the stages of K and V
// (padded rows), each head's span of weights, (m, l, o) of each head (read
// by the other ranks), the mask bytes of the rank's spans
__host__ __device__ inline size_t cross_smem(int G, int Dh, int mine) {
  return (size_t)kCrossStages * 2 * kSpan * (Dh + 16) +
         (size_t)4 * G * (kSpan + Dh + 2) + (size_t)mine * kSpan;
}

// the 16 int8 of a 16-byte piece as floats (exact)
__device__ __forceinline__ void int8x16(const int4& raw, float (&f)[16]) {
  const unsigned w[4] = {(unsigned)raw.x, (unsigned)raw.y, (unsigned)raw.z,
                         (unsigned)raw.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = (float)((int)(w[i / 4] << (24 - 8 * (i % 4))) >> 24);
}

// kDh: the head dim (32, 64 or 128), so that a lane's query and columns
// sit in registers
template <typename T, int kDh>
__global__ void __launch_bounds__(32 * kMaxGroup)
    cross_attn_kernel(const T* __restrict__ q2, const int8_t* __restrict__ ck,
                      const int8_t* __restrict__ cv,
                      const float* __restrict__ ks,
                      const float* __restrict__ vs,
                      const uint8_t* __restrict__ mask, T* att, int Li, int D,
                      int kvH, float scale, const int* halt) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long real_mask;
  follow_previous();
  if (*halt) return;      // the same for every rank of the cluster
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int Dh = kDh, P = kDh / 16, RS = kDh + 16;  // pieces, row bytes
  constexpr int kCG = kDh / 8, kKG = 32 / kCG;  // column, key groups
  const int rank = (int)cluster.block_rank(), CL = (int)cluster.num_blocks();
  const int c = blockIdx.y, b = blockIdx.z, G = blockDim.x / 32;
  const int tid = threadIdx.x, lane = tid & 31, g = tid >> 5;
  const int Dkv = kvH * Dh;
  const int nsp = (Li + kSpan - 1) / kSpan;
  const int mine = rank < nsp ? (nsp - rank + CL - 1) / CL : 0;
  int8_t* stage = reinterpret_cast<int8_t*>(smem);  // [stage][K, V][key]
  float* sc = reinterpret_cast<float*>(stage + kCrossStages * 2 * kSpan * RS);
  float* sw = sc + g * kSpan;            // this head's weights
  float* x_ml = sc + G * kSpan;          // [2 G]: each head's m, l
  float* x_o = x_ml + 2 * G;             // [G Dh]: each head's o
  uint8_t* smask = reinterpret_cast<uint8_t*>(x_o + G * Dh);
  const uint8_t* mrow = mask + (long long)b * Li;
  const long long base = (long long)b * Li * Dkv + c * Dh;

  // 1. the row's mask: whether it has a real key, and which of this
  // rank's spans have one (each rank reads the whole row, so that no rank
  // waits on another here)
  if (tid == 0) real_mask = 0;
  __syncthreads();
  unsigned long long bits = 0;
  int any = 0;
  for (int key = tid; key < mine * CL * kSpan; key += blockDim.x) {
    const int z = key / kSpan;
    const uint8_t pad = key < Li ? mrow[key] : 1;
    any |= !pad;
    if (z % CL == rank) {
      smask[z / CL * kSpan + key % kSpan] = pad;
      if (!pad) bits |= 1ull << (z / CL);
    }
  }
  for (int key = mine * CL * kSpan + tid; key < Li; key += blockDim.x)
    any |= !mrow[key];
  const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)bits);
  const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(bits >> 32));
  if (lane == 0 && (lo | hi))
    atomicOr(&real_mask, (unsigned long long)hi << 32 | lo);
  any = __syncthreads_or(any);
  // no real key in the row: every span, as the plain version
  unsigned long long to_issue =
      any ? real_mask : (mine == 64 ? ~0ull : (1ull << mine) - 1);
  const unsigned long long todo = to_issue;

  // copies of the rank's next span still to be issued, by the whole block
  // (one group per call; an empty group once every span is issued)
  int issued = 0;
  auto issue_next = [&]() {
    if (to_issue) {
      const int i = __ffsll((long long)to_issue) - 1;
      to_issue &= to_issue - 1;
      const int j0 = (rank + i * CL) * kSpan, n = min(kSpan, Li - j0);
      int8_t* Ks = stage + (issued % kCrossStages) * 2 * kSpan * RS;
      int8_t* Vs = Ks + kSpan * RS;
      for (int p = tid; p < n * P; p += blockDim.x) {
        const int j = p / P, pc = (p % P) * 16;
        const long long off = base + (long long)(j0 + j) * Dkv + pc;
        attn::cp_async16(Ks + j * RS + pc, ck + off, 16);
        attn::cp_async16(Vs + j * RS + pc, cv + off, 16);
      }
      ++issued;
    }
    attn::cp_async_commit();
  };
  for (int st = 0; st < kCrossStages - 1; ++st) issue_next();

  // 2. warp g: query head c * G + g over the rank's spans, an online
  // softmax; a lane on keys `lane` and `lane + 32` of a span for the
  // scores (each dot as two chains, the even and the odd 16-byte pieces);
  // for p . V on 8 adjacent columns and every kKG-th key, the kKG key
  // groups' sums added by shuffles at the end
  constexpr int E = 16 / sizeof(T);
  float qf[kDh];
  const T* qrow = q2 + (long long)b * D + (c * G + g) * Dh;
#pragma unroll
  for (int d = 0; d < kDh; d += E) {
    float piece[E];
    load16(qrow + d, piece);
#pragma unroll
    for (int e = 0; e < E; ++e) qf[d + e] = piece[e];
  }
  const float kscale = ks[b * kvH + c] * scale;
  const int col0 = lane % kCG * 8, kg = lane / kCG;
  float m_run = -INFINITY, l_run = 0.f, acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  unsigned long long left = todo;
  for (int done = 0; left; ++done) {
    const int cur = __ffsll((long long)left) - 1;
    left &= left - 1;
    issue_next();
    attn::cp_async_wait<kCrossStages - 1>();  // span `done` has landed
    __syncthreads();
    const int j0 = (rank + cur * CL) * kSpan, n = min(kSpan, Li - j0);
    const int8_t* Ks = stage + (done % kCrossStages) * 2 * kSpan * RS;
    const int8_t* Vs = Ks + kSpan * RS;
    const uint8_t* mk = smask + cur * kSpan;
    float dot[2][2] = {};  // [key][even, odd pieces]
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // a key past the span reads the span's last row, and is dropped
        const int j = min(lane + 32 * h, n - 1);
        float kf[16];
        int8x16(*reinterpret_cast<const int4*>(Ks + j * RS + p * 16), kf);
#pragma unroll
        for (int e = 0; e < 16; ++e) dot[h][p & 1] += qf[p * 16 + e] * kf[e];
      }
    float s[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      s[h] = j < n ? (dot[h][0] + dot[h][1]) * kscale +
                         (mk[j] ? kNegInf : 0.f)
                   : -INFINITY;
    }
    const float m_new = fmaxf(m_run, warp_max(fmaxf(s[0], s[1])));
    const float alpha = expf(m_run - m_new);  // 0 for the first span
    m_run = m_new;
    l_run *= alpha;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      if (j < n) {
        const float e = expf(s[h] - m_new);
        sw[j] = e;
        l_run += e;
      }
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] *= alpha;
    for (int j = kg; j < n; j += kKG) {
      const float p = sw[j];
      const int2 raw = *reinterpret_cast<const int2*>(Vs + j * RS + col0);
      const unsigned w[2] = {(unsigned)raw.x, (unsigned)raw.y};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[e] += p * (float)((int)(w[e / 4] << (24 - 8 * (e % 4))) >> 24);
    }
    __syncthreads();  // this stage is rewritten by the next copy
  }
  const float l_sum = warp_sum(l_run);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    for (int o = kCG; o < 32; o <<= 1)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  if (kg == 0)
#pragma unroll
    for (int e = 0; e < 8; ++e) x_o[g * Dh + col0 + e] = acc[e];
  if (lane == 0) {
    x_ml[g] = m_run;
    x_ml[G + g] = l_sum;
  }
  cluster.sync();

  // 3. rank r finishes outputs r * blockDim + tid, ... of the group: the
  // ranks' partials added in rank order
  const float vscale = vs[b * kvH + c];
  for (int i = rank * blockDim.x + tid; i < G * Dh; i += CL * blockDim.x) {
    const int h = i / Dh;
    float M = -INFINITY;
    for (int r = 0; r < CL; ++r)
      M = fmaxf(M, cluster.map_shared_rank(x_ml, r)[h]);
    float num = 0.f, den = 0.f;
    for (int r = 0; r < CL; ++r) {
      const float* ml = cluster.map_shared_rank(x_ml, r);
      if (ml[h] == -INFINITY) continue;
      const float f = expf(ml[h] - M);
      den += f * ml[G + h];
      num += f * cluster.map_shared_rank(x_o, r)[i];
    }
    att[(long long)b * D + c * G * Dh + i] = Elem<T>::store(num / den * vscale);
  }
  cluster.sync();  // the other ranks' shared memory stays until read
}

// fn(the cross kernel's instance for head dim Dh: 32, 64 or 128)
template <typename T, typename Fn>
static int with_cross_kernel(int Dh, Fn&& fn) {
  if (Dh == 32) return fn(cross_attn_kernel<T, 32>);
  if (Dh == 64) return fn(cross_attn_kernel<T, 64>);
  return fn(cross_attn_kernel<T, 128>);
}

template <typename T>
static int launch_cross(const DecodeArgs& a, int l, float scale,
                        cudaStream_t s) {
  const int B = (int)a.B, Li = (int)a.Li, D = (int)a.D, kvH = (int)a.kvH,
            Dh = (int)a.Dh, G = (int)(a.H / a.kvH), Dkv = kvH * Dh;
  int CL;
  const int npr = spans_per_rank(Li, CL);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, kvH, B);
  cfg.blockDim = dim3(32 * G);
  cfg.dynamicSmemBytes = cross_smem(G, Dh, npr);
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const long long kv = (long long)l * B * Li * Dkv, sc = (long long)l * B * kvH;
  return with_cross_kernel<T>(Dh, [&](auto kernel) {
    return (int)cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const T*>(a.q2), a.ck + kv, a.cv + kv,
        a.ck_scale + sc, a.cv_scale + sc, a.mem_mask, static_cast<T*>(a.att),
        Li, D, kvH, scale, static_cast<const int*>(a.halt));
  });
}

// ---------------------------------------------------------- final norm
// One block of 128 threads per row: the final LayerNorm of the stream,
// into the hidden cache at the step and into `hf` for the head. The same
// f32 operations in the same order as gemm_mma.cuh's LayerNorm prologue
// (thread t adds x[t], x[t + 128], ...; warp butterflies; warps in
// order).
__global__ void __launch_bounds__(128)
    final_norm_kernel(const float* __restrict__ x,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, float* h_cache,
                      float* hf, int S, int D, const int* step,
                      const int* halt) {
  __shared__ float scratch[32];
  follow_previous();
  if (*halt) return;
  const int b = blockIdx.x, t = *step;
  const float* xr = x + (long long)b * D;
  float s = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) s += xr[d];
  const float mean = block_sum(s, scratch) / D;
  float v = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float c = xr[d] - mean;
    v += c * c;
  }
  const float var = block_sum(v, scratch) / D;
  const float inv = 1.f / sqrtf(var + 1e-5f);
  float* hc = h_cache + ((long long)b * S + t) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float y = (xr[d] - mean) * inv * scale[d] + bias[d];
    hc[d] = y;
    hf[(long long)b * D + d] = y;
  }
}

// ------------------------------------------------------ pointer logits
// feat . h_cache[b, p] / D for the keys p < t of step t, feat = the
// pointer head's output (columns V..V+D of the head): one warp per key,
// kPtrKeys keys a block, so that the hidden cache's rows stream through
// every SM. A lane adds its d = lane, lane + 32, ... in order, the loads
// all in flight; then the warp's butterfly.
constexpr int kPtrKeys = 8;

__global__ void __launch_bounds__(32 * kPtrKeys)
    pointer_kernel(const float* __restrict__ head_out,
                   const float* __restrict__ h_cache, float* ptr, int S,
                   int D, int V, const int* step, const int* halt) {
  follow_previous();
  if (*halt) return;
  const int t = *step, b = blockIdx.y, lane = threadIdx.x & 31;
  const int p = blockIdx.x * kPtrKeys + (threadIdx.x >> 5);
  if (p >= t) return;
  const float* feat = head_out + (long long)b * (V + D + 1) + V;
  const float* hr = h_cache + ((long long)b * S + p) * D;
  float dot = 0.f;
#pragma unroll 16
  for (int d = lane; d < D; d += 32) dot += feat[d] * hr[d];
  dot = warp_sum(dot);
  if (lane == 0) ptr[(long long)b * S + p] = dot / D;
}

// -------------------------------------------------------- sampling tail
// One block per row: vocab softmax, switch sigmoid, the pointer logits'
// softmax, the triu mask, the structural eps-fill, the
// first-plank vocab argmax, argmax with the first index on ties, pointer
// copy and the done flag; then the embedding of the sampled token as the
// row's input to the next step. The last block to finish (an atomic
// counter, which it resets; it never waits) advances the step and sets
// `halt` once every row is done (early exit) or the last step ran.
__global__ void __launch_bounds__(256) sample_kernel(const DecodeArgs a) {
  __shared__ float sv[32];
  __shared__ int si[32];
  __shared__ int tok, is_last;
  follow_previous();
  if (*a.halt) return;
  const int S = (int)a.S, D = (int)a.D, V = (int)a.V, dof = (int)a.dof;
  const int b = blockIdx.x, t = *a.num_steps;
  const int NH = V + D + 1;
  const float* row = a.head_out + (long long)b * NH;
  const float prob = 1.f / (1.f + expf(-row[V + D]));

  // vocab: argmax of the logits, softmax, argmax of probs * (1 - prob)
  float lv = -INFINITY;
  int li = 0x7fffffff;
  for (int v = threadIdx.x; v < V; v += blockDim.x)
    arg_better(lv, li, row[v], v);
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

  // the pointer logits of keys s < t (keys s >= t are masked by the triu
  // bias)
  const float* pl = a.ptr + (long long)b * S;
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
    if (a.struct_mask[(long long)t * S + p] == 0.f) pp = kEps;
    arg_better(bp, bi, pp, p);
  }
  block_argmax(bp, bi, sv, si);

  if (threadIdx.x == 0) {
    const int mixed = bp > mv ? V + bi : mi;
    const int idx = t + 1 < dof ? vocab_idx : mixed;
    const bool is_ptr = idx >= V;
    const int ptr = min(max(idx - V, 0), S - 1);
    const int token = is_ptr ? a.output[(long long)b * S + ptr] : idx;
    a.output[(long long)b * S + t] = token;
    a.attach[(long long)b * S + t] = is_ptr ? ptr : -1;
    if (token == a.end_token) a.done[b] = 1;
    tok = token;
  }
  __syncthreads();
  // the next step's input: value[token] + coord[t % dof] + pos[t / dof]
  const int prev = min(max(tok, 0), V - 1), ci = t % dof, pi = t / dof;
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    a.x[(long long)b * D + d] = (a.emb_value[(long long)prev * D + d] +
                                 a.emb_coord[ci * D + d]) +
                                a.emb_pos[pi * D + d];

  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(a.counter, 1) == (int)a.B - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  int all = 1;
  for (int r = threadIdx.x; r < (int)a.B; r += blockDim.x)
    all &= __ldcg(&a.done[r]) != 0;
  all = __syncthreads_and(all);
  if (threadIdx.x == 0) {
    *a.counter = 0;
    *a.num_steps = t + 1;
    if ((a.early_exit && all) || t + 1 == S) *a.halt = 1;
  }
}

// ------------------------------------------------------- one step, chained
template <typename T>
static int launch_step(const DecodeArgs& a, cudaStream_t s) {
  const int B = (int)a.B, S = (int)a.S, D = (int)a.D, H = (int)a.H,
            kvH = (int)a.kvH, Dh = (int)a.Dh, F = (int)a.F, V = (int)a.V;
  const int Dkv = kvH * Dh, W = D + 2 * Dkv, NH = V + D + 1, G = H / kvH;
  const int NHp = (NH + gemm::kBN - 1) / gemm::kBN * gemm::kBN;
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
  T* q = static_cast<T*>(a.q);
  T* att = static_cast<T*>(a.att);
  T* q2 = static_cast<T*>(a.q2);
  T* z = static_cast<T*>(a.z);
  int e;
  for (int l = 0; l < (int)a.L; ++l) {
    const float* ln = a.ln + (long long)l * 6 * D;
    const long long cache = (long long)l * B * S * Dkv;
    // self-attention
    e = product<T, true>(a.x, ln, nullptr,
                         wqkv + (long long)l * D * W, B, W, D,
                         QkvEpilogue<T>{bqkv + (long long)l * W, q,
                                        kc + cache, vc + cache, D, Dkv, S,
                                        a.num_steps, halt},
                         s);
    if (e) return e;
    e = launch(self_attn_kernel<T>, dim3(kvH, B), 32 * G,
               self_smem<T>(G, S, Dh), s, (const T*)q, (const T*)(kc + cache),
               (const T*)(vc + cache), att, S, D, kvH, Dh, scale,
               (const int*)a.num_steps, halt);
    if (e) return e;
    e = product<T, false>(nullptr, nullptr, att,
                          wo + (long long)l * D * D, B, D, D,
                          RoundedEpilogue<T, float, kResidual>{
                              bo + (long long)l * D, a.x, D, D, halt},
                          s);
    if (e) return e;
    // cross-attention
    e = product<T, true>(a.x, ln + 2 * D, nullptr,
                         cwq + (long long)l * D * D, B, D, D,
                         RoundedEpilogue<T, T, kStore>{
                             cbq + (long long)l * D, q2, D, D, halt},
                         s);
    if (e) return e;
    if ((e = launch_cross<T>(a, l, scale, s))) return e;
    e = product<T, false>(nullptr, nullptr, att,
                          cwo + (long long)l * D * D, B, D, D,
                          RoundedEpilogue<T, float, kResidual>{
                              cbo + (long long)l * D, a.x, D, D, halt},
                          s);
    if (e) return e;
    // feed-forward
    e = product<T, true>(a.x, ln + 4 * D, nullptr,
                         w1 + (long long)l * D * F, B, F, D,
                         RoundedEpilogue<T, T, kRelu>{b1 + (long long)l * F,
                                                      z, F, F, halt},
                         s);
    if (e) return e;
    e = product<T, false>(nullptr, nullptr, z,
                          w2 + (long long)l * F * D, B, D, F,
                          RoundedEpilogue<T, float, kResidual>{
                              b2 + (long long)l * D, a.x, D, D, halt},
                          s);
    if (e) return e;
  }
  e = launch(final_norm_kernel, dim3(B), 128, 0, s, (const float*)a.x,
             a.final_ln, a.final_ln + D, a.h_cache, a.hf, S, D,
             (const int*)a.num_steps, halt);
  if (e) return e;
  e = product<float, false>(nullptr, nullptr, a.hf, a.head_w, B, NHp, D,
                            RoundedEpilogue<float, float, kStore>{
                                a.head_b, a.head_out, NH, NH, halt},
                            s);
  if (e) return e;
  e = launch(pointer_kernel, dim3((S + kPtrKeys - 1) / kPtrKeys, B),
             32 * kPtrKeys, 0, s, (const float*)a.head_out,
             (const float*)a.h_cache, a.ptr, S, D, V,
             (const int*)a.num_steps, halt);
  if (e) return e;
  return launch(sample_kernel, dim3(B), 256, 0, s, a);
}

static bool valid(const DecodeArgs& a) {
  const long long G = a.kvH > 0 ? a.H / a.kvH : 0, D = a.D, F = a.F;
  const long long E = a.is_bf16 ? 8 : 4;  // T values in 16 bytes
  const long long PT = a.Dh / E;  // the self kernel's lanes a key
  int CL;
  return a.B > 0 && a.B <= 65535 && a.S > 0 && a.kvH > 0 &&
         a.H % a.kvH == 0 && G <= kMaxGroup && D == a.H * a.Dh &&
         // the cross kernel's instances; self: Dh / E lanes a key
         (a.Dh == 32 || a.Dh == 64 || a.Dh == 128) && (PT & (PT - 1)) == 0 &&
         a.Li > 0 && spans_per_rank((int)a.Li, CL) <= kMaxSpansPerRank &&
         // the cluster GEMM: LN prologue K % 128, K <= 1024, N % 32
         D % 128 == 0 && D <= 1024 && F % 128 == 0 && F <= 1024 &&
         (D + 2 * a.kvH * a.Dh) % 32 == 0 &&
         // the self kernel's staged K/V in shared memory
         self_smem<float>(kMaxGroup, (int)a.S, (int)a.Dh) <= 200 * 1024 &&
         a.dof > 0 && (!a.step || a.is_bf16);
}

// Once per call, before the capture (nothing may set an attribute while
// a stream captures): the cross kernel's dynamic shared memory limit.
template <typename T>
static int setup(const DecodeArgs& a) {
  int CL;
  const int npr = spans_per_rank((int)a.Li, CL);
  const int G = (int)(a.H / a.kvH);
  const size_t smem = cross_smem(G, (int)a.Dh, npr);
  const size_t ssmem = self_smem<T>(G, (int)a.S, (int)a.Dh);
  if (ssmem > 48 * 1024) {
    const int e = (int)cudaFuncSetAttribute(
        self_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)ssmem);
    if (e) return e;
  }
  if (smem <= 48 * 1024) return cudaSuccess;
  return with_cross_kernel<T>((int)a.Dh, [&](auto kernel) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  });
}

// ns since the Unix epoch on the system clock, the clock of Python's
// time.time_ns() and of the profiler's timestamps
static long long now_ns() {
  return (long long)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::system_clock::now().time_since_epoch())
      .count();
}

// A decode shape's launch state, which the caller keeps between the calls
// of that shape (plank_decode_state_new / _free) and passes to one call at
// a time: a stream of its own, its events and two pinned words for the
// halt flag, the step's plan and the graph of `k` steps, instantiated. The
// step route keeps the captured graph too, whose kernel nodes take each
// call's arguments (`step::set_args`); the chain captures each call anew
// and updates the instantiated graph from the capture.
struct State {
  cudaStream_t cs = nullptr;
  cudaEvent_t ready = nullptr, started = nullptr, finished = nullptr,
              read[2] = {};
  int* flags = nullptr;  // pinned: the halt flag after a replay
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  std::vector<cudaGraphNode_t> kernels;  // the step route's kernel nodes
  step::Plan plan = {};
  long long nodes = 0;
  int k = 0;
};

// Everything `st` holds, its stream's work finished first (the pinned
// flags may be a copy's target); `st` empty after.
static void release(State& st) {
  if (st.cs != nullptr) {
    cudaStreamSynchronize(st.cs);
    cudaStreamDestroy(st.cs);
  }
  if (st.exec != nullptr) cudaGraphExecDestroy(st.exec);
  if (st.graph != nullptr) cudaGraphDestroy(st.graph);
  for (cudaEvent_t ev : {st.ready, st.started, st.finished, st.read[0],
                         st.read[1]})
    if (ev != nullptr) cudaEventDestroy(ev);
  if (st.flags != nullptr) cudaFreeHost(st.flags);
  st = State();
}

static int create(State& st) {
  int e;
  if ((e = (int)cudaStreamCreateWithFlags(&st.cs, cudaStreamNonBlocking)) ||
      (e = (int)cudaEventCreateWithFlags(&st.ready,
                                         cudaEventDisableTiming)) ||
      (e = (int)cudaEventCreate(&st.started)) ||
      (e = (int)cudaEventCreate(&st.finished)) ||
      (e = (int)cudaEventCreateWithFlags(&st.read[0],
                                         cudaEventDisableTiming)) ||
      (e = (int)cudaEventCreateWithFlags(&st.read[1],
                                         cudaEventDisableTiming)))
    return e;
  return (int)cudaMallocHost(reinterpret_cast<void**>(&st.flags),
                             2 * sizeof(int));
}

// `k` steps of `a` captured on `st.cs` into `graph`
template <typename T>
static int capture(const DecodeArgs& a, int k, State& st,
                   cudaGraph_t& graph) {
  int e = (int)cudaStreamBeginCapture(st.cs,
                                      cudaStreamCaptureModeThreadLocal);
  if (e) return e;
  int le = 0;
  for (int i = 0; i < k && le == 0; ++i)
    le = a.step ? step::launch(a, st.plan, st.cs) : launch_step<T>(a, st.cs);
  e = (int)cudaStreamEndCapture(st.cs, &graph);
  return le ? le : e;
}

// The graph of `k` steps for this call in `st.exec`: on a shape's first
// call captured and instantiated (the step route keeps the graph and its
// kernel nodes); after it, on the step route, the kernel nodes take this
// call's arguments, and on the chain a new capture updates the exec (or,
// where the update is refused, replaces it).
template <typename T>
static int build(const DecodeArgs& a, int k, State& st, long long* stats) {
  int e;
  if (st.exec != nullptr && a.step) {
    for (cudaGraphNode_t node : st.kernels)
      if ((e = step::set_args(st.exec, node, a, st.plan))) return e;
    stats[1] = stats[2] = stats[3] = now_ns();
    return 0;
  }
  stats[1] = now_ns();
  cudaGraph_t graph = nullptr;
  if ((e = capture<T>(a, k, st, graph))) {
    if (graph != nullptr) cudaGraphDestroy(graph);
    return e;
  }
  stats[2] = now_ns();
  size_t nodes = 0;
  if ((e = (int)cudaGraphGetNodes(graph, nullptr, &nodes)) == 0) {
    st.nodes = (long long)nodes;
    if (st.exec != nullptr) {
      cudaGraphExecUpdateResultInfo info;
      if (cudaGraphExecUpdate(st.exec, graph, &info) != cudaSuccess) {
        cudaGetLastError();  // refused: not an error of this call
        cudaGraphExecDestroy(st.exec);
        st.exec = nullptr;
      }
    }
    if (st.exec == nullptr)
      e = (int)cudaGraphInstantiate(&st.exec, graph, 0);
  }
  if (e == 0 && a.step) {
    std::vector<cudaGraphNode_t> all(nodes);
    e = (int)cudaGraphGetNodes(graph, all.data(), &nodes);
    for (size_t i = 0; e == 0 && i < nodes; ++i) {
      cudaGraphNodeType type = cudaGraphNodeTypeEmpty;
      e = (int)cudaGraphNodeGetType(all[i], &type);
      if (e == 0 && type == cudaGraphNodeTypeKernel)
        st.kernels.push_back(all[i]);
    }
    st.graph = graph;
  } else {
    cudaGraphDestroy(graph);
  }
  stats[3] = now_ns();
  return e;
}

// The whole decode on the launch state `st` (empty on a shape's first
// call): the graph of `k` steps (`build`) on `st`'s stream, ordered after
// `caller` by an event (the caller's stream may be the legacy default
// stream, which cannot be captured), replayed until `halt`: with early
// exit the host reads the flag after replay r while replay r + 1 runs, so
// at most one replay of empty launches follows the last step. Returns
// with `caller` ordered after the replays and nothing synchronised or
// released; a failed call releases `st`. stats (14 int64): the host clock
// (`now_ns`) where the call enters, the capture begins, the capture ends,
// the graph is instantiated or takes its arguments (the replays' launches
// follow at once), the replays are launched and the halt flag read, and
// the call returns (the first three equal on a step route's later call);
// then the graph's nodes, the replays launched, whether `st` came built
// (1) or was built here (0), the route (1 the step as one launch, 0 the
// chain), and the step's rows a cluster, cluster size, clusters and the
// clusters the card holds at once (0 on the chain).
template <typename T>
static int run(const DecodeArgs& a, int k, cudaStream_t caller, State& st,
               long long* stats) {
  stats[0] = now_ns();
  const bool built = st.exec != nullptr;
  int e = 0;
  if (built && st.k != k) e = cudaErrorInvalidValue;
  else if (!built && a.step) e = step::plan(a, st.plan);
  // the chain's kernels' shared memory for this shape, before its capture
  else if (!a.step) e = setup<T>(a);
  st.k = k;
  stats[8] = built;
  stats[9] = a.step != 0;
  stats[10] = st.plan.R;
  stats[11] = st.plan.C;
  stats[12] = st.plan.clusters;
  stats[13] = st.plan.held;
  do {
    if (e) break;
    if (st.cs == nullptr && (e = create(st))) break;
    if ((e = (int)cudaEventRecord(st.ready, caller)) ||
        (e = (int)cudaStreamWaitEvent(st.cs, st.ready, 0)))
      break;
    if ((e = build<T>(a, k, st, stats))) break;
    stats[6] = st.nodes;
    const int replays = (int)((a.S + k - 1) / k);
    if ((e = (int)cudaEventRecord(st.started, st.cs))) break;
    int r = 0;
    while (r < replays) {
      if ((e = (int)cudaGraphLaunch(st.exec, st.cs))) break;
      ++r;
      if (!a.early_exit || r == replays) continue;
      if ((e = (int)cudaMemcpyAsync(&st.flags[r % 2], a.halt, sizeof(int),
                                    cudaMemcpyDeviceToHost, st.cs)) ||
          (e = (int)cudaEventRecord(st.read[r % 2], st.cs)))
        break;
      if (r >= 2) {  // the flag after replay r - 1, while replay r runs
        if ((e = (int)cudaEventSynchronize(st.read[(r - 1) % 2]))) break;
        if (st.flags[(r - 1) % 2]) break;
      }
    }
    stats[7] = r;
    stats[4] = now_ns();
    if (e) break;
    if ((e = (int)cudaEventRecord(st.finished, st.cs)) ||
        (e = (int)cudaStreamWaitEvent(caller, st.finished, 0)))
      break;
  } while (false);
  if (e) release(st);
  stats[5] = now_ns();
  return e;
}

}  // namespace plank

// A decode shape's launch state, empty: the caller passes it to every
// plank_decode_run of that shape and frees it with plank_decode_state_free.
// nullptr where the host is out of memory.
extern "C" void* plank_decode_state_new() {
  return new (std::nothrow) plank::State();
}

// Waits for the state's work and releases it.
extern "C" void plank_decode_state_free(void* state) {
  plank::State* st = static_cast<plank::State*>(state);
  if (st == nullptr) return;
  plank::release(*st);
  delete st;
}

// The whole greedy decode of `args` (a plank::DecodeArgs), its state set
// up by the caller (x, caches, output, done, halt, num_steps and counter
// at their step-0 values), `graph_steps` steps a graph, on the launch
// state `state` of its shapes (empty on their first call, built by it).
// Returns once the host has seen the decode end, with `stream` ordered
// after it; stats (14 int64): the call's phase boundaries on the system
// clock in ns, graph nodes, replays, whether the state came built, the
// route and the step's plan (`run`). A failed build of the graph or launch
// returns its CUDA error and leaves `state` empty.
extern "C" int plank_decode_run(const void* args, long long graph_steps,
                                void* stream, void* state,
                                long long* stats) {
  const plank::DecodeArgs& a = *static_cast<const plank::DecodeArgs*>(args);
  plank::State& st = *static_cast<plank::State*>(state);
  if (!plank::valid(a) || graph_steps <= 0 || graph_steps > a.S)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.is_bf16
             ? plank::run<__nv_bfloat16>(a, (int)graph_steps, s, st, stats)
             : plank::run<float>(a, (int)graph_steps, s, st, stats);
}

// The device ns of the last plank_decode_run on `state`, from its first
// replay's start to its last one's end (events on the state's stream); the
// caller asks once the call's work is done (after a synchronise of the
// call's stream), else the CUDA error of the events' query.
extern "C" int plank_decode_replay_ns(void* state, long long* ns) {
  plank::State& st = *static_cast<plank::State*>(state);
  float ms = 0.f;
  const int e = (int)cudaEventElapsedTime(&ms, st.started, st.finished);
  *ns = (long long)((double)ms * 1e6);
  return e;
}

// The step's plan for a bf16 decode of `args`' shapes on the current
// device (only the ints of `args` are read, its `step` set): out (4 int64)
// = rows a cluster, cluster size, clusters, and the clusters the card holds
// at once; the caller takes the step where one wave holds every cluster.
// Returns cudaErrorInvalidValue where the step cannot run these shapes.
extern "C" int plank_decode_step_plan(const void* args, long long* out) {
  const plank::DecodeArgs& a = *static_cast<const plank::DecodeArgs*>(args);
  if (!plank::valid(a) || !a.step) return cudaErrorInvalidValue;
  plank::step::Plan p = {};
  const int e = plank::step::plan(a, p);
  out[0] = p.R;
  out[1] = p.C;
  out[2] = p.clusters;
  out[3] = p.held;
  return e;
}
