// The greedy decode loop, captured as a CUDA graph of CHECK_EVERY steps
// on a shape's first call, kept with the shape's stream, events and plan
// for its later calls (`State`), and replayed until every row is done.
// Two routes, which the caller chooses (`step`, from
// plank_decode_step_plan): one kernel a step (bf16, where the card holds
// every cluster of the step's plan at once), or a chain of 52 kernels a
// step (f32; bf16 past one wave, its products on mma.sync, or in the SIMT
// order with `simt_order`, which exists only to compare the two orders).
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
// The step as one launch (step::step_kernel, bf16 products on mma.sync).
// The rows of a step are independent; only the halt decision couples
// them. So a thread-block cluster of C blocks owns a group of R rows and
// runs the group's whole step, in order: 6 x [LN1 -> QKV (this step's K/V
// into the self cache) -> self-attention -> wo + residual -> LN2 ->
// cross-q -> cross-attention over int8 K/V -> cross wo + residual -> LN3
// -> w1 + relu -> w2 + residual] -> final LN into the hidden cache -> f32
// head -> pointer logits -> sampling. Cluster barriers suffice between the
// phases because every value a phase reads was written inside the cluster
// (or by an earlier launch): the residual stream (f32) and the
// activations stay in shared memory for the whole step, each block holding
// a copy of the R rows, and a block writes its slice of a product's output
// into every block's copy through distributed shared memory; this step's
// K/V go to the self cache in device memory, ordered by the barrier's
// release and acquire. Each block owns a column slice of every product
// (strips of 8 columns, strip-major in device memory so that a block's
// chunk is one bulk copy) and streams its ~1/C of the weights through a
// ring of kStages stages by the tensor memory accelerator; the weights
// depend on no result, so the next chunks, the next phase's and the next
// step's first ones among them, are in flight while a phase computes or
// waits at a barrier. The attention phases borrow the drained ring to stage
// their keys. R and C come from B and cudaOccupancyMaxActiveClusters, so
// that the step runs in one wave (B=64 on an H100: 13 clusters of 8 blocks
// hold at once, so 5 rows each). L2 plan: every cluster reads all 28.8 MB
// of weights a step (0.37 GB from L2 at 13 clusters), which pays only
// while they stay there, so they load with an evict-last policy; the cross
// K/V, read once a step, take the default policy and so leave first.
//
// What sets its time: a block runs 8 warps (2 a scheduler) at ~250
// registers, so each phase runs at a low issue rate with little latency
// hidden, and code that runs once a layer waits on instruction fetch:
// hence the compact (rolled) layer norm and score loops, and the fewer
// template instances. The last cluster to finish (an atomic count, never
// a wait) advances the step and sets the halt flag. So the step's time
// grows with R and, once the rows need more clusters than the card holds
// (R is capped by shared memory: 10 at Li=1152), with the waves, while the
// chain's kernels spread a large batch over every SM: on an H100 the step
// is the faster up to B=128 (one wave), the chain from B=160 (2.18 against
// 2.78 ms a step at B=512), hence the one-wave rule.
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
//   cross-q and w1. bf16 products run on mma.sync (in the SIMT order with
//   `simt_order`), every f32 product in the SIMT GEMM's order of f32 sums.
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
// - With `pdl`, each kernel is a programmatic dependent launch: it starts
//   while the previous one ends, issues what needs no earlier result (a
//   GEMM's weights), then waits for the previous kernel
//   (griddepcontrol.wait) before it reads anything else.
//
// The step kernel repeats the chain's arithmetic phase by phase (its
// products' K slices are the chain's split-K slices, added in the same
// order; the other phases lane for lane), so on mma.sync it gives the bits
// the chain gave with its products there.
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
#include <algorithm>
#include <atomic>
#include <chrono>
#include <new>
#include <vector>

#include "gemm_mma.cuh"

namespace plank {

// Mirrors the ctypes Structure in ops/persistent_decode.py: every field is
// 8 bytes wide, so both sides agree on the layout without padding rules.
// One field per declaration (tests/test_torch_decode_graph.py parses it).
struct DecodeArgs {
  long long B;
  long long S;
  long long D;
  long long H;
  long long kvH;
  long long Dh;
  long long F;
  long long V;
  long long L;
  long long Li;
  long long dof;
  long long end_token;
  long long is_bf16;
  long long early_exit;
  long long simt_order;     // the chain's bf16 products in the SIMT order
  long long step;           // one launch a step (bf16), not the chain
  long long pdl;            // launches overlap the previous kernel's end
  // compute-dtype weights, layer-stacked; projections act as x @ W
  const void* wqkv;         // (L, D, W) or (L, W / 8, D, 8)
  const void* bqkv;
  const void* wo;
  const void* bo;
  const void* cwq;
  const void* cbq;
  const void* cwo;
  const void* cbo;
  const void* w1;
  const void* b1;
  const void* w2;
  const void* b2;
  const float* ln;          // (L, 6, D): norm1/2/3 scale and bias
  const float* final_ln;    // (2, D)
  // the products' weights row-major (chain) or in strips of 8 columns,
  // (N / 8, K, 8) (step); the head (D, NHp) or (ceil(NH / 4), D, 4), each
  // vocab | pointer | switch | 0 pad
  const float* head_w;
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
  void* k_cache;            // (L, B, S, Dkv) T
  void* v_cache;            // (L, B, S, Dkv) T
  float* h_cache;           // (B, S, D)
  float* x;                 // (B, D) residual stream, zero at step 0
  float* hf;                // (B, D) this step's final-norm output
  void* q;                  // (B, D) T, self-attention query
  void* att;                // (B, D) T, attention output
  void* q2;                 // (B, D) T, cross-attention query
  void* z;                  // (B, F) T
  float* head_out;          // (B, V + D + 1)
  float* ptr;               // (B, S) this step's pointer logits
  int* output;              // (B, S)
  int* attach;              // (B, S)
  int* done;                // (B)
  int* halt;                // set: every later kernel returns at once
  int* num_steps;           // steps run so far = the current step
  int* counter;             // sampling blocks finished, zero between steps
};

// Programmatic dependent launch: wait until the previous kernel of the
// stream has finished and its writes are visible (a no-op for a launch
// that did not allow the overlap), then let the next kernel's blocks
// start. Every kernel of the loop calls it before it reads anything an
// earlier kernel wrote, `halt` first.
__device__ __forceinline__ void follow_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

constexpr float kNegInf = -1e9f;
constexpr float kEps = 1e-6f;
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
// f32 stream with `ln_p` = (scale, bias); on mma.sync when `tc` (bf16
// only), else in the SIMT GEMM's order.
template <typename T, bool LN, typename Epi>
static int product(bool tc, bool pdl, const float* x, const float* ln_p,
                   const void* A, const void* W, int M, int N, int K,
                   Epi epi, cudaStream_t s) {
  const gemm::LnArgs ln{x, ln_p, ln_p == nullptr ? nullptr : ln_p + K};
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    if (tc)
      return gemm::cluster_gemm<true, T, LN>(A, K, ln, W, M, N, K, epi, s,
                                             pdl);
  return gemm::cluster_gemm<false, T, LN>(A, K, ln, W, M, N, K, epi, s, pdl);
}

// A kernel of the loop without a cluster on `s`, overlapping the previous
// kernel's end when the call asks for it (`pdl`)
template <typename... Params, typename... Args>
static int launch(const DecodeArgs& a, void (*kernel)(Params...), dim3 grid,
                  int threads, size_t smem, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.pdl ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// the values of T in 16 bytes at p (16-byte aligned) as floats (exact)
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&f)[8]) {
  gemm::bf16x8(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
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
constexpr int kCrossRanks = 4;
constexpr int kSpan = 64;
constexpr int kCrossStages = 2;
constexpr int kMaxSpansPerRank = 64;  // bits of a rank's span mask

// dynamic shared memory of the cross kernel, bytes: the stages of K and V
// (padded rows), each head's span of weights, (m, l, o) of each head (read
// by the other ranks), the mask bytes of the rank's spans
__host__ __device__ inline size_t cross_smem(int G, int Dh, int mine) {
  return (size_t)kCrossStages * 2 * kSpan * (Dh + 16) +
         (size_t)4 * G * (kSpan + Dh + 2) + (size_t)mine * kSpan;
}

__host__ __device__ inline int spans_per_rank(int Li, int& CL) {
  const int nsp = (Li + kSpan - 1) / kSpan;
  CL = nsp < kCrossRanks ? nsp : kCrossRanks;
  return (nsp + CL - 1) / CL;
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
  cfg.numAttrs = a.pdl ? 2 : 1;
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

// =================================================== the step as one launch
// The bf16 route (see the note at the top): one kernel a step, a cluster
// of C blocks per group of R rows. Every phase below is that of the chain
// above, in the same f32 order, so the two routes give the same bits: the
// products' slices are the chain's split-K slices, added in its rank order;
// the layer norms, the attentions, the head, the pointer logits and the
// sampling repeat its kernels' arithmetic lane for lane.
namespace step {

using bf16 = __nv_bfloat16;
namespace cg = cooperative_groups;

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kStages = 4;         // the weight ring
constexpr int kMaxRows = 16;       // rows a cluster: one m16 tile
constexpr int kMaxStage = 32768;   // bytes a ring stage
constexpr int kStrip = 16;         // bytes a weight row of a strip
constexpr int kSlices = 8;         // the chain's split-K slices (k_slices)
constexpr int kChunkStrips = 4;    // strips a ring chunk, at most
constexpr int kPtrPairs = 4;       // pointer dots a warp keeps in flight
// dynamic shared memory a block may take (227 KB less the static arrays)
constexpr int kSmemLimit = 232448 - 1024;

// the products of a layer in order, then the f32 head
enum Phase { kQkv = 0, kWo, kCq, kCwo, kW1, kW2, kHead };

// The row-group plan and the shared-memory layout (byte offsets; the ring
// of weight stages at 0), computed on the host from the input's shapes.
struct Plan {
  int R, C, clusters;  // rows a cluster, cluster size, clusters
  int held;            // the clusters the card holds at once
  // the shapes, as ints (read from the constant bank where used)
  int D, S, L, kvH, Dh, G, F, V, Li, Dkv;
  int xp, a0p, a1p;   // row pitches of the stream, LN and A buffers
  int stage;           // bytes a ring stage
  int ngs;             // self-attention groups of G warps a block
  int aw;              // cross-attention warps a block
  int parts;           // cross-attention parts of a (row, kv head): CL
  int chunks;          // ring chunks a step, the most of any block
  int bias_cols;       // a layer's bias columns, the most of any block
  int xs, a0, a1, qb, work, part, mtab, mrows, scl, sched, bias, hbias, lnp,
      bars, smem;
};

__host__ __device__ inline int ceil_div(int x, int y) { return (x + y - 1) / y; }
__host__ __device__ inline int align128(int x) { return (x + 127) / 128 * 128; }

// Weight strips of a phase: 8 bf16 columns (4 f32 in the head) over all K
// rows, 16 bytes a row, strip-major; rank r of a cluster takes strips
// [r * n / C, (r + 1) * n / C) and streams them in chunks of at most
// kChunkStrips strips that fit a ring stage.
__host__ __device__ inline void phase_shape(const DecodeArgs& a, int p,
                                            int& K, int& strips) {
  const int D = (int)a.D, F = (int)a.F, W = D + 2 * (int)(a.kvH * a.Dh);
  K = p == kW2 ? F : D;
  strips = p == kQkv ? W / 8
           : p == kW1 ? F / 8
           : p == kHead ? ceil_div((int)(a.V + a.D + 1), 4)
                        : D / 8;
}

__host__ __device__ inline int chunk_strips(const Plan& p, int K) {
  const int n = p.stage / (K * kStrip);
  return n < kChunkStrips ? n : kChunkStrips;
}

// rank r's strips [s0, s1) of phase ph and their chunks
__host__ __device__ inline int phase_chunks(const DecodeArgs& a,
                                            const Plan& p, int ph, int r,
                                            int& s0, int& s1, int& K) {
  int strips;
  phase_shape(a, ph, K, strips);
  s0 = r * strips / p.C;
  s1 = (r + 1) * strips / p.C;
  return ceil_div(s1 - s0, chunk_strips(p, K));
}

// the phase's weights of layer l
__device__ inline const char* phase_base(const DecodeArgs& a, int l, int p) {
  const long long D = a.D, F = a.F, W = a.D + 2 * a.kvH * a.Dh;
  switch (p) {
    case kQkv: return (const char*)a.wqkv + l * D * W * 2;
    case kWo: return (const char*)a.wo + l * D * D * 2;
    case kCq: return (const char*)a.cwq + l * D * D * 2;
    case kCwo: return (const char*)a.cwo + l * D * D * 2;
    case kW1: return (const char*)a.w1 + l * D * F * 2;
    case kW2: return (const char*)a.w2 + l * F * D * 2;
    default: return (const char*)a.head_w;
  }
}

// one ring chunk: a block's consecutive strips of one phase, contiguous
struct Chunk {
  const char* src;
  unsigned bytes, pad;
};

// ------------------------------------------------------------ PTX
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                   attn::smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n"
      "}\n" ::"r"(attn::smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one bulk copy of `bytes` contiguous bytes into this block's shared
// memory, its completion counted on `bar`; the weights stay in L2
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(pol));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   attn::smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(attn::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(attn::smem_u32(bar)), "l"(pol)
      : "memory");
}

// attn::mma, kept in program order after the fragments' loads (the
// compiler would otherwise place each product right after its load, and a
// warp would wait for every load in turn)
__device__ __forceinline__ void mma_in_order(float (&c)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the warps of one attention group (ids 1.. ; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// v at p in the shared memory of every block of the cluster
template <typename V>
__device__ __forceinline__ void to_all(cg::cluster_group& cl, V* p, V v,
                                       int C) {
  for (int r = 0; r < C; ++r) *cl.map_shared_rank(p, r) = v;
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// --------------------------------------------------------- the context
struct Ctx {
  const DecodeArgs& a;
  const Plan& p;
  cg::cluster_group& cl;
  unsigned char* smem;
  int rank, Rv, row0, t, tid, lane, warp;
  int idx;               // ring chunks consumed
  int nchunks;           // ring chunks of this block a step
  int limit;             // chunks issued stay below it (the next drain)
  int NL, drain_self, drain_cross;  // chunks a layer; a layer's drains
  const Chunk* sched;    // their sources, in order
  float* xs;             // R x (D + 4): the residual stream
  bf16* a0;              // R x (D + 8): layer-norm outputs
  bf16* a1;              // R x (max(D, F) + 8): attention outputs, z
  bf16* qb;              // R x D: self or cross queries
  float* stat;           // 2 x kMaxRows: a layer norm's means, 1 / std
  uint64_t* bars;       // the ring's, then the layer norms' (3)
  const bf16* bias;     // the block's columns of every layer's biases
  int boff[kHead];      // their offsets in a layer's, by phase
  float* lnp;           // two layers' norm parameters, the final norm's
};

// The block's chunks of a step in order (every layer's phases, then the
// head), once a launch, by all threads; returns their number. nl: a
// layer's chunks, and those before its self- and its cross-attention.
__device__ int build_schedule(const DecodeArgs& a, const Plan& p, int rank,
                              Chunk* sched, int (&nl)[3]) {
  int n[kHead + 1], s0[kHead + 1], s1[kHead + 1], K[kHead + 1];
  int NL = 0;
#pragma unroll
  for (int ph = 0; ph <= kHead; ++ph) {
    n[ph] = phase_chunks(a, p, ph, rank, s0[ph], s1[ph], K[ph]);
    if (ph < kHead) NL += n[ph];
  }
  const int L = (int)a.L, total = L * NL + n[kHead];
  nl[0] = NL;
  nl[1] = n[kQkv];
  nl[2] = n[kQkv] + n[kWo] + n[kCq];
  for (int e = threadIdx.x; e < total; e += kThreads) {
    int l = 0, ph = kHead, j = e - L * NL;
    if (e < L * NL) {
      l = e / NL;
      j = e % NL;
      ph = 0;
#pragma unroll
      for (int q = 0; q < kHead - 1; ++q)
        if (ph == q && j >= n[q]) {
          j -= n[q];
          ++ph;
        }
    }
    int k = K[0], b0 = s0[0], b1 = s1[0];
#pragma unroll
    for (int q = 1; q <= kHead; ++q)
      if (ph == q) k = K[q], b0 = s0[q], b1 = s1[q];
    const int cs = chunk_strips(p, k), sa = b0 + j * cs;
    sched[e].src = phase_base(a, l, ph) + (size_t)sa * k * kStrip;
    sched[e].bytes = (unsigned)(min(cs, b1 - sa) * k * kStrip);
  }
  return total;
}

// thread 0: layer l's six norm vectors (or, at l = L, the final norm's
// two) into their buffer: two layers' alternate, the final norm has its own
__device__ inline void load_norms(Ctx& x, int l) {
  const int D = x.p.D, last = l == x.p.L;
  float* dst = x.lnp + (last ? 12 : 6 * (l & 1)) * D;
  const float* src = last ? x.a.final_ln : x.a.ln + (long long)l * 6 * D;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  bulk_load(dst, src, (unsigned)((last ? 2 : 6) * D * 4),
            &x.bars[kStages + (last ? 2 : l & 1)]);
}

// the layer-norm parameters of layer l (L: the final norm's), once landed
__device__ inline const float* norms(Ctx& x, int l) {
  const int last = l == x.p.L;
  mbar_wait(&x.bars[kStages + (last ? 2 : l & 1)], last ? 0 : (l >> 1) & 1);
  return x.lnp + (last ? 12 : 6 * (l & 1)) * x.p.D;
}

// thread 0: chunk `slot` of the step into ring stage slot % kStages, if
// the step has it
__device__ inline bool issue(Ctx& x, int slot) {
  if (slot >= x.limit) return false;
  const int st = slot % kStages;
  bulk_load(x.smem + (size_t)st * x.p.stage, x.sched[slot].src,
            x.sched[slot].bytes, &x.bars[st]);
  return true;
}

// After an attention phase, which stages its keys in the drained ring:
// the ring back to the weights, up to the next drain. The staging's
// generic-proxy accesses are ordered before the copies that overwrite it.
__device__ inline void refill(Ctx& x, int limit) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  x.limit = limit;
  if (x.tid == 0)
    for (int s = x.idx; s < x.idx + kStages; ++s) issue(x, s);
}

// ------------------------------------------------------------- epilogues
// y = round(round(acc) + bias) in bf16, as the chain's epilogues
enum Epi { kEpiQkv, kEpiQ, kEpiRes, kEpiRelu };

template <int EPI>
__device__ inline void epilogue(Ctx& x, int l, int m, int n, float acc0,
                                float acc1, float bias0, float bias1) {
  const float y0 = Elem<bf16>::round(Elem<bf16>::round(acc0) + bias0);
  const float y1 = Elem<bf16>::round(Elem<bf16>::round(acc1) + bias1);
  if constexpr (EPI == kEpiRes) {
    float* p = x.xs + m * x.p.xp + n;
    to_all(x.cl, reinterpret_cast<float2*>(p), make_float2(p[0] + y0, p[1] + y1),
           x.p.C);
  } else if constexpr (EPI == kEpiRelu) {
    to_all(x.cl, reinterpret_cast<unsigned*>(x.a1 + m * x.p.a1p + n),
           bf16x2(fmaxf(y0, 0.f), fmaxf(y1, 0.f)), x.p.C);
  } else {
    if (EPI == kEpiQ || n < x.p.D) {
      to_all(x.cl, reinterpret_cast<unsigned*>(x.qb + m * x.p.D + n),
             bf16x2(y0, y1), x.p.C);
      return;
    }
    // this step's K or V into the self cache
    const int c = n - x.p.D;
    bf16* cache = static_cast<bf16*>(c < x.p.Dkv ? x.a.k_cache : x.a.v_cache);
    const long long row = ((long long)l * x.a.B + x.row0 + m) * x.p.S + x.t;
    *reinterpret_cast<unsigned*>(cache + row * x.p.Dkv + c % x.p.Dkv) =
        bf16x2(y0, y1);
  }
}

// ------------------------------------------------------------- products
// One product of a layer: rows [0, Rv) of A (bf16, pitch ap) times this
// rank's strips of the phase's weights, chunk by chunk from the ring. Warp
// w takes the chain's K slice w (of kSlices): its fragments of A once a
// phase, then for each strip of a chunk an m16n8k16 accumulator from 0
// over the slice's 16-row steps in order, the strips interleaved. The
// slices' partials go to shared memory (two buffers, one a chunk) and each
// output adds them in slice order from 0, as the chain adds its ranks'
// partials. Thread 0 refills each stage once every warp has read it.
template <int EPI>
__device__ void product(Ctx& x, int l, int ph, const bf16* A, int ap) {
  int s0, s1, K;
  const int nch = phase_chunks(x.a, x.p, ph, x.rank, s0, s1, K);
  const int cs = chunk_strips(x.p, K), KS = K / kSlices, nks = KS / 16;
  const int lane = x.lane, sl = x.warp, Rv = x.Rv;
  // A's ldmatrix row for this lane; rows past Rv repeat the last row, and
  // their outputs are dropped
  const int arow = min((lane & 7) + ((lane >> 3) & 1) * 8, Rv - 1);
  const bf16* abase = A + arow * ap + (lane >> 4) * 8 + sl * KS;
  unsigned af[8][4];  // KS <= 128
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
    if (ks < nks) attn::ldsm_x4(af[ks], attn::smem_u32(abase + 16 * ks));
  float* parts = reinterpret_cast<float*>(x.smem + x.p.work);
  const int pstride = kChunkStrips * kSlices * x.p.R * 8;
  // the output pair of this thread in a chunk: (strip, row, columns)
  const int ostrip = x.tid / (Rv * 4), om = x.tid / 4 % Rv, ocp = x.tid % 4;
  for (int j = 0; j < nch; ++j) {
    const int st = x.idx % kStages;
    const int sa = s0 + j * cs, n = min(cs, s1 - sa);
    const bool mine = x.tid < n * Rv * 4;
    const int on = (sa + ostrip) * 8 + 2 * ocp;
    float bias0 = 0.f, bias1 = 0.f;
    if (mine) {
      const bf16* b = x.bias + l * x.p.bias_cols + x.boff[ph] + on - s0 * 8;
      bias0 = Elem<bf16>::load(b[0]);
      bias1 = Elem<bf16>::load(b[1]);
    }
    float* pb = parts + (j & 1) * pstride;
    mbar_wait(&x.bars[st], (x.idx / kStages) & 1);
    {
      // lanes 0-15 read rows of strip 2 q, lanes 16-31 of strip 2 q + 1
      // (a strip past the chunk's end reads its last strip; dropped)
      const unsigned wb = attn::smem_u32(x.smem + (size_t)st * x.p.stage) +
                          (unsigned)((sl * KS + (lane & 15)) * kStrip);
      unsigned sp[kChunkStrips / 2];
#pragma unroll
      for (int q = 0; q < kChunkStrips / 2; ++q)
        sp[q] = wb + (unsigned)(min(2 * q + (lane >> 4), n - 1) * K * kStrip);
      float acc[kChunkStrips][4] = {};
#pragma unroll
      for (int g = 0; g < 2; ++g)
        if (4 * g < nks) {
          // four 16-row steps of every strip's fragments, then their products
          unsigned bq[4][kChunkStrips][2];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int q = 0; q < kChunkStrips / 2; ++q) {
              if (4 * g + kk >= nks) continue;
              unsigned r[4];
              attn::ldsm_x4_trans(r, sp[q] + (unsigned)(16 * (4 * g + kk) *
                                                        kStrip));
              bq[kk][2 * q][0] = r[0], bq[kk][2 * q][1] = r[1];
              bq[kk][2 * q + 1][0] = r[2], bq[kk][2 * q + 1][1] = r[3];
            }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int s = 0; s < kChunkStrips; ++s)
              if (4 * g + kk < nks)
                mma_in_order(acc[s], af[4 * g + kk], bq[kk][s][0],
                             bq[kk][s][1]);
        }
      // accumulator element i: row lane / 4 + 8 (i / 2), column
      // 2 (lane % 4) + i % 2
#pragma unroll
      for (int s = 0; s < kChunkStrips; ++s)
        if (s < n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = (lane >> 2) + 8 * h;
            if (m < Rv)
              *reinterpret_cast<float2*>(
                  pb + ((s * kSlices + sl) * x.p.R + m) * 8 + 2 * (lane & 3)) =
                  make_float2(acc[s][2 * h], acc[s][2 * h + 1]);
          }
    }
    __syncthreads();  // the stage is read, the partials are in
    if (x.tid == 0) issue(x, x.idx + kStages);
    ++x.idx;
    if (mine) {
      float t0 = 0.f, t1 = 0.f;
#pragma unroll
      for (int q = 0; q < kSlices; ++q) {
        const float2 v = *reinterpret_cast<const float2*>(
            pb + ((ostrip * kSlices + q) * x.p.R + om) * 8 + 2 * ocp);
        t0 += v.x;
        t1 += v.y;
      }
      epilogue<EPI>(x, l, om, on, t0, t1, bias0, bias1);
    }
  }
}

// The f32 head in the SIMT GEMM's order (the chain's cluster GEMM with
// kTC false): each output's products added by fused multiply-adds from 0
// in k order over slices of 64, the slices added in order from 0, then the
// bias. A chunk's (strip, slice, row, column) partials over the warps
// (two buffers, one a chunk); then each output's slices added in order. Outputs: vocab logits and the switch to the
// row's owner, the pointer feature to every block.
__device__ void head(Ctx& x, float* feat, float* vl, float* part) {
  int s0, s1, K;
  const int nch = phase_chunks(x.a, x.p, kHead, x.rank, s0, s1, K);
  const int cs = chunk_strips(x.p, K), nsl = K / 64, Rv = x.Rv;
  const int V = x.p.V, D = x.p.D, NH = V + D + 1;
  const int pstride = kChunkStrips * x.p.R * (D / 64) * 4;
  const int sw0 = x.tid / (Rv * 4), m0 = x.tid / 4 % Rv, c0 = x.tid % 4;
  for (int j = 0; j < nch; ++j) {
    const int st = x.idx % kStages;
    const int sa = s0 + j * cs, n = min(cs, s1 - sa);
    const int col = (sa + sw0) * 4 + c0;
    const bool mine = x.tid < n * Rv * 4 && col < NH;
    const float bias =
        mine ? reinterpret_cast<const float*>(x.smem + x.p.hbias)[col - s0 * 4]
             : 0.f;
    float* pb = part + (j & 1) * pstride;
    mbar_wait(&x.bars[st], (x.idx / kStages) & 1);
    const float* ws =
        reinterpret_cast<const float*>(x.smem + (size_t)st * x.p.stage);
    // warp w: (strip, slice) items 2 w, 2 w + 1, then 16 more on, ...;
    // lanes 0-15 the first, 16-31 the second, lane g % 16 row g with all 4
    // columns (one 16-byte weight load a k, its row 16 bytes at a time)
    const int g = x.lane & 15;
    for (int pr = 2 * x.warp + (x.lane >> 4); pr < 2 * kWarps *
         ceil_div(n * nsl, 2 * kWarps); pr += 2 * kWarps) {
      const bool live = pr < n * nsl;
      const int it = live ? pr : 0, sw = it / nsl, s = it % nsl;
      const float4* wr =
          reinterpret_cast<const float4*>(ws + ((size_t)sw * K + s * 64) * 4);
      const float4* h4 =
          reinterpret_cast<const float4*>(x.xs + min(g, Rv - 1) * x.p.xp + s * 64);
      float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll 4
      for (int k4 = 0; k4 < 16; ++k4) {
        const float4 hv = h4[k4];
        const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 w = wr[4 * k4 + e];
          p0 = fmaf(hk[e], w.x, p0);
          p1 = fmaf(hk[e], w.y, p1);
          p2 = fmaf(hk[e], w.z, p2);
          p3 = fmaf(hk[e], w.w, p3);
        }
      }
      if (live && g < Rv)
        reinterpret_cast<float4*>(pb)[(sw * Rv + g) * nsl + s] =
            make_float4(p0, p1, p2, p3);
    }
    __syncthreads();  // the stage is read, the partials are in
    if (x.tid == 0) issue(x, x.idx + kStages);
    ++x.idx;
    if (mine) {
      float tot = 0.f;
      for (int s = 0; s < nsl; ++s)
        tot += pb[((sw0 * Rv + m0) * nsl + s) * 4 + c0];
      const float y = tot + bias;
      if (col >= V && col < V + D) {
        to_all(x.cl, feat + m0 * D + (col - V), y, x.p.C);
      } else {
        float* dst = vl + (m0 / x.p.C) * (V + 1) + (col < V ? col : V);
        *x.cl.map_shared_rank(dst, m0 % x.p.C) = y;
      }
    }
  }
}

// ----------------------------------------------------------- layer norm
// Rows [0, Rv) of the stream in the row layer norm's order of f32
// operations (final_norm_kernel; the chain's GEMM prologue): a warp a row
// emulates its 128 threads, thread t adding x[t], x[t + 128], ... from 0,
// the xor butterfly, the 4 warps' sums in order; then every thread
// normalises its elements. Into `dst` (bf16) or, with dst null, in place
// in f32 (the final norm) and into the hidden cache at the step.
__device__ void layer_norm(Ctx& x, const float* scale, const float* bias,
                           bf16* dst, int dp) {
  const int D = x.p.D, J = D / 128, lane = x.lane;
  auto tree = [&](float (&v)[4]) {
    v[0] += v[2];
    v[1] += v[3];
    v[0] += v[1];
    for (int h = 4; h >= 1; h >>= 1)
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], h);
    float tot = 0.f;
    for (int w = 0; w < 4; ++w) tot += __shfl_sync(0xffffffffu, v[0], 8 * w);
    return tot;
  };
#pragma unroll 1
  for (int m = x.warp; m < x.Rv; m += kWarps) {
    // lane (qt, u) is emulated thread 32 qt + u + 8 i of emulated warp qt
    const float* xr = x.xs + m * x.p.xp + 32 * (lane >> 3) + (lane & 7);
    float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] += xr[8 * i + 128 * j];
    const float mean = tree(p) / D;
    float q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float c = xr[8 * i + 128 * j] - mean;
        q[i] += c * c;
      }
    const float var = tree(q) / D;
    if (lane == 0) {
      x.stat[m] = mean;
      x.stat[kMaxRows + m] = 1.f / sqrtf(var + 1e-5f);
    }
  }
  __syncthreads();
#pragma unroll 1
  for (int k = x.tid; k < D; k += kThreads) {
    const float sc = scale[k], bi = bias[k];
#pragma unroll 1
    for (int m = 0; m < x.Rv; ++m) {
      float* xr = x.xs + m * x.p.xp;
      const float y = (xr[k] - x.stat[m]) * x.stat[kMaxRows + m] * sc + bi;
      if (dst != nullptr) {
        dst[m * dp + k] = Elem<bf16>::store(y);
      } else {
        xr[k] = y;
        if (m % x.p.C == x.rank)
          x.a.h_cache[((long long)(x.row0 + m) * x.p.S + x.t) * D + k] = y;
      }
    }
  }
  __syncthreads();
}

// ------------------------------------------------------- self-attention
// bytes of a self-attention group's staging: K and V rows 0..S-1 (padded),
// the group's queries and scores
__host__ __device__ inline int self_group_bytes(int G, int S, int Dh) {
  return align128(2 * S * (Dh + 8) * 2 + 4 * G * (Dh + S));
}

// Units (row b, kv head c) over the cluster's groups of G warps (ngs a
// block, staging in the drained ring): self_attn_kernel's arithmetic (keys
// 0..t of the cache, this step's K/V written by the QKV epilogues before
// the cluster barrier, staged by cp.async through L2), the output pairs to
// every block.
__device__ void self_attention(Ctx& x, int l) {
  const int G = x.p.G, Dh = x.p.Dh, S = x.p.S, Dkv = x.p.Dkv, D = x.p.D;
  const int lg = x.warp / G;
  if (lg >= x.p.ngs) return;
  constexpr int E = 8;
  const int n = x.t + 1, P = Dh / E, RS = Dh + E, nthr = 32 * G;
  const int gtid = x.tid - lg * nthr, gw = gtid >> 5;
  bf16* Ks = reinterpret_cast<bf16*>(x.smem + lg * self_group_bytes(G, S, Dh));
  bf16* Vs = Ks + (size_t)S * RS;
  float* qs = reinterpret_cast<float*>(Vs + (size_t)S * RS);
  float* sc = qs + G * Dh;
  const float scale = 1.f / sqrtf((float)Dh);
  for (int u = x.rank * x.p.ngs + lg; u < x.Rv * x.p.kvH;
       u += x.p.C * x.p.ngs) {
    const int b = u / x.p.kvH, c = u % x.p.kvH;
    const long long base =
        ((long long)l * x.a.B + x.row0 + b) * S * Dkv + c * Dh;
    const bf16* kb = static_cast<const bf16*>(x.a.k_cache) + base;
    const bf16* vb = static_cast<const bf16*>(x.a.v_cache) + base;
    for (int i = gtid; i < n * P; i += nthr) {
      const int j = i / P, pc = i % P;
      attn::cp_async16(Ks + j * RS + pc * E, kb + (long long)j * Dkv + pc * E,
                       16);
      attn::cp_async16(Vs + j * RS + pc * E, vb + (long long)j * Dkv + pc * E,
                       16);
    }
    attn::cp_async_commit();
    for (int i = gtid; i < G * Dh; i += nthr)
      qs[i] = Elem<bf16>::load(x.qb[b * D + c * G * Dh + i]);
    attn::cp_async_wait<0>();
    group_sync(1 + lg, nthr);
    const int h = c * G + gw, lane = x.lane;
    const float* qw = qs + gw * Dh;
    float* sw = sc + gw * S;
    for (int j = lane; j < n; j += 32) {
      const bf16* kr = Ks + j * RS;
      float s = 0.f;
      for (int pc = 0; pc < P; ++pc) {
        float kf[E];
        load16(kr + pc * E, kf);
#pragma unroll
        for (int e = 0; e < E; ++e) s += qw[pc * E + e] * kf[e];
      }
      sw[j] = s * scale;
    }
    __syncwarp();
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sw[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) sum += expf(sw[j] - mx);
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32)
      sw[j] = Elem<bf16>::round(expf(sw[j] - mx) / sum);
    __syncwarp();
    for (int d = 2 * lane; d < Dh; d += 64) {
      float o0 = 0.f, o1 = 0.f;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float pj = sw[j];
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(Vs + j * RS + d);
        o0 += pj * __low2float(v);
        o1 += pj * __high2float(v);
      }
      to_all(x.cl, reinterpret_cast<unsigned*>(x.a1 + b * x.p.a1p + h * Dh + d),
             bf16x2(o0, o1), x.p.C);
    }
    group_sync(1 + lg, nthr);  // the staging is rewritten by the next unit
  }
}


// ------------------------------------------------------ cross-attention
// Items (row b, kv head c, part r) of the chain's cross kernel, its rank r
// of CL now a part: spans r, r + CL, ... of kSpan keys, a span with no
// real key skipped, an online softmax over the part's spans. A warp takes
// kG = 4 query heads of the group at once (ceil(G / 4) items a part; heads
// past G repeat the last one, and are dropped), each head in the chain's
// order lane for lane: the span's int8 K and V are converted once for the
// warp's heads. Part pu = u * CL + r lives in block
// pu % C (slot pu / C), whose warps take its items in turn, so that its
// (m, l, o) stay in that block's shared memory for the combine. A warp's
// spans, over all its items, stream through two cp.async stages of its
// own in the drained ring, the next one, the next item's first among
// them, in flight while one is used. (They take L2's default policy; the
// weights' copies ask to be evicted last, so the K/V stream is evicted
// ahead of them. A cache-hinted cp.async faulted here as an illegal
// instruction on the H100.)
__host__ __device__ inline int span_bytes(int Dh) {
  return 2 * kSpan * (Dh + 16);
}

// bytes of a cross-attention warp's region: two span stages, its heads'
// queries in f32 and their weights
__host__ __device__ inline int cross_warp_bytes(int kG, int Dh) {
  return align128(2 * span_bytes(Dh) + 4 * kG * (Dh + kSpan));
}

// the 4 int8 of a word as floats, exactly and without the I2F unit: byte
// b ^ 0x80 as the low byte of 2^23's pattern is 2^23 + 128 + b
__device__ __forceinline__ void int8x4(unsigned w, float* f) {
  const unsigned u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) -
           8388736.f;
}

__device__ inline float* part_of(Ctx& x, int pu) {
  return reinterpret_cast<float*>(x.smem + x.p.part) +
         (size_t)(pu / x.p.C) * x.p.G * (x.p.Dh + 2);
}

constexpr int kCrossHeads = 4;  // query heads a cross-attention warp

template <int kDh>
__device__ void cross_items(Ctx& x, int l) {
  constexpr int kG = kCrossHeads;
  constexpr int P = kDh / 16, RS = kDh + 16, kCG = kDh / 8, kKG = 32 / kCG;
  const int G = x.p.G, CL = x.p.parts, Li = x.p.Li, Dkv = x.p.Dkv, D = x.p.D;
  const int lane = x.lane, AW = x.p.aw, HB = ceil_div(G, kG);
  if (x.warp >= AW) return;
  const int nsp = ceil_div(Li, kSpan), npu = x.Rv * x.p.kvH * CL;
  // this block's parts pu = rank, rank + C, ...; their items in turn
  const int nmine = x.rank < npu ? (npu - x.rank + x.p.C - 1) / x.p.C : 0;
  const int nit = nmine * HB;
  int8_t* stage = reinterpret_cast<int8_t*>(
      x.smem + x.warp * cross_warp_bytes(kG, kDh));
  float* qs = reinterpret_cast<float*>(stage + 2 * span_bytes(kDh));
  float* sw = qs + kG * kDh;  // [kG][kSpan]
  const unsigned long long* tbits =
      reinterpret_cast<const unsigned long long*>(x.smem + x.p.mtab);
  const int* tany = reinterpret_cast<const int*>(tbits + x.p.R * CL);
  const float* ksc = reinterpret_cast<const float*>(x.smem + x.p.scl) +
                     (size_t)l * x.p.R * x.p.kvH;
  const float scale = 1.f / sqrtf((float)kDh);
  const int8_t* ck = x.a.ck;
  const int8_t* cv = x.a.cv;
  // item k of this warp: part pu, head block hb
  auto pu_of = [&](int k) { return x.rank + k / HB * x.p.C; };
  // an item's spans to read: those with a real key, every span of a row
  // with none (the plain version's full average)
  auto todo_of = [&](int pu) {
    const int part = pu % CL, b = pu / CL / x.p.kvH;
    const int mine = part < nsp ? (nsp - part + CL - 1) / CL : 0;
    return tany[b] ? tbits[b * CL + part]
                   : (mine == 64 ? ~0ull : (1ull << mine) - 1);
  };
  // the copy cursor: item and spans still to issue; copies issued
  int k_i = x.warp;
  unsigned long long left_i = k_i < nit ? todo_of(pu_of(k_i)) : 0ull;
  int issued = 0;
  auto issue_next = [&]() {
    while (!left_i && k_i < nit) {
      k_i += AW;
      if (k_i < nit) left_i = todo_of(pu_of(k_i));
    }
    if (left_i) {
      const int i = __ffsll((long long)left_i) - 1;
      left_i &= left_i - 1;
      const int pu = pu_of(k_i), part = pu % CL, u = pu / CL;
      const int b = u / x.p.kvH, c = u % x.p.kvH;
      const long long base =
          ((long long)l * x.a.B + x.row0 + b) * Li * Dkv + c * kDh;
      const int j0 = (part + i * CL) * kSpan, n = min(kSpan, Li - j0);
      int8_t* Ks = stage + (issued & 1) * 2 * kSpan * RS;
      int8_t* Vs = Ks + kSpan * RS;
      for (int q = lane; q < n * P; q += 32) {
        const int j = q / P, pc = (q % P) * 16;
        const long long off = base + (long long)(j0 + j) * Dkv + pc;
        attn::cp_async16(Ks + j * RS + pc, ck + off, 16);
        attn::cp_async16(Vs + j * RS + pc, cv + off, 16);
      }
      ++issued;
    }
    attn::cp_async_commit();
  };
  issue_next();
  int done = 0;  // spans used
  const int col0 = lane % kCG * 8, kg = lane / kCG;
  for (int k = x.warp; k < nit; k += AW) {
    const int pu = pu_of(k), hb = k % HB, part = pu % CL, u = pu / CL;
    const int b = u / x.p.kvH, c = u % x.p.kvH;
    const uint8_t* mrow = x.smem + x.p.mrows + b * Li;
    // the heads' queries in f32
    for (int i = lane; i < kG * kDh; i += 32)
      qs[i] = Elem<bf16>::load(
          x.qb[b * D + (c * G + min(hb * kG + i / kDh, G - 1)) * kDh +
               i % kDh]);
    const float kscale = ksc[b * x.p.kvH + c] * scale;
    float m_run[kG], l_run[kG], acc[kG][8];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      m_run[g] = -INFINITY;
      l_run[g] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
    }
    unsigned long long left = todo_of(pu);
    for (; left; ++done) {
      const int cur = __ffsll((long long)left) - 1;
      left &= left - 1;
      attn::cp_async_wait<0>();  // span `done` has landed
      __syncwarp();              // and every lane's part of it
      issue_next();              // into the stage span `done` - 1 used
      const int j0 = (part + cur * CL) * kSpan, n = min(kSpan, Li - j0);
      const int8_t* Ks = stage + (done & 1) * 2 * kSpan * RS;
      const int8_t* Vs = Ks + kSpan * RS;
      float dot[kG][2][2];
#pragma unroll
      for (int g = 0; g < kG; ++g)
        dot[g][0][0] = dot[g][0][1] = dot[g][1][0] = dot[g][1][1] = 0.f;
#pragma unroll 1
      for (int pp = 0; pp < P; pp += 2)
#pragma unroll
        for (int pc = pp; pc < pp + 2; ++pc) {
          // keys lane and lane + 32 (a key past the span reads the span's
          // last row, and is dropped); each head's query piece loaded once
          float kf[2][16];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = min(lane + 32 * h, n - 1);
            const int4 raw =
                *reinterpret_cast<const int4*>(Ks + j * RS + pc * 16);
            int8x4((unsigned)raw.x, kf[h]);
            int8x4((unsigned)raw.y, kf[h] + 4);
            int8x4((unsigned)raw.z, kf[h] + 8);
            int8x4((unsigned)raw.w, kf[h] + 12);
          }
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            const float4* q4 =
                reinterpret_cast<const float4*>(qs + g * kDh + pc * 16);
            float q[16];
#pragma unroll
            for (int e4 = 0; e4 < 4; ++e4) {
              const float4 v = q4[e4];
              q[4 * e4] = v.x, q[4 * e4 + 1] = v.y;
              q[4 * e4 + 2] = v.z, q[4 * e4 + 3] = v.w;
            }
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 16; ++e)
                dot[g][h][pc & 1] += q[e] * kf[h][e];
          }
        }
      const float bias0 = mrow[j0 + min(lane, n - 1)] ? kNegInf : 0.f;
      const float bias1 = mrow[j0 + min(lane + 32, n - 1)] ? kNegInf : 0.f;
      // the heads' scores and maxima, the butterflies of all heads level by
      // level (each head's in warp_max's order)
      float s[kG][2], mx[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        s[g][0] = lane < n ? (dot[g][0][0] + dot[g][0][1]) * kscale + bias0
                           : -INFINITY;
        s[g][1] = lane + 32 < n
                      ? (dot[g][1][0] + dot[g][1][1]) * kscale + bias1
                      : -INFINITY;
        mx[g] = fmaxf(s[g][0], s[g][1]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < kG; ++g)
          mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], o));
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float m_new = fmaxf(m_run[g], mx[g]);
        const float alpha = expf(m_run[g] - m_new);
        m_run[g] = m_new;
        l_run[g] *= alpha;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = lane + 32 * h;
          if (j < n) {
            const float e = expf(s[g][h] - m_new);
            sw[g * kSpan + j] = e;
            l_run[g] += e;
          }
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
      }
      __syncwarp();
      for (int j = kg; j < n; j += kKG) {
        const int2 raw = *reinterpret_cast<const int2*>(Vs + j * RS + col0);
        float vf[8];
        int8x4((unsigned)raw.x, vf);
        int8x4((unsigned)raw.y, vf + 4);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const float pj = sw[g * kSpan + j];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] += pj * vf[e];
        }
      }
      __syncwarp();  // the weights are rewritten by the next span
    }
    float* ml = part_of(x, pu);
    float* o = ml + 2 * G;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float l_sum = warp_sum(l_run[g]);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        for (int sh = kCG; sh < 32; sh <<= 1)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], sh);
      const int h = hb * kG + g;
      if (h >= G) continue;
      if (kg == 0)
#pragma unroll
        for (int e = 0; e < 8; ++e) o[h * kDh + col0 + e] = acc[g][e];
      if (lane == 0) {
        ml[h] = m_run[g];
        ml[G + h] = l_sum;
      }
    }
  }
  attn::cp_async_wait<0>();
}

// the cross-attention of layer l on the instance for this Dh
__device__ inline void cross_attention(Ctx& x, int l) {
  if (x.p.Dh == 64) cross_items<64>(x, l);
  else if (x.p.Dh == 32) cross_items<32>(x, l);
  else cross_items<128>(x, l);
}

// the parts of each (row, kv head) added in part order, as the chain's
// combine; output pairs to every block
__device__ void cross_combine(Ctx& x, int l) {
  const int G = x.p.G, Dh = x.p.Dh, GD = G * Dh, CL = x.p.parts;
  const int pairs = x.Rv * x.p.kvH * GD / 2;
  const float* vsc = reinterpret_cast<const float*>(x.smem + x.p.scl) +
                     (size_t)(x.p.L + l) * x.p.R * x.p.kvH;
  for (int pi = x.rank * kThreads + x.tid; pi < pairs; pi += x.p.C * kThreads) {
    const int u = pi / (GD / 2), i = pi % (GD / 2) * 2, h = i / Dh;
    const int b = u / x.p.kvH, c = u % x.p.kvH;
    const float* ml[kCrossRanks];
    float M = -INFINITY;
    for (int r = 0; r < CL; ++r) {
      const int pu = u * CL + r;
      ml[r] = x.cl.map_shared_rank(part_of(x, pu), pu % x.p.C);
      M = fmaxf(M, ml[r][h]);
    }
    float num0 = 0.f, num1 = 0.f, den = 0.f;
    for (int r = 0; r < CL; ++r) {
      if (ml[r][h] == -INFINITY) continue;
      const float f = expf(ml[r][h] - M);
      den += f * ml[r][G + h];
      num0 += f * ml[r][2 * G + i];
      num1 += f * ml[r][2 * G + i + 1];
    }
    const float vscale = vsc[b * x.p.kvH + c];
    to_all(x.cl, reinterpret_cast<unsigned*>(x.a1 + b * x.p.a1p + c * GD + i),
           bf16x2(num0 / den * vscale, num1 / den * vscale), x.p.C);
  }
}

// --------------------------------------------------- the tail's regions
// in the work region: the pointer feature (R x D), the owned rows' vocab
// logits and switch, their pointer logits, the head's partials (two
// buffers)
__host__ __device__ inline int tail_floats(int R, int C, int D, int V, int S,
                                           int* part_at) {
  const int own = ceil_div(R, C);
  const int at = (R * D + own * (V + 1) + own * S + 3) / 4 * 4;
  if (part_at != nullptr) *part_at = at;
  return at + 2 * kChunkStrips * R * (D / 64) * 4;
}

// ---------------------------------------------------------- the kernel
// One decode step of rows [row0, row0 + Rv) by one cluster (see the note
// at the top). Grid: clusters * C blocks of kThreads, clusters of C.
__global__ void __launch_bounds__(kThreads, 1)
    step_kernel(const __grid_constant__ DecodeArgs a,
                const __grid_constant__ Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float sv[32];
  __shared__ int si[32];
  __shared__ int is_last;
  __shared__ int toks[kMaxRows];
  __shared__ float stat[2 * kMaxRows];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), C = p.C;
  const int cluster = blockIdx.x / C;
  Ctx x{a, p, cl, smem};
  x.rank = rank;
  x.row0 = cluster * p.R;
  x.Rv = min(p.R, (int)a.B - x.row0);
  x.tid = threadIdx.x;
  x.lane = x.tid & 31;
  x.warp = x.tid >> 5;
  x.xs = reinterpret_cast<float*>(smem + p.xs);
  x.a0 = reinterpret_cast<bf16*>(smem + p.a0);
  x.a1 = reinterpret_cast<bf16*>(smem + p.a1);
  x.qb = reinterpret_cast<bf16*>(smem + p.qb);
  x.stat = stat;
  x.bars = reinterpret_cast<uint64_t*>(smem + p.bars);
  x.idx = 0;
  Chunk* sched = reinterpret_cast<Chunk*>(smem + p.sched);
  x.sched = sched;

  // the weights depend on no earlier step: the ring fills while the
  // previous step ends
  int nl[3];
  x.nchunks = build_schedule(a, p, rank, sched, nl);
  x.NL = nl[0];
  x.drain_self = nl[1];
  x.drain_cross = nl[2];
  x.limit = nl[1];  // the ring drains before layer 0's self-attention
  x.lnp = reinterpret_cast<float*>(smem + p.lnp);
  if (x.tid == 0) {
    for (int s = 0; s < kStages + 3; ++s) mbar_init(&x.bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int first = 0;
  if (x.tid == 0) {
    while (first < kStages && issue(x, first)) ++first;
    load_norms(x, 0);
    load_norms(x, x.p.L);
  }
  {
    // the block's columns of every layer's product biases, by phase
    bf16* bt = reinterpret_cast<bf16*>(smem + p.bias);
    int off = 0;
    for (int ph = 0; ph < kHead; ++ph) {
      int s0, s1, K, strips;
      phase_chunks(a, p, ph, rank, s0, s1, K);
      phase_shape(a, ph, K, strips);
      const bf16* src = static_cast<const bf16*>(
          ph == kQkv ? a.bqkv : ph == kWo ? a.bo : ph == kCq ? a.cbq
          : ph == kCwo ? a.cbo : ph == kW1 ? a.b1 : a.b2);
      const int n = (s1 - s0) * 8, N = strips * 8;
      x.boff[ph] = off;
      for (int i = x.tid; i < x.p.L * n; i += kThreads)
        bt[i / n * p.bias_cols + off + i % n] =
            src[(long long)(i / n) * N + s0 * 8 + i % n];
      off += n;
    }
    x.bias = bt;
    // and of the head's (f32, columns past V + D + 1 as 0)
    int s0, s1, K;
    phase_chunks(a, p, kHead, rank, s0, s1, K);
    float* hb = reinterpret_cast<float*>(smem + p.hbias);
    const int NH = (int)(a.V + a.D + 1);
    for (int i = x.tid; i < (s1 - s0) * 4; i += kThreads)
      hb[i] = s0 * 4 + i < NH ? a.head_b[s0 * 4 + i] : 0.f;
  }
  const int CL = p.parts;
  unsigned long long* tbits =
      reinterpret_cast<unsigned long long*>(smem + p.mtab);
  int* tany = reinterpret_cast<int*>(tbits + x.p.R * CL);
  {
    // what no step changes, while the previous step ends: the rows' masks,
    // the cross K/V scales (L, R, kvH) for K then V, and which spans of
    // the masks hold a real key, by (row, part), and whether the row has
    // one (the cross kernel's first pass)
    const int Rv = x.Rv, Li = x.p.Li;
    uint8_t* mr = smem + p.mrows;
    const uint8_t* mg = a.mem_mask + (long long)x.row0 * Li;
#pragma unroll 4
    for (int i = x.tid; i < Rv * Li; i += kThreads) mr[i] = mg[i];
    float* scl = reinterpret_cast<float*>(smem + p.scl);
    for (int i = x.tid; i < 2 * x.p.L * Rv * x.p.kvH; i += kThreads) {
      const int kv = i / (x.p.L * Rv * x.p.kvH), r = i % (x.p.L * Rv * x.p.kvH);
      const int l = r / (Rv * x.p.kvH), b = r / x.p.kvH % Rv, c = r % x.p.kvH;
      const float* src = kv ? a.cv_scale : a.ck_scale;
      scl[((size_t)kv * x.p.L + l) * x.p.R * x.p.kvH + b * x.p.kvH + c] =
          src[((long long)l * a.B + x.row0 + b) * x.p.kvH + c];
    }
    for (int i = x.tid; i < Rv * CL; i += kThreads) tbits[i] = 0;
    for (int i = x.tid; i < Rv; i += kThreads) tany[i] = 0;
    __syncthreads();
    const int nsp = ceil_div(Li, kSpan);
    for (int i = x.tid; i < Rv * nsp; i += kThreads) {
      const int b = i / nsp, z = i % nsp, j0 = z * kSpan;
      const int n = min(kSpan, Li - j0);
      int real = 0;
      for (int j = 0; j < n; ++j) real |= !mr[b * Li + j0 + j];
      if (real) {
        atomicOr(&tbits[b * CL + z % CL], 1ull << (z / CL));
        tany[b] = 1;
      }
    }
  }
  follow_previous();
  if (*a.halt) {  // no copy outlives the block
    if (x.tid == 0) {
      for (int s = 0; s < first; ++s) mbar_wait(&x.bars[s], 0);
      mbar_wait(&x.bars[kStages], 0);
      mbar_wait(&x.bars[kStages + 2], 0);
    }
    return;
  }
  const int t = *a.num_steps, D = x.p.D, S = x.p.S, V = x.p.V, Rv = x.Rv;
  x.t = t;
  if (x.tid < Rv)
    toks[x.tid] = t > 0 ? a.output[(long long)(x.row0 + x.tid) * S + t - 1]
                        : 0;
  __syncthreads();
  // this step's input: value[token] + coord[(t-1) % dof] + pos[(t-1) / dof]
  // of the token sampled at t - 1 (zero at step 0), as sample_kernel sets it
  {
    const int ci = (t + (int)a.dof - 1) % (int)a.dof, pi = (t - 1) / (int)a.dof;
#pragma unroll 4
    for (int i = x.tid; i < Rv * D; i += kThreads) {
      const int m = i / D, d = i % D;
      float v = 0.f;
      if (t > 0) {
        const int prev = min(max(toks[m], 0), V - 1);
        v = (__ldg(a.emb_value + (long long)prev * D + d) +
             __ldg(a.emb_coord + ci * D + d)) +
            __ldg(a.emb_pos + pi * D + d);
      }
      x.xs[m * x.p.xp + d] = v;
    }
  }
  __syncthreads();
  cl.sync();  // every block of the cluster runs: shared memory is mapped

  for (int l = 0; l < x.p.L; ++l) {
    // the next layer's norms while this one runs (their buffer's last
    // reader, the layer before's LN3, is done)
    if (x.tid == 0 && l + 1 < x.p.L) load_norms(x, l + 1);
    const float* ln = norms(x, l);
    layer_norm(x, ln, ln + D, x.a0, x.p.a0p);
    product<kEpiQkv>(x, l, kQkv, x.a0, x.p.a0p);
    cl.sync();
    self_attention(x, l);
    refill(x, l * x.NL + x.drain_cross);
    cl.sync();
    product<kEpiRes>(x, l, kWo, x.a1, x.p.a1p);
    cl.sync();
    layer_norm(x, ln + 2 * D, ln + 3 * D, x.a0, x.p.a0p);
    product<kEpiQ>(x, l, kCq, x.a0, x.p.a0p);
    cl.sync();
    cross_attention(x, l);
    refill(x, l + 1 < x.p.L ? (l + 1) * x.NL + x.drain_self : x.nchunks);
    cl.sync();
    cross_combine(x, l);
    cl.sync();
    product<kEpiRes>(x, l, kCwo, x.a1, x.p.a1p);
    cl.sync();
    layer_norm(x, ln + 4 * D, ln + 5 * D, x.a0, x.p.a0p);
    product<kEpiRelu>(x, l, kW1, x.a0, x.p.a0p);
    cl.sync();
    product<kEpiRes>(x, l, kW2, x.a1, x.p.a1p);
    cl.sync();
  }

  // final norm (in place, and into the hidden cache at the step), head
  float* feat = reinterpret_cast<float*>(smem + p.work);  // R x D
  float* vl = feat + x.p.R * D;                 // owned rows x (V + 1)
  float* pb = vl + ceil_div(x.p.R, C) * (V + 1);  // owned rows x S
  int part_at;
  tail_floats(x.p.R, C, D, V, S, &part_at);
  const float* fln = norms(x, x.p.L);
  layer_norm(x, fln, fln + D, nullptr, 0);
  head(x, feat, vl, feat + part_at);
  cl.sync();

  // pointer logits: (row, key p < t) pairs over the cluster's warps,
  // kPtrPairs at a time, each in the pointer kernel's order, to the row's
  // owner
  {
    const int gw = rank * kWarps + x.warp, np = Rv * t;
    for (int q0 = gw * kPtrPairs; q0 < np; q0 += C * kWarps * kPtrPairs) {
      float dot[kPtrPairs];
      const float* fr[kPtrPairs];
      const float* hr[kPtrPairs];
#pragma unroll
      for (int k = 0; k < kPtrPairs; ++k) {
        const int q = min(q0 + k, np - 1), b = q / t, key = q % t;
        fr[k] = feat + b * D;
        hr[k] = a.h_cache + ((long long)(x.row0 + b) * S + key) * D;
        dot[k] = 0.f;
      }
#pragma unroll 4
      for (int d = x.lane; d < D; d += 32)
#pragma unroll
        for (int k = 0; k < kPtrPairs; ++k)
          dot[k] += fr[k][d] * __ldcg(hr[k] + d);
#pragma unroll
      for (int k = 0; k < kPtrPairs; ++k) {
        const float v = warp_sum(dot[k]);
        const int q = q0 + k, b = q / t, key = q % t;
        if (x.lane == 0 && q < np)
          *cl.map_shared_rank(pb + (b / C) * S + key, b % C) = v / D;
      }
    }
  }
  cl.sync();

  // sampling of the rows this block owns: sample_kernel's tail
  for (int b = rank; b < Rv; b += C) {
    const float* row = vl + (b / C) * (V + 1);
    const float* pl = pb + (b / C) * S;
    const long long rg = x.row0 + b;
    const float prob = 1.f / (1.f + expf(-row[V]));
    float lv = -INFINITY;
    int li = 0x7fffffff;
    for (int v = x.tid; v < V; v += kThreads) arg_better(lv, li, row[v], v);
    block_argmax(lv, li, sv, si);
    const float vmax = lv;
    const int vocab_idx = li;
    float s = 0.f;
    for (int v = x.tid; v < V; v += kThreads) s += expf(row[v] - vmax);
    const float vsum = block_sum(s, sv);
    float mv = -INFINITY;
    int mi = 0x7fffffff;
    for (int v = x.tid; v < V; v += kThreads)
      arg_better(mv, mi, expf(row[v] - vmax) / vsum * (1.f - prob), v);
    block_argmax(mv, mi, sv, si);
    float pm = -INFINITY;
    for (int q = x.tid; q < t; q += kThreads) pm = fmaxf(pm, pl[q]);
    pm = block_max(pm, sv);
    float ps = 0.f;
    for (int q = x.tid; q < t; q += kThreads) ps += expf(pl[q] - pm);
    ps = block_sum(ps, sv);
    float bp = -INFINITY;
    int bi = 0x7fffffff;
    for (int q = x.tid; q <= t; q += kThreads) {
      float pp = t == 0 ? 1.f / S : (q < t ? expf(pl[q] - pm) / ps : 0.f);
      pp *= prob;
      if (a.struct_mask[(long long)t * S + q] == 0.f) pp = kEps;
      arg_better(bp, bi, pp, q);
    }
    block_argmax(bp, bi, sv, si);
    if (x.tid == 0) {
      const int mixed = bp > mv ? V + bi : mi;
      const int idx = t + 1 < (int)a.dof ? vocab_idx : mixed;
      const bool is_ptr = idx >= V;
      const int ptr = min(max(idx - V, 0), S - 1);
      const int token = is_ptr ? a.output[rg * S + ptr] : idx;
      a.output[rg * S + t] = token;
      a.attach[rg * S + t] = is_ptr ? ptr : -1;
      if (token == (int)a.end_token) a.done[rg] = 1;
      __threadfence();
    }
    __syncthreads();
  }
  cl.sync();

  // the last cluster to finish (an atomic count it resets; it never waits)
  // advances the step and sets `halt` once every row is done or the last
  // step ran
  if (rank != 0) return;
  if (x.tid == 0) {
    __threadfence();
    is_last = atomicAdd(a.counter, 1) == p.clusters - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  int all = 1;
  for (int r = x.tid; r < (int)a.B; r += kThreads)
    all &= __ldcg(&a.done[r]) != 0;
  all = __syncthreads_and(all);
  if (x.tid == 0) {
    *a.counter = 0;
    *a.num_steps = t + 1;
    if ((a.early_exit && all) || t + 1 == S) *a.halt = 1;
  }
}

// ------------------------------------------------------------- the plan
// every region but the ring, for R rows; bytes in all
static int layout(const DecodeArgs& a, Plan& p) {
  const int D = (int)a.D, F = (int)a.F, S = (int)a.S, Dh = (int)a.Dh;
  const int G = (int)(a.H / a.kvH), V = (int)a.V, R = p.R, C = p.C;
  int off = kStages * p.stage;
  auto take = [&](long long bytes) {
    const int o = off;
    off = align128(off + (int)bytes);
    return o;
  };
  p.xs = take((long long)R * (D + 4) * 4);
  p.a0 = take((long long)R * (D + 8) * 2);
  p.a1 = take((long long)R * (std::max(D, F) + 8) * 2);
  p.qb = take((long long)R * D * 2);
  // the products' partials (two buffers) or the tail
  p.work = take(std::max(2LL * kChunkStrips * kSlices * R * 8 * 4,
                         4LL * tail_floats(R, C, D, V, S, nullptr)));
  p.part = take((long long)ceil_div(R * (int)a.kvH * p.parts, C) * G *
                (Dh + 2) * 4);
  p.mtab = take((long long)R * p.parts * 8 + R * 4);
  p.mrows = take((long long)R * a.Li);
  p.scl = take(2LL * a.L * R * a.kvH * 4);
  p.sched = take((long long)p.chunks * sizeof(Chunk));
  p.bias = take(2LL * a.L * p.bias_cols);
  int hK, hs;
  phase_shape(a, kHead, hK, hs);
  p.hbias = take(4LL * ceil_div(hs, C) * 4);
  p.lnp = take(4LL * 14 * D);
  p.bars = take((kStages + 3) * 8);
  p.smem = off;
  return off;
}

// The plan for this input: clusters of kClusterRanks blocks, as many rows a
// cluster as one wave of the clusters the card holds at once needs
// (cudaOccupancyMaxActiveClusters; at most kMaxRows), the ring's stages as
// large as the rest of shared memory leaves (at most kMaxStage, at least
// half of it and one strip of the widest K), and as many attention groups
// and staged spans as the ring holds. 0 or a CUDA error.
constexpr int kClusterRanks = 8;

// The clusters of kClusterRanks blocks at the most shared memory that the
// current device holds at once. They depend on the device alone, so the
// occupancy query (and the attribute it needs) runs once a device and
// every plan after it, the route's and the launch's, reads the answer.
static int held_clusters(int& held) {
  constexpr int kDevices = 64;
  static std::atomic<int> known[kDevices];  // 0: not asked yet
  int dev = 0;
  int e = (int)cudaGetDevice(&dev);
  if (e) return e;
  if (dev < kDevices && (held = known[dev].load()) > 0) return 0;
  e = (int)cudaFuncSetAttribute(
      step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterRanks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemLimit;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterRanks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  held = 0;
  if ((e = (int)cudaOccupancyMaxActiveClusters(&held, step_kernel, &cfg)))
    return e;
  if (held <= 0) return cudaErrorInvalidConfiguration;
  if (dev < kDevices) known[dev].store(held);
  return 0;
}

static int plan(const DecodeArgs& a, Plan& p) {
  const int B = (int)a.B, G = (int)(a.H / a.kvH), D = (int)a.D,
            F = (int)a.F, S = (int)a.S, Dh = (int)a.Dh;
  // the chain's products split K in kSlices slices: the step adds the same
  if (gemm::k_slices(D) != kSlices || gemm::k_slices(F) != kSlices)
    return cudaErrorInvalidValue;
  p.C = kClusterRanks;
  p.D = D, p.S = S, p.L = (int)a.L, p.kvH = (int)a.kvH, p.Dh = Dh, p.G = G;
  p.F = F, p.V = (int)a.V, p.Li = (int)a.Li, p.Dkv = p.kvH * Dh;
  p.xp = D + 4, p.a0p = D + 8, p.a1p = std::max(D, F) + 8;
  int CL;
  spans_per_rank((int)a.Li, CL);
  p.parts = CL;
  const int min_stage = std::max(D, F) * kStrip;
  const int e = held_clusters(p.held);
  if (e) return e;
  for (p.R = std::min(kMaxRows, ceil_div(B, p.held)); p.R >= 1; --p.R) {
    // the ring's chunks at the smallest stage taken, the most of any block
    p.stage = kMaxStage / 2;
    p.chunks = p.bias_cols = 0;
    for (int r = 0; r < p.C; ++r) {
      int n = 0, cols = 0, s0, s1, K;
      for (int ph = 0; ph < kHead; ++ph) {
        n += phase_chunks(a, p, ph, r, s0, s1, K);
        cols += (s1 - s0) * 8;
      }
      n = n * (int)a.L + phase_chunks(a, p, kHead, r, s0, s1, K);
      p.chunks = std::max(p.chunks, n);
      p.bias_cols = std::max(p.bias_cols, cols);
    }
    p.stage = 0;
    const int rest = layout(a, p);
    const int stage =
        std::min(kMaxStage, (kSmemLimit - rest) / kStages / 128 * 128);
    if (stage < std::max(min_stage, kMaxStage / 2)) continue;
    p.stage = stage;
    layout(a, p);
    const int ring = kStages * stage;
    p.ngs = std::min(kWarps / G, ring / self_group_bytes(G, S, Dh));
    p.aw = std::min(kWarps, ring / cross_warp_bytes(kCrossHeads, Dh));
    if (p.ngs < 1 || p.aw < 1) return cudaErrorInvalidValue;
    p.clusters = ceil_div(B, p.R);
    return 0;
  }
  return cudaErrorInvalidValue;
}

// the step kernel on `s`
static int launch(const DecodeArgs& a, const Plan& p, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.clusters * p.C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.pdl ? 2 : 1;
  return (int)cudaLaunchKernelEx(&cfg, step_kernel, a, p);
}

// The arguments of `a` for a step kernel that `launch` put into the graph
// `exec` was instantiated from (its node `node`): the launch's shape, with
// the cluster and the programmatic edge the node keeps from its capture.
static int set_args(cudaGraphExec_t exec, cudaGraphNode_t node,
                    const DecodeArgs& a, const Plan& p) {
  void* args[] = {const_cast<DecodeArgs*>(&a), const_cast<Plan*>(&p)};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(step_kernel);
  kp.gridDim = dim3(p.clusters * p.C);
  kp.blockDim = dim3(kThreads);
  kp.sharedMemBytes = p.smem;
  kp.kernelParams = args;
  return (int)cudaGraphExecKernelNodeSetParams(exec, node, &kp);
}

}  // namespace step

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
  const bool tc = a.is_bf16 && !a.simt_order;
  const bool pdl = a.pdl != 0;
  int e;
  for (int l = 0; l < (int)a.L; ++l) {
    const float* ln = a.ln + (long long)l * 6 * D;
    const long long cache = (long long)l * B * S * Dkv;
    // self-attention
    e = product<T, true>(tc, pdl, a.x, ln, nullptr,
                         wqkv + (long long)l * D * W, B, W, D,
                         QkvEpilogue<T>{bqkv + (long long)l * W, q,
                                        kc + cache, vc + cache, D, Dkv, S,
                                        a.num_steps, halt},
                         s);
    if (e) return e;
    e = launch(a, self_attn_kernel<T>, dim3(kvH, B), 32 * G,
               self_smem<T>(G, S, Dh), s, (const T*)q, (const T*)(kc + cache),
               (const T*)(vc + cache), att, S, D, kvH, Dh, scale,
               (const int*)a.num_steps, halt);
    if (e) return e;
    e = product<T, false>(tc, pdl, nullptr, nullptr, att,
                          wo + (long long)l * D * D, B, D, D,
                          RoundedEpilogue<T, float, kResidual>{
                              bo + (long long)l * D, a.x, D, D, halt},
                          s);
    if (e) return e;
    // cross-attention
    e = product<T, true>(tc, pdl, a.x, ln + 2 * D, nullptr,
                         cwq + (long long)l * D * D, B, D, D,
                         RoundedEpilogue<T, T, kStore>{
                             cbq + (long long)l * D, q2, D, D, halt},
                         s);
    if (e) return e;
    if ((e = launch_cross<T>(a, l, scale, s))) return e;
    e = product<T, false>(tc, pdl, nullptr, nullptr, att,
                          cwo + (long long)l * D * D, B, D, D,
                          RoundedEpilogue<T, float, kResidual>{
                              cbo + (long long)l * D, a.x, D, D, halt},
                          s);
    if (e) return e;
    // feed-forward
    e = product<T, true>(tc, pdl, a.x, ln + 4 * D, nullptr,
                         w1 + (long long)l * D * F, B, F, D,
                         RoundedEpilogue<T, T, kRelu>{b1 + (long long)l * F,
                                                      z, F, F, halt},
                         s);
    if (e) return e;
    e = product<T, false>(tc, pdl, nullptr, nullptr, z,
                          w2 + (long long)l * F * D, B, D, F,
                          RoundedEpilogue<T, float, kResidual>{
                              b2 + (long long)l * D, a.x, D, D, halt},
                          s);
    if (e) return e;
  }
  e = launch(a, final_norm_kernel, dim3(B), 128, 0, s, (const float*)a.x,
             a.final_ln, a.final_ln + D, a.h_cache, a.hf, S, D,
             (const int*)a.num_steps, halt);
  if (e) return e;
  e = product<float, false>(false, pdl, nullptr, nullptr, a.hf, a.head_w,
                            B, NHp,
                            D,
                            RoundedEpilogue<float, float, kStore>{
                                a.head_b, a.head_out, NH, NH, halt},
                            s);
  if (e) return e;
  e = launch(a, pointer_kernel, dim3((S + kPtrKeys - 1) / kPtrKeys, B),
             32 * kPtrKeys, 0, s, (const float*)a.head_out,
             (const float*)a.h_cache, a.ptr, S, D, V,
             (const int*)a.num_steps, halt);
  if (e) return e;
  return launch(a, sample_kernel, dim3(B), 256, 0, s, a);
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
         a.dof > 0 && (!a.step || (a.is_bf16 && !a.simt_order));
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
