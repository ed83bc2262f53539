// The greedy decode loop's step as one launch (step::step_kernel, bf16
// products on mma.sync): the route where the card holds every cluster of
// the step's plan at once. csrc/decode.cu holds the other route (the
// chain), the launch state that captures and replays either, and the
// loop's note; csrc/decode_common.cuh what the two share.
//
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

#include <algorithm>
#include <atomic>

#include "decode_common.cuh"

namespace plank {

// =================================================== the step as one launch
// The bf16 route (see the note at the top): one kernel a step, a cluster
// of C blocks per group of R rows. Every phase below is that of the chain
// (csrc/decode.cu), in the same f32 order, so the two routes give the same
// bits: the products' slices are the chain's split-K slices, added in its
// rank order; the layer norms, the attentions, the head, the pointer
// logits and the sampling repeat its kernels' arithmetic lane for lane.
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

int plan(const DecodeArgs& a, Plan& p) {
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
int launch(const DecodeArgs& a, const Plan& p, cudaStream_t s) {
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
  cfg.numAttrs = 2;
  return (int)cudaLaunchKernelEx(&cfg, step_kernel, a, p);
}

// The arguments of `a` for a step kernel that `launch` put into the graph
// `exec` was instantiated from (its node `node`): the launch's shape, with
// the cluster and the programmatic edge the node keeps from its capture.
int set_args(cudaGraphExec_t exec, cudaGraphNode_t node,
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

}  // namespace plank
