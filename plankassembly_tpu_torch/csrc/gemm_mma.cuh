// Split-K GEMM over a thread-block cluster for the products of the decode
// loop (csrc/decode.cu) and the fused decode layer (csrc/fused_decode.cu),
// on the tensor cores or in the SIMT GEMM's order: out = epi(m, n, A (M x
// K) . W (K x N)), A and W in T (bf16 or f32), f32 accumulation,
// optionally with A = LayerNorm(x) computed in the cluster from f32 x.
//
// Replaces, in part: the products inside plankassembly_tpu/ops/
// fused_decode.py::fused_decoder_layer (`_kernel`) and fused_ffn
// (`_ffn_kernel`), which the TPU runs on its MXU.
//
// What bounds it on an H100: bytes and latency. At the decode batch
// (M = B <= 32 rows) a product reads its K x N weights once (0.5-1.5 MB in
// bf16) and does 2 * M flops per weight, ~32 flops a byte, below the
// ridge; a call lasts microseconds, so what counts is how soon every SM
// has its bytes in flight and how short the chain after them is. The
// design:
//
// - A block owns a 32 x 32 output tile and one K slice of K / S rows; the
//   S = 8 blocks of a tile (fewer when K is small) form a thread-block
//   cluster: 128-384 blocks for the layer's products.
// - Its W slice (at most 128 x 32, 8 KB in bf16) and, when A is in T
//   already, its A slice arrive by 16-byte cp.async, all issued at once:
//   one slice a block, so a ring of stages would hold nothing more.
// - The LayerNorm prologue (K = D, 8 ranks): while the W copy is in
//   flight, rank z computes the mean and 1 / std of 4 of the tile's 32
//   rows of x in the row layer norm's exact order of f32 operations and
//   shares them through distributed shared memory; each rank then rounds
//   its own slice of the normalised rows to T into shared memory. This
//   takes the separate LayerNorm launch and its round trip out, reads each
//   row of x about twice in all, and leaves the values bit for bit those
//   of the LayerNorm kernel.
// - On the tensor cores (kTC, bf16 only): four warps, each a 16 x 16
//   quarter of the tile, mma.sync.m16n8k16 bf16 with f32 accumulation, A
//   by ldmatrix and W (k-major) by ldmatrix.trans, from rows padded by 16
//   bytes so that both are free of bank conflicts. Each product of two
//   bf16 values is exact in f32, as in the SIMT GEMM; only the summation
//   order moves.
// - In the SIMT GEMM's order (kTC false; every f32 product, and the bf16
//   products that csrc/fused_decode.cu keeps in that order, and says
//   why): the arithmetic of the split-K SIMT GEMM the decode loops used
//   first, f32 fused multiply-adds from 0 in k order over slices of 64,
//   the slices added in order. A rank takes one slice, or two when K / 64
//   passes the 8 ranks of a cluster, each with its own partial.
// - Split-K through the cluster: each rank leaves its partial tile(s) in
//   its shared memory; after a cluster barrier, rank z adds its 32 / S
//   rows of the ranks' partials in rank (slice) order (deterministic) and
//   applies the epilogue. No workspace, counter or fence in device memory.
#pragma once

#include <cooperative_groups.h>

#include <initializer_list>
#include <type_traits>
#include <utility>

#include "attn_mma.cuh"

namespace plank {
namespace gemm {

using bf16 = __nv_bfloat16;

constexpr int kBM = 32, kBN = 32, kMaxKS = 128, kThreads = 128;

// the eight bf16 of a 16-byte piece as floats (exact: a bf16 is the top
// half of an f32)
__device__ __forceinline__ void bf16x8(const uint4& raw, float (&f)[8]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    f[i] = __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
}

// A = LayerNorm(x) (eps 1e-5) with f32 x (M x K), scale and bias (K)
struct LnArgs {
  const float* x;
  const float* scale;
  const float* bias;
};

// the eight values of T at p (16-byte aligned) as floats (exact: a bf16
// is the top half of an f32)
__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  bf16x8(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

constexpr int kSimtSlice = 64;  // K rows of a slice in the SIMT order

// sub-slices of 64 a rank adds on the SIMT route (one partial each)
template <bool kTC>
constexpr int kParts = kTC ? 1 : 2;

// An epilogue with a member `halt` (a device int) is the decode loop's
// (csrc/decode.cu): the kernel issues its weights' copies (which no
// earlier kernel writes), then waits for the previous kernel of the stream
// (a programmatic dependent launch; a no-op for a launch that did not
// allow the overlap), lets the next one start, and stops at once while
// *halt is set (every block of a cluster reads the same value). Other
// epilogues compile to the kernel without any of this.
template <typename Epi, typename = void>
struct Halts : std::false_type {};
template <typename Epi>
struct Halts<Epi, std::void_t<decltype(std::declval<Epi&>().halt)>>
    : std::true_type {};

template <bool kTC, typename T, bool LN, typename Epi>
__global__ void __launch_bounds__(kThreads)
    cluster_gemm_kernel(const T* __restrict__ A, long long lda, LnArgs ln,
                        const T* __restrict__ W, int M, int N, int K,
                        Epi epi) {
  namespace cg = cooperative_groups;
  static_assert(!kTC || std::is_same<T, bf16>::value,
                "the tensor-core route takes bf16");
  constexpr int E = 16 / sizeof(T);  // values of T in a 16-byte copy
  __shared__ __align__(16) T As[kBM][kMaxKS + E];
  __shared__ __align__(16) T Bs[kMaxKS][kBN + E];
  __shared__ float part[kParts<kTC>][kBM][kBN + 1];  // partial tile(s)
  __shared__ float stat[2][kBM];  // LN: each row's mean, 1 / std
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int S = gridDim.z, z = blockIdx.z, KS = K / S, k0 = z * KS;

  for (int i = tid; i < KS * (kBN / E); i += kThreads) {
    const int kk = i / (kBN / E), c = i % (kBN / E);
    attn::cp_async16(&Bs[kk][c * E], W + (long long)(k0 + kk) * N + n0 + c * E,
                     16);
  }
  if constexpr (Halts<Epi>::value) {
    asm volatile("griddepcontrol.wait;" ::: "memory");
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    if (*epi.halt) {
      attn::cp_async_commit();
      attn::cp_async_wait<0>();  // no copy outlives the block
      return;
    }
  }
  if constexpr (!LN) {
    const int pr = KS / E;
    for (int i = tid; i < kBM * pr; i += kThreads) {
      const int rr = i / pr, c = i % pr, m = m0 + rr;
      const bool ok = m < M;
      attn::cp_async16(&As[rr][c * E],
                       A + (long long)(ok ? m : 0) * lda + k0 + c * E,
                       ok ? 16 : 0);
    }
  }
  attn::cp_async_commit();
  if constexpr (LN) {
    // LayerNorm in the row layer norm's own arithmetic (decode.cu's
    // final_norm_kernel), so that the rounding to bf16 sees the same f32
    // values (a value that lands on the other side of a bf16 rounding
    // point moves the layer's output by ~1e-4 of a row). That kernel gives
    // a row 128 threads: thread t adds x[t], x[t + 128], ... from 0, a
    // warp adds its 32 by the xor butterfly, and the 4 warps' sums are
    // added in order. Here rank z computes rows
    // [Rz, Rz + R), R = 32 / S: warp w rows Rz + w, Rz + w + 4, ..., 8
    // lanes per emulated warp qt, lane u holding its threads t = 32 qt + u
    // + 8i, i < 4 (the butterfly's first two levels inside the lane, the
    // last three by shuffles).
    const int R = kBM / S;
    for (int rr = z * R + warp; rr < (z + 1) * R; rr += kThreads / 32) {
      const int qt = lane >> 3, u = lane & 7;
      const int m = m0 + rr, J = K / 128;
      const float* xr = ln.x + (long long)(m < M ? m : 0) * K;
      float xv[kMaxKS * 8 / 128][4], p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kMaxKS * 8 / 128; ++j)
        if (j < J)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            xv[j][i] = xr[32 * qt + u + 8 * i + 128 * j];
            p[i] += xv[j][i];
          }
      auto tree = [&](float (&v)[4]) {
        v[0] += v[2];
        v[1] += v[3];
        v[0] += v[1];
        for (int h = 4; h >= 1; h >>= 1)
          v[0] += __shfl_xor_sync(0xffffffffu, v[0], h);
        float tot = 0.f;
        for (int w = 0; w < 4; ++w)
          tot += __shfl_sync(0xffffffffu, v[0], 8 * w);
        return tot;
      };
      const float mean = tree(p) / K;
      float q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kMaxKS * 8 / 128; ++j)
        if (j < J)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float c = xv[j][i] - mean;
            q[i] += c * c;
          }
      const float var = tree(q) / K;
      if (lane == 0) {
        stat[0][rr] = mean;
        stat[1][rr] = 1.f / sqrtf(var + 1e-5f);
      }
    }
    // this rank's slice of every row, loaded before the barrier: (x -
    // mean) * inv * scale + bias once the rows' statistics are in
    const int rr = tid >> 2, qt = tid & 3, m = m0 + rr;
    const float* xr = ln.x + (long long)(m < M ? m : 0) * K + k0;
    float xs[kMaxKS / 4], ss[kMaxKS / 4], bs[kMaxKS / 4];
#pragma unroll
    for (int i = 0; i < kMaxKS / 4; ++i)
      if (qt + 4 * i < KS) {
        xs[i] = xr[qt + 4 * i];
        ss[i] = ln.scale[k0 + qt + 4 * i];
        bs[i] = ln.bias[k0 + qt + 4 * i];
      }
    cluster.sync();
    const float mean = cluster.map_shared_rank(&stat[0][0], rr / R)[rr];
    const float inv = cluster.map_shared_rank(&stat[1][0], rr / R)[rr];
#pragma unroll
    for (int i = 0; i < kMaxKS / 4; ++i)
      if (qt + 4 * i < KS)
        As[rr][qt + 4 * i] = Elem<T>::store(
            m < M ? (xs[i] - mean) * inv * ss[i] + bs[i] : 0.f);
  }
  attn::cp_async_wait<0>();
  __syncthreads();

  if constexpr (kTC) {
    // warp w: rows 16 (w & 1) + [0, 16), columns 16 (w >> 1) + [0, 16)
    const int mt = warp & 1, nh = warp >> 1;
    float acc[2][4] = {};
    for (int kk = 0; kk < KS; kk += 16) {
      unsigned int a[4], b[4];
      attn::ldsm_x4(a, attn::smem_u32(
                           &As[16 * mt + (lane & 7) + ((lane >> 3) & 1) * 8]
                              [kk + (lane >> 4) * 8]));
      attn::ldsm_x4_trans(b, attn::smem_u32(
                                 &Bs[kk + (lane & 7) + ((lane >> 3) & 1) * 8]
                                    [16 * nh + (lane >> 4) * 8]));
      attn::mma(acc[0], a, b[0], b[1]);
      attn::mma(acc[1], a, b[2], b[3]);
    }
    // accumulator element (j, i): row (lane / 4) + 8 (i / 2), column
    // 8 j + 2 (lane % 4) + i % 2 of the warp's quarter
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        part[0][16 * mt + (lane >> 2) + (i >> 1) * 8]
            [16 * nh + 8 * j + (lane & 3) * 2 + (i & 1)] = acc[j][i];
  } else {
    // the SIMT GEMM's arithmetic: each output's products added
    // by fused multiply-adds from 0 in k order over each slice of 64
    const int rr = tid >> 2, c0 = (tid & 3) * 8;
    for (int sl = 0; sl < KS / kSimtSlice; ++sl) {
      float acc[8] = {};
      for (int k8 = sl * kSimtSlice; k8 < (sl + 1) * kSimtSlice; k8 += 8) {
        float a[8];
        load8(&As[rr][k8], a);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          float w[8];
          load8(&Bs[k8 + kk][c0], w);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] += a[kk] * w[j];
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) part[sl][rr][c0 + j] = acc[j];
    }
  }
  cluster.sync();

  // rank z sums rows [z * 32 / S, (z + 1) * 32 / S) of the tile over the
  // ranks' partials, in rank (slice) order, and applies the epilogue; the
  // partials are read first, all at once, then added
  constexpr int kMaxRanks = 8;
  const int rows = kBM / S, parts = kTC ? 1 : KS / kSimtSlice;
  for (int i = tid; i < rows * kBN; i += kThreads) {
    const int r = z * rows + i / kBN, c = i % kBN;
    float v[kMaxRanks][kParts<kTC>];
#pragma unroll
    for (int q = 0; q < kMaxRanks; ++q)
#pragma unroll
      for (int sl = 0; sl < kParts<kTC>; ++sl)
        if (q < S && sl < parts)
          v[q][sl] = cluster.map_shared_rank(&part[0][0][0], q)
                         [(sl * kBM + r) * (kBN + 1) + c];
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxRanks; ++q)
#pragma unroll
      for (int sl = 0; sl < kParts<kTC>; ++sl)
        if (q < S && sl < parts) sum += v[q][sl];
    if (m0 + r < M) epi(m0 + r, n0 + c, sum);
  }
  cluster.sync();  // the partials stay until every rank has read them
}

// K slices (cluster ranks) of a product: the most of 8, 4, 2, 1 that
// leaves slices of at most kMaxKS rows, multiples of 16; 0 if none does
static int k_slices(int K) {
  for (int S : {8, 4, 2, 1})
    if (K % (16 * S) == 0 && K / S <= kMaxKS) return S;
  return 0;
}

// K slices (cluster ranks) of a product in the SIMT GEMM's order: one
// slice of 64 a rank, two when K / 64 passes 8; 0 if K is not a multiple
// of 64 or passes 16 slices
static int simt_slices(int K) {
  const int n = K % kSimtSlice ? 0 : K / kSimtSlice;
  return n <= 8 ? n : (n <= 16 && n % 2 == 0 ? n / 2 : 0);
}

// Launch on `s`: grid (N / 32, ceil(M / 32), S), clusters of the S
// blocks of one output tile; N a multiple of 32. On the tensor cores (kTC)
// S = k_slices(K); in the SIMT GEMM's order S = simt_slices(K), so that
// the slices and their order are that GEMM's. With LN (A ignored), K a
// multiple of 128. `pdl`: allow the launch to overlap the previous
// kernel's end (programmatic dependent launch; the decode loop's
// epilogues wait for it in the kernel).
template <bool kTC, typename T, bool LN, typename Epi>
static int cluster_gemm(const void* A, long long lda, LnArgs ln, const void* W,
                        int M, int N, int K, Epi epi, cudaStream_t s,
                        bool pdl = false) {
  const int S = kTC ? k_slices(K) : simt_slices(K);
  if (S == 0 || N % kBN || (LN && K % 128)) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / kBN, (M + kBM - 1) / kBM, S);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = S;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  return (int)cudaLaunchKernelEx(&cfg, cluster_gemm_kernel<kTC, T, LN, Epi>,
                                 static_cast<const T*>(A), lda, ln,
                                 static_cast<const T*>(W), M, N, K, epi);
}

}  // namespace gemm
}  // namespace plank
