// Shared helpers for the port's CUDA kernels: element conversion between
// float and the two storage types (float, bf16), block reductions, the
// row layer norm and the split-K GEMM of the decode loops.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace plank {

template <typename T> struct Elem;

template <> struct Elem<float> {
  __device__ __forceinline__ static float load(float v) { return v; }
  __device__ __forceinline__ static float store(float v) { return v; }
  // value after rounding to this type (identity for float)
  __device__ __forceinline__ static float round(float v) { return v; }
};

template <> struct Elem<__nv_bfloat16> {
  __device__ __forceinline__ static float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  __device__ __forceinline__ static __nv_bfloat16 store(float v) {
    return __float2bfloat16(v);  // round to nearest even
  }
  __device__ __forceinline__ static float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// (value, index) argmax that keeps the FIRST index among equal maxima,
// as jnp.argmax / torch.argmax do.
__device__ __forceinline__ void arg_better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    arg_better(v, i, v2, i2);
  }
}

// Block-wide reductions; every thread of the block must call them, and
// every thread gets the result. `scratch` holds at least 32 floats / ints.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = 0.f;
  for (int w = 0; w < nwarps; ++w) r += scratch[w];
  return r;
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nwarps = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < nwarps; ++w) r = fmaxf(r, scratch[w]);
  return r;
}

__device__ __forceinline__ void block_argmax(float& v, int& i, float* sv,
                                             int* si) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nwarps = (blockDim.x + 31) >> 5;
  warp_argmax(v, i);
  __syncthreads();
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
  for (int w = 1; w < nwarps; ++w) arg_better(v, i, sv[w], si[w]);
}

// ------------------------------------------------------------ layernorm
// One block per row: out = (x - mean) / sqrt(var + 1e-5) * scale + bias,
// stored in OutT. `halt` (may be null): return at once when it is set.
template <typename OutT>
__global__ void layernorm_kernel(const float* __restrict__ x,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ bias, OutT* out,
                                 long long out_stride, int D,
                                 const int* halt) {
  __shared__ float scratch[32];
  if (halt != nullptr && *halt) return;
  const int b = blockIdx.x;
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
  OutT* o = out + (long long)b * out_stride;
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    o[d] = Elem<OutT>::store((xr[d] - mean) * inv * scale[d] + bias[d]);
}

// ----------------------------------------------------------------- GEMM
// epi(m, n, A (M x K, row stride lda) @ W (K x N, row-major)) for every
// output, with f32 accumulation; A and W in T. The decode loops' products
// are skinny (M = rows <= 64, N and K 512-1536): tiled over (M, N) alone
// they give 8-34 blocks that each walk all of K, so the card sits mostly
// idle. Here K is split too: block (n, m, z) covers kKSlice rows of K for
// a 32 x 64 output tile (256 threads, 2 x 4 outputs each, K staged in
// shared memory as f32) and writes its partial tile to the workspace
// `ws` (ceil(K / kKSlice) * M * N floats). The last block to finish a tile
// — it learns so from an atomic counter, it never waits — sums the
// partials in slice order (deterministic), calls the epilogue and resets
// the tile's counter to zero for the next product. `halt` (may be null):
// return at once when it is set.
enum Epilogue { kStore = 0, kRelu = 1, kResidual = 2 };
constexpr int kBM = 32, kBN = 64, kBK = 32, kKSlice = 64;

template <typename T, typename Epi>
__global__ void __launch_bounds__(256)
    splitk_gemm_kernel(const T* __restrict__ A, long long lda,
                       const T* __restrict__ W, int M, int N, int K, Epi epi,
                       float* ws, int* counters, const int* halt) {
  __shared__ float as[kBK][kBM + 1];
  __shared__ float ws_tile[kBK][kBN];
  __shared__ int is_last;
  if (halt != nullptr && *halt) return;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int z = blockIdx.z, nsplit = gridDim.z;
  const int kbeg = z * kKSlice, kend = min(K, kbeg + kKSlice);
  float acc[2][4] = {};
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    for (int idx = threadIdx.x; idx < kBM * kBK; idx += 256) {
      int r = idx / kBK, kk = idx % kBK;
      int m = m0 + r, kq = k0 + kk;
      as[kk][r] = (m < M && kq < kend)
                      ? Elem<T>::load(A[(long long)m * lda + kq]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < kBK * kBN; idx += 256) {
      int kk = idx / kBN, c = idx % kBN;
      int kq = k0 + kk, n = n0 + c;
      ws_tile[kk][c] = (kq < kend && n < N)
                           ? Elem<T>::load(W[(long long)kq * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a0 = as[kk][ty * 2], a1 = as[kk][ty * 2 + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float w = ws_tile[kk][tx * 4 + j];
        acc[0][j] += a0 * w;
        acc[1][j] += a1 * w;
      }
    }
    __syncthreads();
  }
  // partial tile -> workspace [z][M][N]; the last block of the tile sums
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int m = m0 + ty * 2 + i, n = n0 + tx * 4 + j;
      if (m < M && n < N) ws[((long long)z * M + m) * N + n] = acc[i][j];
    }
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0)
    is_last = atomicAdd(&counters[tile], 1) == nsplit - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int m = m0 + ty * 2 + i, n = n0 + tx * 4 + j;
      if (m >= M || n >= N) continue;
      float sum = 0.f;
      for (int zz = 0; zz < nsplit; ++zz)
        sum += __ldcg(&ws[((long long)zz * M + m) * N + n]);
      epi(m, n, sum);
    }
  if (threadIdx.x == 0) counters[tile] = 0;  // ready for the next product
}

template <typename T, typename Epi>
static void splitk_gemm(const void* A, long long lda, const void* W, int M,
                        int N, int K, Epi epi, float* ws, int* counters,
                        const int* halt, cudaStream_t s) {
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM,
            (K + kKSlice - 1) / kKSlice);
  splitk_gemm_kernel<T, Epi><<<grid, 256, 0, s>>>(
      static_cast<const T*>(A), lda, static_cast<const T*>(W), M, N, K, epi,
      ws, counters, halt);
}

}  // namespace plank
