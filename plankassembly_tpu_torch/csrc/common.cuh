// Shared helpers for the port's CUDA kernels: element conversion between
// float and the two storage types (float, bf16) and block reductions.
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

// the epilogues of the decode products (csrc/decode.cu, fused_decode.cu)
enum Epilogue { kStore = 0, kRelu = 1, kResidual = 2 };

}  // namespace plank
