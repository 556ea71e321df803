// Shared helpers for the port's CUDA kernels (built for sm_90a by
// qwen3_asr_tpu_torch/ops/build.py and bound through ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

// Large negative score used for masked attention columns: exp(NEG - m) is 0
// for any finite running max, and NEG - NEG is 0 rather than NaN (the same
// constant as qwen3_asr_tpu/ops/pallas_attention.py::_NEG).
#define QW_NEG (-0.7f * FLT_MAX)

__device__ __forceinline__ float bf2f(__nv_bfloat16 x) { return __bfloat162float(x); }

// A KV-cache element (int8 code or bf16 value) as f32.
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return bf2f(x); }

// float -> bf16 -> float: the rounding a bf16 store applies (nearest even).
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / max. `red` is shared scratch of at least 32 floats. Every
// thread of the block must call it; all get the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = lane < nw ? red[lane] : 0.f;
  r = warp_sum(r);
  return r;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = lane < nw ? red[lane] : QW_NEG;
  r = warp_max(r);
  return r;
}
