// Shared helpers of the port's CUDA kernels: element-type conversion, the
// expert FFN's activations and prefill order, warp reductions and the
// plain C error interface every library exports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed from Python (kernels/_lib.py: DTYPE_CODES)
enum { RT_F32 = 0, RT_BF16 = 1 };
// the route a launcher took, reported back to Python (kernels/_lib.py:
// ROUTES): CUDA cores, WMMA tensor cores, wgmma fed by TMA, or warp-level
// mma.sync fed by bulk copies
enum {
  RT_ROUTE_SIMT = 0,
  RT_ROUTE_WMMA = 1,
  RT_ROUTE_WGMMA = 2,
  RT_ROUTE_MMA = 3
};

namespace rt {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// Two adjacent elements as float2; the address must be 2-element aligned.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The expert FFN's activations (swiglu's gate, tanh-approximated gelu).
__device__ __forceinline__ float silu(float x) { return x / (1.f + __expf(-x)); }
__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The fused expert FFNs' prefill order: the slot of rank `rank` among the
// U slots by live rows (counts clamped to [0, C]), most first, ties by
// index, so the CTAs with the most rows start in the first wave. Called
// by every thread of the CTA; at most LPT_MAX slots.
constexpr int LPT_MAX = 512;
__device__ __forceinline__ int slot_by_rows(const int* counts, int U, int C,
                                            int rank) {
  __shared__ int s_cnt[LPT_MAX];
  __shared__ int s_slot;
  for (int i = threadIdx.x; i < U; i += blockDim.x)
    s_cnt[i] = min(max(counts[i], 0), C);
  __syncthreads();
  for (int i = threadIdx.x; i < U; i += blockDim.x) {
    const int ci = s_cnt[i];
    int r = 0;
    for (int j = 0; j < U; ++j)
      r += s_cnt[j] > ci || (s_cnt[j] == ci && j < i);
    if (r == rank) s_slot = i;
  }
  __syncthreads();
  return s_slot;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace rt

// Each library loaded with ctypes (RTLD_LOCAL) exports its own copy.
extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
