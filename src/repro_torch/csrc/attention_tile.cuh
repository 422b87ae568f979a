// One warp's online-softmax update of RPW query rows against a block of 32
// keys staged in shared memory: the inner step shared by the prefill
// (flash_attention.cu) and span decode (decode_attention.cu) kernels.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int ATT_BK = 32;          // keys per block: lane j scores key j
constexpr float ATT_NEG = -1e30f;

// Shared-memory row strides (floats): K rows are padded by 4 so that lane j
// reading 16 bytes of key j is free of bank conflicts.
template <int D>
struct AttnSmem {
  static constexpr int K_STRIDE = D + 4;
  static constexpr int V_STRIDE = D;
};

// 16-byte loads: 4 float32 or 8 bf16 elements, widened to float.
__device__ __forceinline__ void load16(const float* src, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src,
                                       float (&out)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Stage ATT_BK rows of D elements (row j at base + j * row_stride; rows at
// or past n_in read as zeros) into shared floats with row stride sstride,
// 16 bytes per load. base and row_stride must keep 16-byte alignment.
template <typename T, int D, int NT>
__device__ __forceinline__ void stage_rows(const T* __restrict__ base,
                                           long row_stride, int n_in,
                                           float* dst, int sstride) {
  constexpr int N = 16 / sizeof(T);
  constexpr int PER_ROW = D / N;
  for (int i = threadIdx.x; i < ATT_BK * PER_ROW; i += NT) {
    const int j = i / PER_ROW, c = (i % PER_ROW) * N;
    float v[N];
    if (j < n_in) {
      load16(base + j * row_stride + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) dst[j * sstride + c + e] = v[e];
  }
}

// A lane keeps CPL = ceil(D / 32) contiguous output columns from column
// lane * CPL. Where 32 does not divide D (head_dim 80: 3 columns a lane),
// the last lanes' columns run past D: `has(c)` says which are real, and
// those past D read zeros and are never written.
template <int D, int RPW>
struct WarpRows {
  static constexpr int CPL = (D + 31) / 32;
  static constexpr bool EVEN = D % 32 == 0;
  float m[RPW], l[RPW], acc[RPW][CPL];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      m[r] = ATT_NEG;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[r][c] = 0.f;
    }
  }

  // qrows: RPW rows of D pre-scaled floats; sK [32][D+4]; sV [32][D];
  // valid[r]: may this lane's key serve row r.
  __device__ __forceinline__ void update(const float* qrows, const float* sK,
                                         const float* sV,
                                         const bool (&valid)[RPW]) {
    const int lane = threadIdx.x & 31;
    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(
        sK + lane * AttnSmem<D>::K_STRIDE);
    const float4* q4 = reinterpret_cast<const float4*>(qrows);
#pragma unroll 4
    for (int i = 0; i < D / 4; ++i) {
      const float4 kv = k4[i];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qv = q4[r * (D / 4) + i];  // same address: broadcast
        s[r] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }
    float p[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float sc = valid[r] ? s[r] : ATT_NEG;
      const float m_new = fmaxf(m[r], warp_max(sc));
      p[r] = valid[r] ? __expf(sc - m_new) : 0.f;
      const float alpha = __expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[r][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < ATT_BK; ++j) {
      float v[CPL];
      const float* vrow = sV + j * AttnSmem<D>::V_STRIDE + lane * CPL;
      if constexpr (CPL % 4 == 0) {
#pragma unroll
        for (int c = 0; c < CPL; c += 4) {
          const float4 t = *reinterpret_cast<const float4*>(vrow + c);
          v[c] = t.x; v[c + 1] = t.y; v[c + 2] = t.z; v[c + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < CPL; ++c) v[c] = has(c) ? vrow[c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[r][c] += pj * v[c];
      }
    }
  }

  // this lane's CPL contiguous output columns start at column lane * CPL
  __device__ __forceinline__ int col0() const {
    return (threadIdx.x & 31) * CPL;
  }

  // is this lane's column col0() + c one of the D real columns?
  __device__ __forceinline__ bool has(int c) const {
    return EVEN || col0() + c < D;
  }
};

}  // namespace rt
