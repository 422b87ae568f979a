// Causal (optionally sliding-window) GQA prefill attention for Hopper.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, `flash_attention`
// (the Pallas TPU kernel whose grid walks KV blocks in order, carrying the
// online-softmax statistics in revisited output blocks).
//
// What bounds it on the card: at prefill lengths the work is 4*S^2/2*H*D
// operations against 4*S*H*D*bytes of input and output, so it is bound by
// operations. This first version computes in float32 on the CUDA cores
// (no tensor cores yet), so it sits far below the bf16 peak; `wgmma` and
// TMA are later work.
//
// Design: one CTA per (batch, head, block of BQ=32 queries), 4 warps of 8
// query rows each. A loop over KV blocks of 32 keys replaces the TPU's
// sequential grid axis; blocks wholly above the diagonal or wholly out of
// the window are never visited. A KV block is staged once in shared memory
// (float32; K rows padded to D+4 so that lane j reading key j 16 bytes at
// a time is free of bank conflicts) and serves all 32 queries of the CTA.
// Each lane scores one key for the warp's 8 rows, the softmax statistics
// are reduced with warp shuffles, and each lane keeps D/32 contiguous
// output columns of the 8 rows in registers (attention_tile.cuh). Any S is
// accepted: keys and queries past S are masked. Given an `lse` pointer
// ([B,H,S] float32) it also writes each query row's log-sum-exp of its
// scaled scores, m + log(l), from the statistics it already keeps (the TPU
// kernel's m and l outputs); the training path's backward reads it. With a
// null pointer the kernel does the same work as before.
#include "attention_tile.cuh"

namespace {

constexpr int BQ = 32;
constexpr int BK = rt::ATT_BK;
constexpr int WARPS = 4;
constexpr int RPW = BQ / WARPS;

// Dynamic shared memory per CTA: 98 816 bytes at D = 256, above the 48 KB
// a launch gets by default, so `launch` raises the limit for each
// instantiation before it launches.
template <int D>
constexpr size_t smem_bytes() {
  using S = rt::AttnSmem<D>;
  return sizeof(float) * (BQ * D + BK * S::K_STRIDE + BK * S::V_STRIDE);
}

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int S, int H, int Hkv, int window,
              float scale) {
  using SM = rt::AttnSmem<D>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [BQ][D], pre-scaled
  float* sK = sQ + BQ * D;                      // [BK][D+4]
  float* sV = sK + BK * SM::K_STRIDE;           // [BK][D]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long q_row = static_cast<long>(H) * D;
  const long kv_row = static_cast<long>(Hkv) * D;
  const T* qb = q + static_cast<long>(b) * S * q_row + static_cast<long>(h) * D;
  const T* kb = k + static_cast<long>(b) * S * kv_row + static_cast<long>(kvh) * D;
  const T* vb = v + static_cast<long>(b) * S * kv_row + static_cast<long>(kvh) * D;

  for (int i = tid; i < BQ * D; i += WARPS * 32) {
    const int r = i / D, d = i % D, qi = q0 + r;
    sQ[i] = qi < S ? rt::to_f(qb[qi * q_row + d]) * scale : 0.f;
  }

  rt::WarpRows<D, RPW> rows;
  rows.init();

  const int q_last = min(q0 + BQ, S) - 1;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  for (int k0 = k_begin; k0 <= q_last; k0 += BK) {
    __syncthreads();
    rt::stage_rows<T, D, WARPS * 32>(kb + k0 * kv_row, kv_row, S - k0, sK,
                                     SM::K_STRIDE);
    rt::stage_rows<T, D, WARPS * 32>(vb + k0 * kv_row, kv_row, S - k0, sV,
                                     SM::V_STRIDE);
    __syncthreads();
    const int kj = k0 + lane;
    bool valid[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qi = q0 + warp * RPW + r;
      valid[r] = kj < S && kj <= qi && (window <= 0 || kj > qi - window);
    }
    rows.update(sQ + warp * RPW * D, sK, sV, valid);
  }

  const int c0 = rows.col0();
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qi = q0 + warp * RPW + r;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(rows.l[r], 1e-30f);
    T* orow = o + static_cast<long>(b) * S * q_row + qi * q_row +
              static_cast<long>(h) * D + c0;
#pragma unroll
    for (int c = 0; c < rows.CPL; ++c)
      orow[c] = rt::from_f<T>(rows.acc[r][c] * inv);
    // m and l are warp-uniform; a row with no valid key has lse -inf
    if (lse != nullptr && lane == 0)
      lse[(static_cast<long>(b) * H + h) * S + qi] =
          rows.l[r] > 0.f ? rows.m[r] + logf(rows.l[r])
                          : -__int_as_float(0x7f800000);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int H, int Hkv, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd<T, D><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, Hkv, window,
      1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B,S,H,D], k/v [B,S,Hkv,D], o [B,S,H,D]; all contiguous, one dtype;
// lse [B,H,S] float32 or null. Returns a cudaError_t code (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int S, int H,
                                   int Hkv, int D, int window, int dtype,
                                   void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == RT_BF16 && D == 256)
    return launch<__nv_bfloat16, 256>(q, k, v, o, l, B, S, H, Hkv, window, st);
  if (dtype == RT_BF16 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, l, B, S, H, Hkv, window, st);
  if (dtype == RT_BF16 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, l, B, S, H, Hkv, window, st);
  if (dtype == RT_F32 && D == 256)
    return launch<float, 256>(q, k, v, o, l, B, S, H, Hkv, window, st);
  if (dtype == RT_F32 && D == 128)
    return launch<float, 128>(q, k, v, o, l, B, S, H, Hkv, window, st);
  if (dtype == RT_F32 && D == 64)
    return launch<float, 64>(q, k, v, o, l, B, S, H, Hkv, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
