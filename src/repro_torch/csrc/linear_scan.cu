// The RG-LRU's linear recurrence, elementwise per (batch row b, channel d):
//     h_t = a_t * h_{t-1} + x_t,    y_t = h_t,
// from h_0 = h0[b], in float32, for any T >= 1 and any D >= 1. Every
// channel is walked in token order and each step rounds the product and
// the sum separately (no fused multiply-add), as the serial float32 loop
// of the plain version does, so the results equal it bit for bit at every
// T.
//
// Replaces: src/repro/kernels/linear_scan/kernel.py, `linear_scan` (the
// Pallas TPU kernel: grid (B, D/bd, T/bt) with the T axis run in order,
// the running state carried in VMEM scratch from one T block to the next,
// and a log-depth associative scan inside a block; it needs T % bt == 0
// and D % bd == 0).
//
// What bounds it on the card: bytes. a and x are read once and y written
// once, 12 bytes per (row, token, channel), against 2 float32 operations:
// far below the card's operations-per-byte balance point. The dependence
// through h is the other limit: two dependent operations (~8 cycles) per
// token of a channel, ~12 us over a 3000-token prefill, under that
// prefill's byte bound (44 us).
//
// Design: one pass, one warp per 32 adjacent channels of one row, one
// channel a lane, walking all T tokens in order with h in a register; a
// token's load of a channel block is 128 contiguous bytes. The warp is its
// own CTA (128 CTAs at B = 1 over d_rnn = 4096: one an SM) and keeps its
// stream of a and x ahead of the walk through a ring of up to MAX_STAGES
// stages in shared memory, each TT = 32 tokens x 32 channels of a and of x
// (8 KB). Where D % 4 == 0 (every model path) a stage is two 2-D TMA boxes
// issued by lane 0, completing on the stage's mbarrier: 64 KB in flight an
// SM, with no load instructions in the walk's warp. Elsewhere each lane
// copies its own channel by cp.async and arrives on the mbarrier through
// cp.async.mbarrier.arrive. y is written once, from the register, 128
// bytes a warp a token, through a pointer advanced a token a step. Copies
// of one 128-byte row per request (1-D bulk copies) ran 3x slower than
// this on the card, and per-lane 16-byte cp.async 15 % slower.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int TT = 32;                     // tokens per stage
constexpr int MAX_STAGES = 8;              // ring depth
constexpr int STAGE_FLOATS = 2 * TT * 32;  // a then x, [TT][32] each
constexpr int STAGE_BYTES = STAGE_FLOATS * 4;

__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   hop::smem_u32(dst)),
               "l"(src)
               : "memory");
}

// The barrier's phase completes once every cp.async this lane issued so
// far has landed (the barrier counts one arrival per lane).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   hop::smem_u32(bar))
               : "memory");
}

// Stage s of this warp's stream (tokens [s*TT, s*TT + n) of row b,
// channels [d0, d0 + nd)) into `dst`, completing on `bar`: two TMA boxes
// (past the row's last token they read the next row's, or zeros past the
// tensor; the walk reads only its n tokens), or one cp.async a lane a
// token.
template <bool kTma>
__device__ __forceinline__ void fill(float* dst, const CUtensorMap& ma,
                                     const CUtensorMap& mx, const float* a,
                                     const float* x, int b, int s, int T,
                                     int D, int d0, int nd, int lane,
                                     uint64_t* bar) {
  const int t0 = s * TT;
  if constexpr (kTma) {
    if (lane == 0) {
      hop::mbar_expect_tx(bar, STAGE_BYTES);
      hop::tma_load_2d(dst, &ma, bar, d0, b * T + t0);
      hop::tma_load_2d(dst + TT * 32, &mx, bar, d0, b * T + t0);
    }
  } else {
    if (lane < nd) {
      const int n = min(TT, T - t0);
      const size_t off = (static_cast<size_t>(b) * T + t0) * D + d0 + lane;
      const float* pa = a + off;
      const float* px = x + off;
      for (int tt = 0; tt < n; ++tt, pa += D, px += D) {
        cp_async_4(dst + tt * 32 + lane, pa);
        cp_async_4(dst + TT * 32 + tt * 32 + lane, px);
      }
    }
    cp_async_arrive(bar);
  }
}

// grid (ceil(D/32), B), one warp; dynamic shared memory: `stages` stages of
// STAGE_FLOATS floats. ma, mx: a and x as [B*T rows, D] for the TMA route.
template <bool kTma>
__global__ void __launch_bounds__(32)
    lru_scan(const __grid_constant__ CUtensorMap ma,
             const __grid_constant__ CUtensorMap mx,
             const float* __restrict__ a, const float* __restrict__ x,
             const float* __restrict__ h0, float* __restrict__ y,
             float* __restrict__ h_last, int T, int D, int stages) {
  extern __shared__ __align__(128) float ring[];
  __shared__ uint64_t bars[MAX_STAGES];
  const int lane = threadIdx.x;
  const int d0 = blockIdx.x * 32, b = blockIdx.y;
  const int nd = min(32, D - d0);
  const int nst = (T + TT - 1) / TT;
  if (lane < stages) hop::mbar_init(&bars[lane], kTma ? 1 : 32);
  hop::fence_barrier_init();
  __syncwarp();
  for (int s = 0; s < stages; ++s)
    fill<kTma>(ring + s * STAGE_FLOATS, ma, mx, a, x, b, s, T, D, d0, nd,
               lane, &bars[s]);
  float h = lane < nd ? h0[static_cast<size_t>(b) * D + d0 + lane] : 0.f;
  float* yp = y + static_cast<size_t>(b) * T * D + d0 + lane;
  for (int s = 0; s < nst; ++s) {
    const int slot = s % stages;
    hop::mbar_wait(&bars[slot], (s / stages) & 1);
    const float* sa = ring + slot * STAGE_FLOATS + lane;
    const float* sx = sa + TT * 32;
    const int n = min(TT, T - s * TT);
    if (n == TT && nd == 32) {
#pragma unroll 16
      for (int tt = 0; tt < TT; ++tt, yp += D) {
        h = __fadd_rn(__fmul_rn(sa[tt * 32], h), sx[tt * 32]);
        *yp = h;
      }
    } else {
      for (int tt = 0; tt < n; ++tt, yp += D) {
        h = __fadd_rn(__fmul_rn(sa[tt * 32], h), sx[tt * 32]);
        if (lane < nd) *yp = h;
      }
    }
    __syncwarp();  // every lane has read the slot before it is refilled
    if (s + stages < nst)
      fill<kTma>(ring + slot * STAGE_FLOATS, ma, mx, a, x, b, s + stages, T,
                 D, d0, nd, lane, &bars[slot]);
  }
  if (lane < nd) h_last[static_cast<size_t>(b) * D + d0 + lane] = h;
}

template <bool kTma>
int launch(const CUtensorMap& ma, const CUtensorMap& mx, const float* a,
           const float* x, const float* h0, float* y, float* h_last, int B,
           int T, int D, cudaStream_t stream) {
  static bool smem_set = false;
  const cudaError_t err = hop_host::allow_smem(
      lru_scan<kTma>, MAX_STAGES * STAGE_BYTES, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int stages = min(MAX_STAGES, (T + TT - 1) / TT);
  lru_scan<kTma><<<dim3((D + 31) / 32, B), 32,
                   static_cast<size_t>(stages) * STAGE_BYTES, stream>>>(
      ma, mx, a, x, h0, y, h_last, T, D, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, x, y [B,T,D]; h0, h_last [B,D]; all float32, contiguous and 16-byte
// aligned. Returns a cudaError_t code (0 = launched).
extern "C" int linear_scan_f32(const float* a, const float* x,
                               const float* h0, float* y, float* h_last,
                               int B, int T, int D, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || B > 65535 ||
      static_cast<long long>(B) * T > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap ma = {}, mx = {};
  if (D % 4 != 0)  // TMA needs 16-byte row strides
    return launch<false>(ma, mx, a, x, h0, y, h_last, B, T, D, st);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(B) * T};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 4};
  const cuuint32_t box[2] = {32, TT};
  cudaError_t err = hop_host::tiled_map(&ma, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                        a, 2, dims, strides, box,
                                        CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = hop_host::tiled_map(&mx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, 2,
                              dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<true>(ma, mx, a, x, h0, y, h_last, B, T, D, st);
}
