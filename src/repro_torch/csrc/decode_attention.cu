// Span decode attention: T = 1+K verification queries per row over the ring
// KV cache, GQA, online softmax, split over the cache (flash-decoding).
//
// Replaces: src/repro/kernels/decode_attention/kernel.py, `decode_attention`
// (the Pallas TPU kernel for one query per (row, head), which re-reads each
// KV block once per query head of its group). At T=1 this computes exactly
// its contract; for T>1 each query is masked by its own position.
//
// What bounds it on the card: bytes. Each valid cache slot's K and V row is
// read once, against 4*T*H*D operations per slot, far below the card's
// operations-per-byte balance point.
//
// Design: one CTA per (batch row, KV head, split of the ring, group of 32
// queries). The G*T queries of a KV head (G query heads per KV head, T span
// positions) are served by every KV block the CTA loads, so a block is read
// once per KV head instead of once per query head: the group-batched variant
// the TPU kernel's docstring names. Splitting the ring over CTAs fills the
// SMs at batch 1. A 32-slot block whose slots are all empty (position -1)
// is skipped before its K/V are loaded, so a 2048-slot ring holding a 600-
// token context reads only the live slots. A second small kernel merges the
// per-split (max, sum, accumulator) triples; a query with no valid key gets
// zeros, as the reference `attend` does.
#include "attention_tile.cuh"

namespace {

constexpr int ROWS = 32;  // queries per CTA
// ring slots per CTA: a 2048-slot ring splits 16 ways per KV head
constexpr int CHUNK = 128;
constexpr int BK = rt::ATT_BK;
constexpr int WARPS = 4;
constexpr int RPW = ROWS / WARPS;
constexpr float NEG = rt::ATT_NEG;

template <int D>
constexpr size_t smem_bytes() {
  using S = rt::AttnSmem<D>;
  return sizeof(float) * (ROWS * D + BK * S::K_STRIDE + BK * S::V_STRIDE) +
         sizeof(int) * ROWS;
}

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
    span_partial(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ cache_pos,
                 const int* __restrict__ q_pos, float* __restrict__ part_o,
                 float* __restrict__ part_m, float* __restrict__ part_l,
                 int Tq, int S, int H, int Hkv, int nsplit,
                 int window, float scale) {
  using SM = rt::AttnSmem<D>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);        // [ROWS][D]
  float* sK = sQ + ROWS * D;                          // [BK][D+4]
  float* sV = sK + BK * SM::K_STRIDE;                 // [BK][D]
  int* sQp = reinterpret_cast<int*>(sV + BK * SM::V_STRIDE);  // [ROWS]

  const int split = blockIdx.x;
  const int kvh = blockIdx.y % Hkv;
  const int rgroup = blockIdx.y / Hkv;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int NQ = Tq * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long kv_row = static_cast<long>(Hkv) * D;

  // query row rr of this KV head: span position t = rr / G, head kvh*G + rr % G
  for (int i = tid; i < ROWS * D; i += WARPS * 32) {
    const int r = i / D, d = i % D, rr = rgroup * ROWS + r;
    float val = 0.f;
    if (rr < NQ) {
      const int t = rr / G, h = kvh * G + rr % G;
      val = rt::to_f(q[((static_cast<long>(b) * Tq + t) * H + h) * D + d]) * scale;
    }
    sQ[i] = val;
  }
  for (int r = tid; r < ROWS; r += WARPS * 32) {
    const int rr = rgroup * ROWS + r;
    sQp[r] = rr < NQ ? q_pos[b * Tq + rr / G] : -1;
  }

  rt::WarpRows<D, RPW> rows;
  rows.init();

  const int s_begin = split * CHUNK;
  const int s_end = min(S, s_begin + CHUNK);
  const T* kb = k + static_cast<long>(b) * S * kv_row + static_cast<long>(kvh) * D;
  const T* vb = v + static_cast<long>(b) * S * kv_row + static_cast<long>(kvh) * D;

  for (int s0 = s_begin; s0 < s_end; s0 += BK) {
    const int sj = s0 + lane;
    const int pj = sj < s_end ? cache_pos[static_cast<long>(b) * S + sj] : -1;
    // the barrier also orders the previous block's reads before the reload
    if (!__syncthreads_or(pj >= 0)) continue;
    rt::stage_rows<T, D, WARPS * 32>(kb + s0 * kv_row, kv_row, s_end - s0,
                                     sK, SM::K_STRIDE);
    rt::stage_rows<T, D, WARPS * 32>(vb + s0 * kv_row, kv_row, s_end - s0,
                                     sV, SM::V_STRIDE);
    __syncthreads();
    if (rgroup * ROWS + warp * RPW >= NQ) continue;  // this warp's rows: none
    bool valid[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qp = sQp[warp * RPW + r];
      valid[r] = pj >= 0 && qp >= 0 && pj <= qp &&
                 (window <= 0 || pj > qp - window);
    }
    rows.update(sQ + warp * RPW * D, sK, sV, valid);
  }

  // partials laid out [B, T, H, nsplit] (+ D for the accumulator)
  const int c0 = rows.col0();
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int rr = rgroup * ROWS + warp * RPW + r;
    if (rr >= NQ) continue;
    const int t = rr / G, h = kvh * G + rr % G;
    const long idx = ((static_cast<long>(b) * Tq + t) * H + h) * nsplit + split;
    if (lane == 0) {
      part_m[idx] = rows.m[r];
      part_l[idx] = rows.l[r];
    }
#pragma unroll
    for (int c = 0; c < rows.CPL; ++c) part_o[idx * D + c0 + c] = rows.acc[r][c];
  }
}

// one CTA of D threads per (b, t, h): merge the splits' softmax partials
template <typename T, int D>
__global__ void __launch_bounds__(D)
    span_merge(const float* __restrict__ part_o, const float* __restrict__ part_m,
               const float* __restrict__ part_l, T* __restrict__ out,
               int nsplit) {
  const long row = blockIdx.x;
  const int d = threadIdx.x;
  const float* pm = part_m + row * nsplit;
  const float* pl = part_l + row * nsplit;
  float mx = NEG;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, pm[s]);
  float L = 0.f, acc = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = __expf(pm[s] - mx);
    L += pl[s] * w;
    acc += part_o[(row * nsplit + s) * D + d] * w;
  }
  out[row * D + d] = rt::from_f<T>(L > 0.f ? acc / L : 0.f);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* cache_pos,
           const int* q_pos, void* out, float* part_o, float* part_m,
           float* part_l, int B, int Tq, int S, int H, int Hkv, int window,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      span_partial<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nsplit = (S + CHUNK - 1) / CHUNK;
  const int nq = Tq * (H / Hkv);
  dim3 grid(nsplit, Hkv * ((nq + ROWS - 1) / ROWS), B);
  span_partial<T, D><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cache_pos, q_pos, part_o, part_m, part_l, Tq,
      S, H, Hkv, nsplit, window, 1.f / sqrtf(static_cast<float>(D)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  span_merge<T, D><<<B * Tq * H, D, 0, stream>>>(part_o, part_m, part_l,
                                                 static_cast<T*>(out), nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

static_assert(CHUNK % BK == 0, "a split holds whole KV blocks");

// Splits of an S-slot ring: the scratch buffers' third dimension.
extern "C" int span_decode_splits(int S) { return (S + CHUNK - 1) / CHUNK; }

// q [B,T,H,D]; k/v [B,S,Hkv,D]; cache_pos [B,S] i32 (-1 empty); q_pos [B,T]
// i32; out [B,T,H,D]. Scratch: part_o [B,T,H,nsplit,D], part_m/part_l
// [B,T,H,nsplit] f32 with nsplit = span_decode_splits(S).
// Returns a cudaError_t code (0 = launched).
extern "C" int span_decode_attention(const void* q, const void* k,
                                     const void* v, const int* cache_pos,
                                     const int* q_pos, void* out,
                                     float* part_o, float* part_m,
                                     float* part_l, int B, int Tq, int S,
                                     int H, int Hkv, int D, int window,
                                     int dtype, void* stream) {
  if (B <= 0 || Tq <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_SPAN(TT, DD)                                                      \
  return launch<TT, DD>(q, k, v, cache_pos, q_pos, out, part_o, part_m,      \
                        part_l, B, Tq, S, H, Hkv, window, st)
  if (dtype == RT_BF16 && D == 128) RT_SPAN(__nv_bfloat16, 128);
  if (dtype == RT_BF16 && D == 64) RT_SPAN(__nv_bfloat16, 64);
  if (dtype == RT_F32 && D == 128) RT_SPAN(float, 128);
  if (dtype == RT_F32 && D == 64) RT_SPAN(float, 64);
#undef RT_SPAN
  return static_cast<int>(cudaErrorInvalidValue);
}
