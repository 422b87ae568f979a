// Causal (optionally sliding-window) GQA prefill attention for Hopper.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, `flash_attention`
// (the Pallas TPU kernel whose grid walks KV blocks in order, carrying the
// online-softmax statistics in revisited output blocks).
//
// What bounds it on the card: at prefill lengths the work is 4*S^2/2*H*D
// operations against 4*S*H*D*bytes of input and output, so it is bound by
// operations, on the bf16 tensor cores (989 TFLOP/s dense).
//
// Two routes, chosen in `flash_attention_fwd` from the dtype alone and
// reported back to the wrapper:
//
// bf16, `flash_wgmma` (FlashAttention-3's layout): one CTA per (head,
// block of BQ queries, batch), NWG consumer warpgroups of 64 query rows
// (BQ = 64 * NWG) and one producer warp. The producer loads the Q tile
// once and streams K and V through a 2-stage ring of BK-row tiles with TMA
// into 128-byte-swizzled shared memory (hopper.cuh), each tile completing
// on its own mbarrier; the consumers free a stage through an `empty`
// mbarrier. A consumer computes S = Q K^T by wgmma from shared memory
// (K is K-major), the online softmax on the float32 accumulator fragment
// (a row's max and sum reduce over the 4 lanes that share it; exp2 with
// the scale folded into log2 e), and O += P V by wgmma with P converted to
// bf16 in registers (the accumulator layout is the A-fragment layout) and
// V read MN-major. Only blocks that cut the diagonal, the window edge or
// the end of the sequence are masked; blocks wholly above the diagonal or
// out of the window are not loaded for the CTA and not multiplied for a
// warpgroup. The tensor maps are 3-D over [B*S, H, D] views, so a tile of
// rows never crosses a head; rows of the next batch inside a tile are
// masked by position and rows past B*S read as zeros. The grid runs heads
// fastest, so the query heads of one KV head (GQA, MQA) run together and
// share its K/V tiles through L2, and query blocks last-first, so the long
// causal rows start early. BK = 128 at D <= 128 and 64 at D = 256. BQ =
// 128 (two consumer warpgroups) at D <= 128 unless that gives fewer CTAs
// than the card has SMs, else BQ = 64 (one). Registers bound the choice at
// D = 256: O alone is 128 floats a thread and a consumer needs ~200, but
// ptxas gives each thread of a 9-warp CTA at most 168 (each of the SM's 4
// register-file quarters, 16K registers, holds 3 of its warps), and with
// setmaxnreg (producer 24 or 40, consumers 240) it still allocated 168 and
// spilled 552-560 bytes; a 5-warp CTA has up to 255. Within a warpgroup
// the two products and the softmax of a block run in turn; FlashAttention-
// 3's overlap of one block's softmax with the next block's products made
// ptxas serialize every wgmma here (C7514) and ran 5-17 % slower.
//
// float32, `flash_fwd` (the CUDA cores, so a float32 model keeps float32
// products): one CTA per (batch, head, block of BQ=32 queries), 4 warps of
// 8 query rows each. A loop over KV blocks of 32 keys replaces the TPU's
// sequential grid axis; blocks wholly above the diagonal or wholly out of
// the window are never visited. A KV block is staged once in shared memory
// (float32; K rows padded to D+4 so that lane j reading key j 16 bytes at
// a time is free of bank conflicts) and serves all 32 queries of the CTA.
// Each lane scores one key for the warp's 8 rows, the softmax statistics
// are reduced with warp shuffles, and each lane keeps D/32 contiguous
// output columns of the 8 rows in registers (attention_tile.cuh).
//
// Both accept any S: keys and queries past S are masked. Given an `lse`
// pointer ([B,H,S] float32) they also write each query row's log-sum-exp of
// its scaled scores, m + log(l), from the statistics they already keep (the
// TPU kernel's m and l outputs); the training path's backward reads it.
#include "attention_tile.cuh"
#include "hopper.cuh"

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

// ---- bf16: wgmma + TMA --------------------------------------------------

constexpr int SMS = 132;  // H100 SMs: below one CTA per SM, halve BQ

template <int D, int NWG>
struct Wg {
  static constexpr int BQ = 64 * NWG;
  static constexpr int BK = D <= 128 ? 128 : 64;
  static constexpr int SLABS = D / 64;   // 64-column slabs of 128 bytes
  static constexpr int STAGES = 2;
  // the consumer warpgroups, then the producer warp
  static constexpr int THREADS = 128 * NWG + 32;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one K or V tile
  // 1024 bytes of slack to align the tiles, then Q, K[ST], V[ST], barriers
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 128;
};

template <int D, int NWG>
__global__ void __launch_bounds__(Wg<D, NWG>::THREADS, 1)
    flash_wgmma(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int S, int H, int Hkv, int window, float scale_log2) {
  using W = Wg<D, NWG>;
  constexpr int BQ = W::BQ, BK = W::BK, ST = W::STAGES;
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* sK = sQ + BQ * D;       // [ST][BK * D]
  __nv_bfloat16* sV = sK + ST * BK * D;  // [ST][BK * D]
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + ST * BK * D);
  uint64_t* full_k = bar_q + 1;          // [ST]
  uint64_t* full_v = full_k + ST;        // [ST]
  uint64_t* empty = full_v + ST;         // [ST]

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last blocks first
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int row0 = b * S;  // this batch's first row of the [B*S] views
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int n_blocks = (min(q0 + BQ, S) - k_begin + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hop::mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      hop::mbar_init(&full_k[s], 1);
      hop::mbar_init(&full_v[s], 1);
      hop::mbar_init(&empty[s], 4 * NWG);  // lane 0 of every consumer warp
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // ---- producer warp: one thread issues the TMA loads ----
    if (lane == 0) {
      hop::mbar_expect_tx(bar_q, W::Q_BYTES);
#pragma unroll
      for (int s = 0; s < W::SLABS; ++s)
        hop::tma_load_3d(sQ + s * BQ * 64, &mq, bar_q, 64 * s, h, row0 + q0);
      for (int it = 0; it < n_blocks; ++it) {
        const int st = it % ST;
        const int k0 = k_begin + it * BK;
        hop::mbar_wait(&empty[st], ((it / ST) & 1) ^ 1);
        hop::mbar_expect_tx(&full_k[st], W::KV_BYTES);
#pragma unroll
        for (int s = 0; s < W::SLABS; ++s)
          hop::tma_load_3d(sK + st * BK * D + s * BK * 64, &mk, &full_k[st],
                           64 * s, kvh, row0 + k0);
        hop::mbar_expect_tx(&full_v[st], W::KV_BYTES);
#pragma unroll
        for (int s = 0; s < W::SLABS; ++s)
          hop::tma_load_3d(sV + st * BK * D + s * BK * 64, &mv, &full_v[st],
                           64 * s, kvh, row0 + k0);
      }
    }
  } else {
    // ---- consumer warpgroup g: rows qa .. qa + 63 ----
    const int g = warp / 4;
    const int qa = q0 + 64 * g;
    const int qb = min(qa + 63, S - 1);  // its last row below S
    const int r_lo = qa + 16 * (warp % 4) + lane / 4;  // rows r_lo, r_lo + 8
    const int c_lane = 2 * (lane % 4);
    const __nv_bfloat16* q_tile = sQ + g * 64 * 64;
    const float neg_inf = -__int_as_float(0x7f800000);
    float o_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
    float m_row[2] = {neg_inf, neg_inf}, l_row[2] = {0.f, 0.f};

    hop::mbar_wait(bar_q, 0);
    for (int it = 0; it < n_blocks; ++it) {
      const int st = it % ST;
      const uint32_t parity = (it / ST) & 1;
      const int k0 = k_begin + it * BK;
      // does any (row, key) pair of this warpgroup fall in the block?
      const bool live = qa < S && k0 <= qb &&
                        (window <= 0 || k0 + BK - 1 > qa - window);
      uint32_t p_frag[BK / 16][4];
      hop::mbar_wait(&full_k[st], parity);
      if (live) {
        // S = Q K^T: both K-major
        float s_acc[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s_acc[i] = 0.f;
        const __nv_bfloat16* k_tile = sK + st * BK * D;
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int off = (kk % 4) * 16;
          hop::wgmma_ss<0>(
              s_acc,
              hop::desc_sw128(q_tile + (kk / 4) * BQ * 64 + off, 16, 1024),
              hop::desc_sw128(k_tile + (kk / 4) * BK * 64 + off, 16, 1024),
              1);
        }
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(s_acc);

        // scores to the log2 domain; mask where the block cuts the
        // diagonal, the window edge (for any of the 64 rows) or S
        const bool masked = k0 + BK - 1 > qa || k0 + BK > S ||
                            (window > 0 && k0 <= qa + 63 - window);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          float x = s_acc[i] * scale_log2;
          if (masked) {
            const int key = k0 + 8 * (i / 4) + c_lane + (i % 2);
            const int row = r_lo + 8 * ((i % 4) / 2);
            const bool ok = key <= row && key < S &&
                            (window <= 0 || key > row - window);
            x = ok ? x : neg_inf;
          }
          s_acc[i] = x;
        }
        // online softmax, per row half (r / 2 of d[4j + r])
        float alpha[2], m_use[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mx = neg_inf;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
            mx = fmaxf(mx, fmaxf(s_acc[4 * j + 2 * hh],
                                 s_acc[4 * j + 2 * hh + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_row[hh], mx);
          m_use[hh] = m_new == neg_inf ? 0.f : m_new;
          alpha[hh] = exp2f(m_row[hh] - m_use[hh]);
          m_row[hh] = m_new;
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const float p = exp2f(s_acc[i] - m_use[(i % 4) / 2]);
          s_acc[i] = p;
          sum[(i % 4) / 2] += p;
        }
        // per-lane partial sums; the 4 lanes of a row share alpha, so they
        // are added up once, in the epilogue
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) l_row[hh] = l_row[hh] * alpha[hh] + sum[hh];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o_acc[i] *= alpha[(i % 4) / 2];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            p_frag[kk][r] = hop::pack_bf16(s_acc[8 * kk + 2 * r],
                                           s_acc[8 * kk + 2 * r + 1]);
      }
      hop::mbar_wait(&full_v[st], parity);
      if (live) {
        // O += P V: P from registers, V MN-major (the next 64 columns of
        // D are the next slab, BK * 128 bytes on)
        const __nv_bfloat16* v_tile = sV + st * BK * D;
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          hop::wgmma_rs<1>(o_acc, p_frag[kk],
                           hop::desc_sw128(v_tile + kk * 16 * 64, BK * 128,
                                           1024),
                           1);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(o_acc);
      }
      if (lane == 0) hop::mbar_arrive(&empty[st]);
    }

    // epilogue: O / l as bf16, and each row's lse = m + log l (natural log)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = l_row[hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = r_lo + 8 * hh;
      if (row >= S) continue;
      const float inv = l > 0.f ? 1.f / l : 0.f;
      __nv_bfloat16* orow =
          o + (static_cast<long>(row0 + row) * H + h) * D + c_lane;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            hop::pack_bf16(o_acc[4 * j + 2 * hh] * inv,
                           o_acc[4 * j + 2 * hh + 1] * inv);
      if (lse != nullptr && lane % 4 == 0)
        lse[(static_cast<long>(b) * H + h) * S + row] =
            l > 0.f ? m_row[hh] * 0.6931471805599453f + logf(l) : neg_inf;
    }
  }
}

template <int D, int NWG>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int S, int H, int Hkv, int window,
                 cudaStream_t stream) {
  using W = Wg<D, NWG>;
  const cuuint64_t rows = static_cast<cuuint64_t>(B) * S;
  const cuuint64_t dq[3] = {D, static_cast<cuuint64_t>(H), rows};
  const cuuint64_t sq[2] = {D * 2, static_cast<cuuint64_t>(H) * D * 2};
  const cuuint64_t dkv[3] = {D, static_cast<cuuint64_t>(Hkv), rows};
  const cuuint64_t skv[2] = {D * 2, static_cast<cuuint64_t>(Hkv) * D * 2};
  const cuuint32_t bq[3] = {64, 1, W::BQ};
  const cuuint32_t bkv[3] = {64, 1, W::BK};
  CUtensorMap mq, mk, mv;
  cudaError_t err = hop_host::bf16_map(&mq, q, 3, dq, sq, bq);
  if (err == cudaSuccess) err = hop_host::bf16_map(&mk, k, 3, dkv, skv, bkv);
  if (err == cudaSuccess) err = hop_host::bf16_map(&mv, v, 3, dkv, skv, bkv);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_wgmma<D, NWG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               W::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, (S + W::BQ - 1) / W::BQ, B);
  const float scale_log2 =
      1.4426950408889634f / sqrtf(static_cast<float>(D));
  flash_wgmma<D, NWG><<<grid, W::THREADS, W::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, S, H, Hkv, window,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int H, int Hkv, int window,
                cudaStream_t st) {
  if constexpr (D < 256) {
    if (static_cast<long>(B) * H * ((S + 127) / 128) >= SMS)
      return launch_wgmma<D, 2>(q, k, v, o, lse, B, S, H, Hkv, window, st);
  }
  return launch_wgmma<D, 1>(q, k, v, o, lse, B, S, H, Hkv, window, st);
}

}  // namespace

// q [B,S,H,D], k/v [B,S,Hkv,D], o [B,S,H,D]; all contiguous, one dtype,
// 16-byte aligned; lse [B,H,S] float32 or null. bf16 takes the wgmma route,
// float32 the CUDA cores; *route says which. Returns a cudaError_t code
// (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int S, int H,
                                   int Hkv, int D, int window, int dtype,
                                   void* stream, int* route) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == RT_BF16 && (D == 64 || D == 128 || D == 256)) {
    *route = RT_ROUTE_WGMMA;
    if (D == 256)
      return launch_bf16<256>(q, k, v, o, l, B, S, H, Hkv, window, st);
    if (D == 128)
      return launch_bf16<128>(q, k, v, o, l, B, S, H, Hkv, window, st);
    return launch_bf16<64>(q, k, v, o, l, B, S, H, Hkv, window, st);
  }
  if (dtype == RT_F32 && (D == 64 || D == 128 || D == 256)) {
    *route = RT_ROUTE_SIMT;
    if (D == 256)
      return launch<float, 256>(q, k, v, o, l, B, S, H, Hkv, window, st);
    if (D == 128)
      return launch<float, 128>(q, k, v, o, l, B, S, H, Hkv, window, st);
    return launch<float, 64>(q, k, v, o, l, B, S, H, Hkv, window, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
