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
// Two routes, chosen in `span_decode_attention` from the dtype and reported
// back to the wrapper: bf16 on the tensor cores (`span_mma`, below), float32
// on the CUDA cores (`span_partial`). Both write per-split softmax partials
// that `span_merge` combines in a fixed order, its warps over the splits.
//
// bf16, `span_mma`: one CTA per (batch row, KV head, split of the ring)
// serves all G*T queries of its KV head, so each K/V row is read from
// device memory once per (row, KV head). The split size is chosen on the
// host from B, Hkv, S, D and the SM count (kernels/decode_attention/ops.py:
// `split_size`), so a single KV head at batch 1 still spreads over the SMs.
// Before any K/V load the CTA reads its slots' positions and marks each
// 16-slot block that some query can use (a slot p with p >= 0, p <= the
// largest query position and, windowed, p > the smallest one - window):
// other blocks are neither loaded nor computed, and a CTA with none writes
// empty partials and stops. The used blocks are all put in flight at once
// by the bulk-copy engine, one mbarrier each (K and V rows as bf16 into
// padded shared rows), so the first block's products overlap the later
// blocks' loads. Each of the CTA's warps (4, or 8 at D = 256) takes
// 16-query tiles in turn: S = Q K^T and O += P V by mma.sync m16n8k16
// (ldmatrix fragments; V through ldmatrix.trans), the online softmax in
// float32 registers, P rounded to bf16 for P V as the prefill kernel does.
//
// Head dims 64, 80, 128 and 256. At 80 the bf16 route takes five 16-deep
// k-steps for S and ten 8-column tiles of O (its padded rows, 176 bytes,
// keep ldmatrix free of bank conflicts), and the float32 route's lanes
// keep 3 columns each, the last lanes' partly past D (attention_tile.cuh).
//
// float32, `span_partial`: one CTA per (batch row, KV head, split of the
// ring, group of 32 queries). The G*T queries of a KV head (G query heads
// per KV head, T span positions) are served by every KV block the CTA
// loads, so a block is read once per KV head instead of once per query
// head: the group-batched variant the TPU kernel's docstring names.
// Splitting the ring over CTAs fills the SMs at batch 1. A 32-slot block
// whose slots are all empty (position -1) is skipped before its K/V are
// loaded, so a 2048-slot ring holding a 600-token context reads only the
// live slots. A second small kernel merges the
// per-split (max, sum, accumulator) triples; a query with no valid key gets
// zeros, as the reference `attend` does.
#include "attention_tile.cuh"
#include "hopper.cuh"

#include <climits>
#include <type_traits>

namespace {

constexpr int ROWS = 32;  // queries per CTA
// ring slots per CTA: a 2048-slot ring splits 16 ways per KV head
constexpr int CHUNK = 128;
constexpr int BK = rt::ATT_BK;
constexpr int WARPS = 4;
constexpr int RPW = ROWS / WARPS;
constexpr float NEG = rt::ATT_NEG;

// Dynamic shared memory per CTA: 98 944 bytes at D = 256, above the 48 KB
// a launch gets by default, so `launch` raises the limit for each
// instantiation before it launches.
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
    for (int c = 0; c < rows.CPL; ++c)
      if (rows.has(c)) part_o[idx * D + c0 + c] = rows.acc[r][c];
  }
}

// ---- bf16: mma.sync on the tensor cores ----------------------------------

constexpr int MKB = 16;     // keys per block: the k of P V's m16n8k16

// Warps of a `span_mma` CTA: 4, or 8 at D = 256, where 210 registers a
// thread hold an SM to 8 warps anyway and one KV head serves up to 80
// queries (five 16-query tiles) a row. At least one slot per thread:
// splits of <= 128 slots.
template <int D>
__host__ __device__ constexpr int mma_warps() {
  return D == 256 ? 8 : 4;
}

// Shared memory of a `span_mma` CTA: K and V of the split ([split][D + 8]
// bf16: rows 16 bytes apart modulo 128, so ldmatrix is free of bank
// conflicts), each warp's 16-query tile, the slots' positions, one
// mbarrier per block.
template <int D>
struct MmaSmem {
  static constexpr int LD = D + 8;
  static constexpr int MAX_SPLIT = D <= 128 ? 128 : 64;
  static constexpr int WARPS = mma_warps<D>();
  __host__ __device__ static constexpr int pos_offset(int split) {
    return 2 * split * LD * 2 + WARPS * 16 * LD * 2;
  }
  __host__ __device__ static constexpr int bytes(int split) {
    return pos_offset(split) + split * 4 + (split / MKB) * 8;
  }
};

// One warp's online softmax of a 16-query tile (sQw) over the split's used
// blocks: S = Q K^T and O += P V by mma.sync m16n8k16. The lane holds rows
// lane / 4 (i = 0) and lane / 4 + 8 (i = 1): m[i], l[i] and o[n][2i..2i+1]
// at columns 8n + 2 * (lane % 4) + {0, 1}.
template <int D>
__device__ __forceinline__ void attend_tile(
    const __nv_bfloat16* sQw, const __nv_bfloat16* sK,
    const __nv_bfloat16* sV, const int* sPos, uint64_t* bars,
    unsigned used, int nblk, const int (&qp)[2], int window,
    float scale, float (&m)[2], float (&l)[2], float (&o)[D / 8][4]) {
  constexpr int LD = MmaSmem<D>::LD;
  const int lane = threadIdx.x & 31;
  m[0] = m[1] = NEG;
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int j = 0; j < nblk; ++j) {
    if (!((used >> j) & 1u)) continue;
    hop::mbar_wait(&bars[j], 0);
    const __nv_bfloat16* kb = sK + j * MKB * LD;
    const __nv_bfloat16* vb = sV + j * MKB * LD;
    // S = Q K^T: 16 queries x 16 keys, as two 8-key tiles; the even and
    // odd k-steps in separate accumulators (half the chain of dependent
    // products), added at the end
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float s_odd[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4], kf[4];
      hop::ldmatrix_x4(a, sQw + (lane % 8 + 8 * ((lane / 8) % 2)) * LD +
                              16 * ks + 8 * (lane / 16));
      hop::ldmatrix_x4(kf, kb + (lane % 8 + 8 * (lane / 16)) * LD +
                               16 * ks + 8 * ((lane / 8) % 2));
      if (ks % 2) {
        hop::mma_16816(s_odd[0], a, kf[0], kf[1]);
        hop::mma_16816(s_odd[1], a, kf[2], kf[3]);
      } else {
        hop::mma_16816(s[0], a, kf[0], kf[1]);
        hop::mma_16816(s[1], a, kf[2], kf[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] += s_odd[nt][e];
    // mask and scale; s[nt][e] is row lane / 4 + 8 * (e / 2), key
    // 8 * nt + 2 * (lane % 4) + e % 2 of the block
    bool ok[2][4];
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pk = sPos[j * MKB + 8 * nt + 2 * (lane % 4) + e % 2];
        const int qq = qp[e / 2];
        ok[nt][e] = pk >= 0 && pk <= qq && (window <= 0 || pk > qq - window);
        s[nt][e] = ok[nt][e] ? s[nt][e] * scale : NEG;
        mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = __expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = ok[nt][e] ? __expf(s[nt][e] - m[e / 2]) : 0.f;
        sum[e / 2] += s[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // O += P V: P (bf16) is the A fragment straight from S's registers
    const uint32_t pa[4] = {hop::pack_bf16(s[0][0], s[0][1]),
                            hop::pack_bf16(s[0][2], s[0][3]),
                            hop::pack_bf16(s[1][0], s[1][1]),
                            hop::pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t vf[4];
      hop::ldmatrix_x4_trans(
          vf, vb + (lane % 8 + 8 * ((lane / 8) % 2)) * LD + 8 * n +
                  8 * (lane / 16));
      hop::mma_16816(o[n], pa, vf[0], vf[1]);
      hop::mma_16816(o[n + 1], pa, vf[2], vf[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(mma_warps<D>() * 32)
    span_mma(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const int* __restrict__ cache_pos, const int* __restrict__ q_pos,
             float* __restrict__ part_o, float* __restrict__ part_m,
             float* __restrict__ part_l, int Tq, int S, int H, int Hkv,
             int nsplit, int split, int window, float scale) {
  using SM = MmaSmem<D>;
  constexpr int LD = SM::LD, MWARPS = SM::WARPS;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + split * LD;
  __nv_bfloat16* sQ = sV + split * LD;
  int* sPos = reinterpret_cast<int*>(smem + SM::pos_offset(split));
  uint64_t* bars = reinterpret_cast<uint64_t*>(sPos + split);
  __shared__ unsigned warp_used[MWARPS];

  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv, NQ = Tq * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int s0 = sp * split, n_in = min(split, S - s0);
  const int nblk = (n_in + MKB - 1) / MKB;
  const long kv_row = static_cast<long>(Hkv) * D;

  const int p = tid < n_in ? cache_pos[static_cast<long>(b) * S + s0 + tid]
                           : -1;
  // a key at position p can serve some query of this row only if
  // qmin - window < p <= qmax (each warp reads the row's positions, 32 at
  // a time)
  int qmin = INT_MAX, qmax = -1;
  for (int t0 = 0; t0 < Tq; t0 += 32) {
    const int qp = t0 + lane < Tq ? q_pos[b * Tq + t0 + lane] : -1;
    qmax = max(qmax, __reduce_max_sync(0xffffffffu, qp));
    qmin = min(qmin, __reduce_min_sync(0xffffffffu, qp >= 0 ? qp : INT_MAX));
  }
  if (tid < split) sPos[tid] = p;
  const bool usable =
      p >= 0 && p <= qmax && (window <= 0 || p > qmin - window);
  const unsigned ballot = __ballot_sync(0xffffffffu, usable);
  if (lane == 0) warp_used[warp] = ballot;
  if (tid == 0) {
    for (int j = 0; j < nblk; ++j) hop::mbar_init(&bars[j], 1);
    hop::fence_barrier_init();
  }
  // rows of the last block past the ring's end: zeros (P V reads them)
  for (int i = tid; i < (nblk * MKB - n_in) * (D / 8); i += MWARPS * 32) {
    const int r = n_in + i / (D / 8), c = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(sK + r * LD + c) = make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(sV + r * LD + c) = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  unsigned used = 0;  // bit j: block j holds a slot some query may use
  for (int j = 0; j < nblk; ++j)
    if ((warp_used[j / 2] >> (16 * (j % 2))) & 0xffffu) used |= 1u << j;

  if (used == 0) {  // nothing to read: empty partials
    for (int rr = tid; rr < NQ; rr += MWARPS * 32) {
      const int t = rr / G, h = kvh * G + rr % G;
      const long idx = ((static_cast<long>(b) * Tq + t) * H + h) * nsplit + sp;
      part_m[idx] = NEG;
      part_l[idx] = 0.f;
    }
    return;
  }

  // put every used block in flight: warp j % MWARPS issues block j, lane
  // r < 16 K row r, lane 16 + r V row r
  for (int j = warp; j < nblk; j += MWARPS) {
    if (!((used >> j) & 1u)) continue;
    const int rows = min(MKB, n_in - j * MKB);
    if (lane == 0) hop::mbar_expect_tx(&bars[j], 2 * rows * D * 2);
    __syncwarp();
    const int r = lane % MKB, slot = j * MKB + r;
    if (r < rows) {
      const long g = (static_cast<long>(b) * S + s0 + slot) * kv_row +
                     static_cast<long>(kvh) * D;
      if (lane < MKB)
        hop::bulk_load(sK + slot * LD, k + g, D * 2, &bars[j]);
      else
        hop::bulk_load(sV + slot * LD, v + g, D * 2, &bars[j]);
    }
  }

  // each warp takes 16-query tiles in turn
  __nv_bfloat16* sQw = sQ + warp * 16 * LD;
  for (int mt = warp; mt < (NQ + 15) / 16; mt += MWARPS) {
    // the tile's 16 query rows (zeros past NQ): query rr is span position
    // rr / G of head kvh * G + rr % G; every load in flight before the
    // first store
    constexpr int QCH = D / 16;  // 16-byte chunks per lane
    uint4 qbuf[QCH];
#pragma unroll
    for (int c = 0; c < QCH; ++c) {
      const int i = lane + 32 * c;
      const int rr = mt * 16 + i / (D / 8);
      qbuf[c] = make_uint4(0u, 0u, 0u, 0u);
      if (rr < NQ) {
        const int t = rr / G, h = kvh * G + rr % G;
        qbuf[c] = *reinterpret_cast<const uint4*>(
            q + ((static_cast<long>(b) * Tq + t) * H + h) * D +
            (i % (D / 8)) * 8);
      }
    }
    int qp[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = mt * 16 + lane / 4 + 8 * i;
      qp[i] = rr < NQ ? q_pos[b * Tq + rr / G] : -1;
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < QCH; ++c) {
      const int i = lane + 32 * c;
      *reinterpret_cast<uint4*>(sQw + (i / (D / 8)) * LD +
                                (i % (D / 8)) * 8) = qbuf[c];
    }
    __syncwarp();
    float m[2], l[2], o[D / 8][4];
    attend_tile<D>(sQw, sK, sV, sPos, bars, used, nblk, qp, window, scale,
                   m, l, o);

    // partials laid out [B, T, H, nsplit] (+ D for the accumulator)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = mt * 16 + lane / 4 + 8 * i;
      if (rr >= NQ) continue;
      const int t = rr / G, h = kvh * G + rr % G;
      const long idx = ((static_cast<long>(b) * Tq + t) * H + h) * nsplit + sp;
      if (lane % 4 == 0) {
        part_m[idx] = m[i];
        part_l[idx] = l[i];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(part_o + idx * D + 8 * n + 2 * (lane % 4)) =
            make_float2(o[n][2 * i], o[n][2 * i + 1]);
    }
  }
}

// One CTA of 8 warps per (b, t, h): merge the splits' softmax partials.
// Each split's (m, l) is read once into shared memory; the weights
// exp(m_s - max) of the splits with a valid key (l_s > 0; the bf16 route
// writes no accumulator for the others) replace them there; warp w sums
// the accumulators of splits [w*n/8, (w+1)*n/8), each lane the column
// pairs lane, lane + 32, ... (8 bytes a load, a warp's loads contiguous;
// at head_dim 80 the 40 pairs leave lanes 8-31 a second pair to skip), so
// the loads of many splits are in flight at once; the warps' sums are
// added in warp order. Every sum has a fixed order, so two calls give the
// same bits. A query with no valid key gets zeros.
constexpr int MERGE_WARPS = 8;

template <typename T, int D>
__global__ void __launch_bounds__(MERGE_WARPS * 32)
    span_merge(const float* __restrict__ part_o,
               const float* __restrict__ part_m,
               const float* __restrict__ part_l, T* __restrict__ out,
               int nsplit) {
  constexpr int NT = MERGE_WARPS * 32;
  constexpr int PAIRS = D / 2, PPL = (PAIRS + 31) / 32;
  extern __shared__ float sw[];             // [2][nsplit]: m (then w), l
  __shared__ float red[MERGE_WARPS][D];     // the warps' sums
  __shared__ float wred[2][MERGE_WARPS];
  const long row = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* sm = sw;
  float* sl = sw + nsplit;

  float mx = NEG;
  for (int s = tid; s < nsplit; s += NT) {
    const float m = part_m[row * nsplit + s], l = part_l[row * nsplit + s];
    sm[s] = m;
    sl[s] = l;
    if (l > 0.f) mx = fmaxf(mx, m);
  }
  mx = rt::warp_max(mx);
  if (lane == 0) wred[0][warp] = mx;
  __syncthreads();
  mx = NEG;
#pragma unroll
  for (int w = 0; w < MERGE_WARPS; ++w) mx = fmaxf(mx, wred[0][w]);
  float L = 0.f;
  for (int s = tid; s < nsplit; s += NT) {
    const float l = sl[s];
    const float w = l > 0.f ? __expf(sm[s] - mx) : 0.f;
    sm[s] = w;
    L += l * w;
  }
  L = rt::warp_sum(L);
  if (lane == 0) wred[1][warp] = L;
  __syncthreads();
  L = 0.f;
#pragma unroll
  for (int w = 0; w < MERGE_WARPS; ++w) L += wred[1][w];

  float2 acc[PPL];
#pragma unroll
  for (int i = 0; i < PPL; ++i) acc[i] = make_float2(0.f, 0.f);
  const int s_end = static_cast<int>(
      static_cast<long>(warp + 1) * nsplit / MERGE_WARPS);
#pragma unroll 8
  for (int s = static_cast<int>(static_cast<long>(warp) * nsplit /
                                MERGE_WARPS);
       s < s_end; ++s) {
    const float w = sm[s];
    const float2* src =
        reinterpret_cast<const float2*>(part_o + (row * nsplit + s) * D);
#pragma unroll
    for (int i = 0; i < PPL; ++i) {
      const int pr = lane + 32 * i;
      if (PAIRS % 32 != 0 && pr >= PAIRS) continue;
      const float2 v = src[pr];
      // an unwritten accumulator (w = 0) is read but never used
      acc[i].x = w > 0.f ? fmaf(w, v.x, acc[i].x) : acc[i].x;
      acc[i].y = w > 0.f ? fmaf(w, v.y, acc[i].y) : acc[i].y;
    }
  }
#pragma unroll
  for (int i = 0; i < PPL; ++i) {
    const int pr = lane + 32 * i;
    if (PAIRS % 32 != 0 && pr >= PAIRS) continue;
    red[warp][2 * pr] = acc[i].x;
    red[warp][2 * pr + 1] = acc[i].y;
  }
  __syncthreads();
  for (int d = tid; d < D; d += NT) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < MERGE_WARPS; ++w) a += red[w][d];
    out[row * D + d] = rt::from_f<T>(L > 0.f ? a / L : 0.f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* cache_pos,
           const int* q_pos, void* out, float* part, int B, int Tq, int S,
           int H, int Hkv, int window, int split, cudaStream_t stream) {
  static bool smem_set = false;
  const int nsplit = (S + split - 1) / split;
  float* part_o = part;
  float* part_m = part_o + static_cast<long>(B) * Tq * H * nsplit * D;
  float* part_l = part_m + static_cast<long>(B) * Tq * H * nsplit;
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    err = hop_host::allow_smem(
        span_mma<D>, MmaSmem<D>::bytes(MmaSmem<D>::MAX_SPLIT), smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(nsplit, Hkv, B);
    span_mma<D><<<grid, MmaSmem<D>::WARPS * 32, MmaSmem<D>::bytes(split),
                  stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), cache_pos, q_pos, part_o, part_m, part_l,
        Tq, S, H, Hkv, nsplit, split, window, scale);
  } else {
    const size_t smem = smem_bytes<D>();
    err = hop_host::allow_smem(span_partial<T, D>, static_cast<int>(smem),
                               smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int nq = Tq * (H / Hkv);
    dim3 grid(nsplit, Hkv * ((nq + ROWS - 1) / ROWS), B);
    span_partial<T, D><<<grid, WARPS * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), cache_pos, q_pos, part_o, part_m, part_l,
        Tq, S, H, Hkv, nsplit, window, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  span_merge<T, D><<<B * Tq * H, MERGE_WARPS * 32,
                     2 * static_cast<size_t>(nsplit) * sizeof(float),
                     stream>>>(
      part_o, part_m, part_l, static_cast<T*>(out), nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

static_assert(CHUNK % BK == 0, "a split holds whole KV blocks");

// q [B,T,H,D]; k/v [B,S,Hkv,D]; cache_pos [B,S] i32 (-1 empty); q_pos [B,T]
// i32; out [B,T,H,D]; part: float32 scratch of B*T*H*nsplit*(D + 2) with
// nsplit = ceil(S / split): the splits' accumulators, maxima and sums.
// split: ring slots per CTA, 128 on the float32 route; on the bf16 route a
// multiple of 16 up to 128 (64 at D = 256). *route says which route ran.
// Returns a cudaError_t code (0 = launched).
extern "C" int span_decode_attention(const void* q, const void* k,
                                     const void* v, const int* cache_pos,
                                     const int* q_pos, void* out, float* part,
                                     int B, int Tq, int S, int H, int Hkv,
                                     int D, int window, int split, int dtype,
                                     void* stream, int* route) {
  if (B <= 0 || Tq <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int max_split = D <= 128 ? 128 : 64;
  if (dtype == RT_BF16 &&
      (split < MKB || split % MKB || split > max_split))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == RT_F32 && split != CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  // the merge keeps two floats per split in (default) shared memory
  if ((S + split - 1) / split > 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  *route = dtype == RT_BF16 ? RT_ROUTE_MMA : RT_ROUTE_SIMT;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RT_SPAN(TT, DD)                                                      \
  return launch<TT, DD>(q, k, v, cache_pos, q_pos, out, part, B, Tq, S, H,   \
                        Hkv, window, split, st)
  if (dtype == RT_BF16 && D == 256) RT_SPAN(__nv_bfloat16, 256);
  if (dtype == RT_BF16 && D == 128) RT_SPAN(__nv_bfloat16, 128);
  if (dtype == RT_BF16 && D == 80) RT_SPAN(__nv_bfloat16, 80);
  if (dtype == RT_BF16 && D == 64) RT_SPAN(__nv_bfloat16, 64);
  if (dtype == RT_F32 && D == 256) RT_SPAN(float, 256);
  if (dtype == RT_F32 && D == 128) RT_SPAN(float, 128);
  if (dtype == RT_F32 && D == 80) RT_SPAN(float, 80);
  if (dtype == RT_F32 && D == 64) RT_SPAN(float, 64);
#undef RT_SPAN
  return static_cast<int>(cudaErrorInvalidValue);
}
