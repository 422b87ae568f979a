// Fused MoE expert FFN over a slot layout: for each slot u with counts[u]
// live rows, y[u] = (silu(x[u] @ wg[e]) * (x[u] @ wu[e])) @ wd[e], or
// gelu_tanh(x[u] @ wu[e]) @ wd[e], where e = expert_ids[u] (or u when no
// ids are given). Accumulated in float32, cast to the input type.
//
// Replaces: src/repro/kernels/moe_gmm/kernel.py, `moe_gmm_fused` (the Pallas
// TPU kernel that steers dead slots' weight fetches to block 0 through
// scalar-prefetched counts, and keeps d whole per block).
//
// What bounds it on the card: bytes. A verification pass of 1..17 tokens
// does 2*3*d*F operations per routed (token, expert) pair against 3*d*F
// weight elements per live expert, a few operations per byte: the expert
// weights streamed from device memory are the cost. At OLMoE's d=2048,
// F=1024 one live expert is 12.58 MB of bf16 weights.
//
// Design: two passes, both over a slot's live rows only.
//   1. gate/up: a CTA per (F tile of 64 columns, block of 16 rows (8 when
//      C <= 8, a verification span), slot)
//      computes h = silu(x @ wg) * (x @ wu) (or gelu_tanh(x @ wu)) for its
//      tile and stores it in a float32 scratch [U,C,F].
//   2. down: a CTA per (d tile of 64 columns, block of rows, slot)
//      computes y = h @ wd for its tile and writes it in the input type.
// A CTA whose rows start at or past its slot's count (a dead slot, or rows
// past the count) loads nothing: in pass 1 it returns at once, in pass 2 it
// only writes its tile's zeros. So a dead expert streams no weights: the
// behaviour the TPU kernel imitates. Tiling F (pass 1) and d (pass 2) over
// CTAs gives 16 and 32 CTAs per live expert at OLMoE's shapes, so a 1-token
// pass (8 live experts) already fills the 132 SMs. Inside a CTA, 8 warps
// (16 for 8-row blocks) each take a slice of the contraction (d, then F)
// over chunks staged in shared memory; each lane reads two adjacent weight columns as
// one 4-byte load, so every weight element is read once per row block; the
// warps' partial sums are reduced through shared memory in a fixed order.
// No atomics: the result is the same bit for bit from run to run, and a
// slot computes the same bits whether the dense or the packed layout holds
// it. The price is h's round trip through device memory (4*F bytes per live
// row, against 6*d*F weight bytes per live expert).
//
// Two routes, chosen in `moe_gmm_fused` from (dtype, d, F), with the token
// tile from C: never from U or expert_ids (so a slot's bits do not depend
// on the layout); the route is reported back to the wrapper:
//
// bf16 with d and F multiples of 8 (TMA needs 16-byte row pitches),
// `ffn_wgmma`: the same two passes on the tensor cores, with the weights on
// the wide side of the product: a CTA computes 64 output features (F in
// pass 1, d in pass 2) of one slot as h^T = W^T x^T, the weight tile the
// wgmma's A operand (M = 64 features, read MN-major straight from w as
// stored, [K][M]) and the slot's token rows its B operand (N = 8 when
// C <= 8, 16 when C <= 16, else 128: a verification span fills one N tile,
// a prefill's ~64 live rows a slot one 128-row tile). One producer warp
// streams the K dimension in steps of 64 through a ring of 128-byte-
// swizzled stages (the weight tiles, 8 KB each, and the token tile) with
// TMA, behind full/empty mbarriers; a consumer warpgroup runs wgmma on
// each stage with float32 accumulators in registers and frees it. Every
// live row tile of the slot runs in the same CTA, so a weight tile comes
// from device memory once per slot (a second row tile re-reads it from
// L2). Pass 1 applies silu(gate) * up (or gelu_tanh(up)) in registers and
// stores h at float32 precision as two bf16 planes, hi = bf16(h) and lo =
// bf16(h - hi) (the scratch is the float32 one's size): pass 2 multiplies
// each weight tile into both (h rounded to bf16 alone changed a trained
// model's greedy stream: PERF.md), stores y in bf16 and writes the zeros
// of rows past the count. A slot with no live row loads nothing.
// Sums run over K in one fixed order: no atomics, no split K.
//
// float32, and bf16 at other widths, `gate_up` / `down` below: the CUDA
// cores, h in float32.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BN = 64;   // output columns per CTA (two per lane)
constexpr int KPW = 64;  // contraction steps per warp per staged chunk

// A CTA of BC-row blocks: 128/BC warps split the contraction, so 8-row
// blocks (verification spans) run 16 warps and keep twice the weight loads
// in flight. The staged chunk of A (BC*DK floats) and the warps' partial
// sums (WARPS*BC*BN floats) are both 32 KB and share one buffer.
template <int BC>
struct Tile {
  static constexpr int WARPS = 128 / BC;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int DK = WARPS * KPW;
};

// sums[j][r][n] = sum_k A[r][k] * W_j[k][n0 + n] for the CTA's rows r < nrows
// (rows past nrows read as zeros) and its BN columns, NW weight matrices
// sharing A. A is [rows, K] with row stride lda; W_j is [K, N]. The result
// lands in out[j] ([BC][BN] floats in shared memory); sA is BC*DK floats.
template <int BC, int NW, typename TA, typename TW>
__device__ __forceinline__ void rows_times_cols(
    const TA* __restrict__ A, long lda, int nrows, int K,
    const TW* const* W, int N, int n0, float* sA, float* const* out) {
  constexpr int WARPS = Tile<BC>::WARPS, THREADS = Tile<BC>::THREADS;
  constexpr int DK = Tile<BC>::DK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = n0 + 2 * lane;
  const bool n_in = n < N;  // N even, so n + 1 < N too
  float acc[NW][BC][2];
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int r = 0; r < BC; ++r) acc[j][r][0] = acc[j][r][1] = 0.f;

  for (int kc = 0; kc < K; kc += DK) {
    __syncthreads();
    for (int i = tid; i < BC * DK; i += THREADS) {
      const int r = i / DK, kk = kc + i % DK;
      sA[i] = (r < nrows && kk < K) ? rt::to_f(A[r * lda + kk]) : 0.f;
    }
    __syncthreads();
    const int kbeg = kc + warp * KPW;
    const int kend = min(kbeg + KPW, K);
    if (n_in) {
#pragma unroll 8
      for (int k = kbeg; k < kend; ++k) {
        float2 w[NW];
#pragma unroll
        for (int j = 0; j < NW; ++j)
          w[j] = rt::load2(W[j] + static_cast<long>(k) * N + n);
        const float* acol = sA + (k - kc);
#pragma unroll
        for (int r = 0; r < BC; ++r) {
          const float a = acol[r * DK];
#pragma unroll
          for (int j = 0; j < NW; ++j) {
            acc[j][r][0] += a * w[j].x;
            acc[j][r][1] += a * w[j].y;
          }
        }
      }
    }
  }

  // reduce the warps' partial sums in a fixed order (sA is free now)
  float* red = sA;  // [WARPS][BC][BN], the same 32 KB
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < BC; ++r) {
      red[(warp * BC + r) * BN + 2 * lane] = acc[j][r][0];
      red[(warp * BC + r) * BN + 2 * lane + 1] = acc[j][r][1];
    }
    __syncthreads();
    for (int i = tid; i < BC * BN; i += THREADS) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[w * BC * BN + i];
      out[j][i] = s;
    }
  }
  __syncthreads();
}

// pass 1: h[u, row, f] for the live rows of slot u
template <typename T, bool SWIGLU, int BC>
__global__ void __launch_bounds__(Tile<BC>::THREADS)
    gate_up(const T* __restrict__ x, const T* __restrict__ wg,
            const T* __restrict__ wu, const int* __restrict__ counts,
            const int* __restrict__ expert_ids, float* __restrict__ h,
            int C, int d, int F) {
  __shared__ float sA[BC * Tile<BC>::DK];
  __shared__ float sG[BC * BN];
  __shared__ float sU[BC * BN];
  const int f0 = blockIdx.x * BN, row0 = blockIdx.y * BC, u = blockIdx.z;
  const int cnt = min(counts[u], C);
  if (row0 >= cnt) return;  // dead slot or rows past the count: no loads
  const int nrows = min(BC, cnt - row0);
  const long e = expert_ids ? expert_ids[u] : u;
  const T* xs = x + (static_cast<long>(u) * C + row0) * d;
  if constexpr (SWIGLU) {
    const T* W[2] = {wg + e * d * F, wu + e * d * F};
    float* out[2] = {sG, sU};
    rows_times_cols<BC, 2>(xs, d, nrows, d, W, F, f0, sA, out);
  } else {
    const T* W[1] = {wu + e * d * F};
    float* out[1] = {sU};
    rows_times_cols<BC, 1>(xs, d, nrows, d, W, F, f0, sA, out);
  }
  float* hs = h + (static_cast<long>(u) * C + row0) * F;
  for (int i = threadIdx.x; i < BC * BN; i += Tile<BC>::THREADS) {
    const int r = i / BN, f = f0 + i % BN;
    if (r < nrows && f < F)
      hs[static_cast<long>(r) * F + f] =
          SWIGLU ? rt::silu(sG[i]) * sU[i] : rt::gelu_tanh(sU[i]);
  }
}

// pass 2: y[u, row, :] = h[u, row, :] @ wd[e]; zeros past the count
template <typename T, int BC>
__global__ void __launch_bounds__(Tile<BC>::THREADS)
    down(const float* __restrict__ h, const T* __restrict__ wd,
         const int* __restrict__ counts, const int* __restrict__ expert_ids,
         T* __restrict__ y, int C, int d, int F) {
  __shared__ float sA[BC * Tile<BC>::DK];
  __shared__ float sY[BC * BN];
  const int n0 = blockIdx.x * BN, row0 = blockIdx.y * BC, u = blockIdx.z;
  const int cnt = min(counts[u], C);
  const int nrows = max(0, min(BC, cnt - row0));
  if (nrows > 0) {
    const long e = expert_ids ? expert_ids[u] : u;
    const T* W[1] = {wd + e * F * d};
    float* out[1] = {sY};
    rows_times_cols<BC, 1>(h + (static_cast<long>(u) * C + row0) * F, F, nrows,
                       F, W, d, n0, sA, out);
  }
  T* ys = y + (static_cast<long>(u) * C + row0) * d;
  for (int i = threadIdx.x; i < BC * BN; i += Tile<BC>::THREADS) {
    const int r = i / BN, c = n0 + i % BN;
    if (row0 + r < C && c < d)
      ys[static_cast<long>(r) * d + c] = rt::from_f<T>(r < nrows ? sY[i] : 0.f);
  }
}

template <typename T, int BC>
int launch(const void* x, const void* wg, const void* wu, const void* wd,
           const int* counts, const int* expert_ids, float* h, void* y,
           int U, int C, int d, int F, bool swiglu, cudaStream_t stream) {
  constexpr int THREADS = Tile<BC>::THREADS;
  const int rb = (C + BC - 1) / BC;
  dim3 grid1((F + BN - 1) / BN, rb, U);
  if (swiglu)
    gate_up<T, true, BC><<<grid1, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(wg),
        static_cast<const T*>(wu), counts, expert_ids, h, C, d, F);
  else
    gate_up<T, false, BC><<<grid1, THREADS, 0, stream>>>(
        static_cast<const T*>(x), nullptr, static_cast<const T*>(wu), counts,
        expert_ids, h, C, d, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid2((d + BN - 1) / BN, rb, U);
  down<T, BC><<<grid2, THREADS, 0, stream>>>(h, static_cast<const T*>(wd), counts,
                                         expert_ids, static_cast<T*>(y), C, d,
                                         F);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16, 16-byte rows: wgmma + TMA -------------------------------------

constexpr int WBM = 64;                 // output features per CTA (wgmma M)
constexpr int WBK = 64;                 // K per stage: one swizzled row
constexpr int W_TILE = WBK * WBM * 2;   // a weight tile [64 K][64 M], 8 KB
constexpr int WTHREADS = 128 + 32;      // a consumer warpgroup, a producer
enum { EPI_SWIGLU = 0, EPI_GELU = 1, EPI_DOWN = 2 };

// Stage: NW weight tiles, then NB N-row token tiles ([N][64], 128-byte
// rows: x, or h's two planes); every tile starts on a 1024-byte boundary.
// As many stages as fit in 112 KB (2 to 8), so two CTAs share an SM.
template <int N, int NW, int NB = 1>
struct WCfg {
  static constexpr int STAGE = NW * W_TILE + NB * N * WBK * 2;
  static constexpr int FIT = 114688 / STAGE;
  static constexpr int STAGES = FIT < 2 ? 2 : (FIT > 8 ? 8 : FIT);
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * 8 * STAGES;
};

// One slot u, output features m0..m0+63: out[u, r, m] over the live rows
// r < counts[u] of A_w^T (as stored: [E][K][M]) times the rows' B ([U][C]
// [K]), K in steps of 64. EPI_SWIGLU: h = silu(B A_0) * (B A_1);
// EPI_GELU: h = gelu_tanh(B A_0); h stored as the planes hi = bf16(h)
// (out) and lo = bf16(h - hi) (out + plane). EPI_DOWN: y = (B_hi + B_lo)
// A_0, h's planes read through mb and mb1, and zeros in rows
// counts[u]..C-1. At N = 128 (prefill: a slot's rows may span several
// tiles, and routing makes them uneven) the CTAs take the slots in order
// of their live rows, most first, so the longest CTAs start in the first
// wave; a slot's bits do not depend on which CTA computes it.
template <int N, int NW, int EPI>
__global__ void __launch_bounds__(WTHREADS)
    ffn_wgmma(const __grid_constant__ CUtensorMap ma0,
              const __grid_constant__ CUtensorMap ma1,
              const __grid_constant__ CUtensorMap mb,
              const __grid_constant__ CUtensorMap mb1,
              const int* __restrict__ counts,
              const int* __restrict__ expert_ids,
              __nv_bfloat16* __restrict__ out, long plane, int C, int K,
              int M) {
  constexpr int NB = EPI == EPI_DOWN ? 2 : 1;
  using Cfg = WCfg<N, NW, NB>;
  constexpr int STAGES = Cfg::STAGES, STAGE = Cfg::STAGE;
  const int m0 = blockIdx.x * WBM;
  int u = blockIdx.y;
  if constexpr (N == 128) {  // prefill: the slots, most rows first
    if (gridDim.y <= rt::LPT_MAX)
      u = rt::slot_by_rows(counts, gridDim.y, C, blockIdx.y);
  }
  const int cnt = min(max(counts[u], 0), C);
  __nv_bfloat16* outs = out + static_cast<long>(u) * C * M;
  if (EPI == EPI_DOWN) {  // rows past the count: zeros, 16 bytes a store
    constexpr int CH = WBM / 8;
    for (int i = threadIdx.x; i < (C - cnt) * CH; i += WTHREADS) {
      const int r = cnt + i / CH, c = m0 + (i % CH) * 8;
      if (c < M)
        *reinterpret_cast<uint4*>(outs + static_cast<long>(r) * M + c) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (cnt == 0) return;  // a dead slot: no loads
  const int e = expert_ids ? expert_ids[u] : u;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* tiles = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int n_k = (K + WBK - 1) / WBK;
  const int n_it = n_k * ((cnt + N - 1) / N);  // live row tiles only
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 4);  // lane 0 of every consumer warp
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer warp: TMA loads ----
    if (lane == 0) {
      for (int it = 0; it < n_it; ++it) {
        const int st = it % STAGES, k0 = (it % n_k) * WBK;
        unsigned char* stage = tiles + st * STAGE;
        hop::mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
        hop::mbar_expect_tx(&full[st], STAGE);
        hop::tma_load_3d(stage, &ma0, &full[st], m0, k0, e);
        if (NW == 2)
          hop::tma_load_3d(stage + W_TILE, &ma1, &full[st], m0, k0, e);
        hop::tma_load_3d(stage + NW * W_TILE, &mb, &full[st], k0,
                         (it / n_k) * N, u);
        if (NB == 2)
          hop::tma_load_3d(stage + NW * W_TILE + N * WBK * 2, &mb1,
                           &full[st], k0, (it / n_k) * N, u);
      }
    }
    return;
  }

  // ---- consumer warpgroup ----
  float acc[NW][N / 2];
  for (int it = 0; it < n_it; ++it) {
    const int st = it % STAGES;
    if (it % n_k == 0) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[w][i] = 0.f;
        hop::fence_regs(acc[w]);
      }
    }
    hop::mbar_wait(&full[st], (it / STAGES) & 1);
    const unsigned char* stage = tiles + st * STAGE;
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WBK / 16; ++kk) {
#pragma unroll
      for (int pl = 0; pl < NB; ++pl) {
        // B (token rows, K-major): k-step kk is 32 bytes into each row
        const uint64_t db = hop::desc_sw128(
            stage + NW * W_TILE + pl * N * WBK * 2 + kk * 32, 16, 1024);
#pragma unroll
        for (int w = 0; w < NW; ++w)  // A (w as [K][M], MN-major): 16 K rows
          hop::wgmma_ss<0, 1>(acc[w],
                              hop::desc_sw128(stage + w * W_TILE + kk * 2048,
                                              W_TILE, 1024),
                              db, 1);
      }
    }
    hop::wgmma_commit();
    // the previous step's products are done: free its stage
    hop::wgmma_wait<1>();
#pragma unroll
    for (int w = 0; w < NW; ++w) hop::fence_regs(acc[w]);
    if (it > 0 && lane == 0) hop::mbar_arrive(&empty[(it - 1) % STAGES]);
    if (it % n_k != n_k - 1) continue;

    // epilogue of row tile it / n_k: acc[w][4j + r] is feature
    // 16 * warp + lane / 4 + 8 * (r / 2), token row 8j + 2 * (lane % 4) +
    // r % 2 of the tile
    hop::wgmma_wait<0>();
#pragma unroll
    for (int w = 0; w < NW; ++w) hop::fence_regs(acc[w]);
    const int row0 = (it / n_k) * N;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + 16 * warp + lane / 4 + 8 * (r / 2);
        const int row = row0 + 8 * j + 2 * (lane % 4) + r % 2;
        if (row >= cnt || m >= M) continue;
        float val;
        if (EPI == EPI_SWIGLU)
          val = rt::silu(acc[0][4 * j + r]) * acc[NW - 1][4 * j + r];
        else if (EPI == EPI_GELU)
          val = rt::gelu_tanh(acc[0][4 * j + r]);
        else
          val = acc[0][4 * j + r];
        const __nv_bfloat16 hi = __float2bfloat16(val);
        outs[static_cast<long>(row) * M + m] = hi;
        if (EPI != EPI_DOWN)
          outs[plane + static_cast<long>(row) * M + m] =
              __float2bfloat16(val - __bfloat162float(hi));
      }
    }
  }
}

// A bf16 tensor [outer][mid][inner] as a 3-D map read in boxes of
// {64, rows, 1}.
cudaError_t map3(CUtensorMap* m, const void* base, int inner, int mid,
                 int outer, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(mid),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * 2,
                                 static_cast<cuuint64_t>(inner) * mid * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  return hop_host::bf16_map(m, base, 3, dims, strides, box);
}

template <int N>
int launch_wgmma(const void* x, const void* wg, const void* wu,
                 const void* wd, const int* counts, const int* expert_ids,
                 void* h, void* y, int U, int C, int d, int F, int E,
                 bool swiglu, cudaStream_t stream) {
  static bool smem_gate = false, smem_gelu = false, smem_down = false;
  auto hp = static_cast<__nv_bfloat16*>(h);
  const long plane = static_cast<long>(U) * C * F;  // h's lo plane
  CUtensorMap mx, mg, mu, mhi, mlo, md;
  cudaError_t err = map3(&mx, x, d, C, U, N);
  if (err == cudaSuccess && swiglu) err = map3(&mg, wg, F, d, E, WBK);
  if (err == cudaSuccess) err = map3(&mu, wu, F, d, E, WBK);
  if (err == cudaSuccess) err = map3(&mhi, hp, F, C, U, N);
  if (err == cudaSuccess) err = map3(&mlo, hp + plane, F, C, U, N);
  if (err == cudaSuccess) err = map3(&md, wd, d, F, E, WBK);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid1((F + WBM - 1) / WBM, U);
  if (swiglu) {
    auto kern = ffn_wgmma<N, 2, EPI_SWIGLU>;
    constexpr int smem = WCfg<N, 2>::SMEM;
    err = hop_host::allow_smem(kern, smem, smem_gate);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid1, WTHREADS, smem, stream>>>(mg, mu, mx, mx, counts,
                                            expert_ids, hp, plane, C, d, F);
  } else {
    auto kern = ffn_wgmma<N, 1, EPI_GELU>;
    constexpr int smem = WCfg<N, 1>::SMEM;
    err = hop_host::allow_smem(kern, smem, smem_gelu);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid1, WTHREADS, smem, stream>>>(mu, mu, mx, mx, counts,
                                            expert_ids, hp, plane, C, d, F);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kern = ffn_wgmma<N, 1, EPI_DOWN>;
  constexpr int smem = WCfg<N, 1, 2>::SMEM;
  err = hop_host::allow_smem(kern, smem, smem_down);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid2((d + WBM - 1) / WBM, U);
  kern<<<grid2, WTHREADS, smem, stream>>>(md, md, mhi, mlo, counts,
                                          expert_ids,
                                          static_cast<__nv_bfloat16*>(y), 0,
                                          C, F, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [U,C,d]; wg/wu [E,d,F]; wd [E,F,d]; counts [U] i32; expert_ids [U] i32
// or null (then E == U and slot u uses expert u); h [U,C,F] float32
// scratch on the simt route, the bf16 planes [2,U,C,F] (hi, lo: the same
// bytes) on the wgmma route; y [U,C,d]. d and
// F even; one dtype for x, weights and y; all 16-byte aligned. wg is
// ignored (may be null) when swiglu == 0. *route says which route ran.
// Returns a cudaError_t code (0 = launched).
extern "C" int moe_gmm_fused(const void* x, const void* wg, const void* wu,
                             const void* wd, const int* counts,
                             const int* expert_ids, void* h, void* y,
                             int U, int C, int d, int F, int E, int swiglu,
                             int dtype, void* stream, int* route) {
  if (U <= 0 || C <= 0 || d <= 0 || F <= 0 || E <= 0 || d % 2 || F % 2 ||
      C > 65535 * 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == RT_BF16 && d % 8 == 0 && F % 8 == 0) {
    *route = RT_ROUTE_WGMMA;
#define RT_MOE_W(NN)                                                        \
  return launch_wgmma<NN>(x, wg, wu, wd, counts, expert_ids, h, y, U, C, d,  \
                          F, E, swiglu != 0, st)
    if (C <= 8) RT_MOE_W(8);
    if (C <= 16) RT_MOE_W(16);
    RT_MOE_W(128);
#undef RT_MOE_W
  }
  *route = RT_ROUTE_SIMT;
  float* hf = static_cast<float*>(h);
  // verification spans (C <= 8) take 8-row blocks: half the registers, so
  // more CTAs, and more weight loads in flight, per SM
#define RT_MOE(TT, BCC)                                                     \
  return launch<TT, BCC>(x, wg, wu, wd, counts, expert_ids, hf, y, U, C, d, \
                         F, swiglu != 0, st)
  if (dtype == RT_BF16 && C <= 8) RT_MOE(__nv_bfloat16, 8);
  if (dtype == RT_BF16) RT_MOE(__nv_bfloat16, 16);
  if (dtype == RT_F32 && C <= 8) RT_MOE(float, 8);
  if (dtype == RT_F32) RT_MOE(float, 16);
#undef RT_MOE
  return static_cast<int>(cudaErrorInvalidValue);
}
