// Grouped expert matmul over the dense capacity dispatch, for Hopper:
// y[e] = x[e] @ w[e] (or x[e] @ w[e]^T), rows at or past counts[e] zero.
//
// Replaces: src/repro/kernels/moe_gmm/kernel.py, `moe_gmm` (the Pallas TPU
// kernel whose grid walks (expert, row block, column block, depth block)
// and skips the matmul, but not the loads, of row blocks past the count).
// Oracle: src/repro/kernels/moe_gmm/ref.py, `moe_gmm_ref`.
//
// On the training path it carries the three expert products of the dense
// MoE branch and, with trans_w = 1, their input gradients dx = dy @ w^T,
// reading w [E,d,F] as [E,F,d] without building the transpose.
//
// What bounds it on the card: at OLMoE's training shape (E=64, C=321,
// d=2048, F=1024) a call moves ~0.39 GB (x, all experts' w, y) and does
// ~69 GFLOP on the live rows, 0.12 ms of bytes against 0.07 ms of bf16
// tensor-core operations: the bytes, most of them the weights.
//
// Three routes, chosen in `moe_gmm_grouped` from dtype and shape alone and
// reported back to the wrapper. Every route gives one CTA an output tile of
// one expert; a tile whose first row is at or past counts[e] writes zeros
// and loads nothing; the sums have a fixed order (no split-K, no atomics),
// so two calls give the same bits.
//
// bf16 with d and F multiples of 8 (TMA needs 16-byte row pitches),
// `gmm_wgmma`: a 128x256 tile, two consumer warpgroups of 64 rows and one
// producer warp. The producer streams K in steps of 64 through a 4-stage
// ring of 128-byte-swizzled shared tiles (16 KB of x, 32 KB of w) with TMA
// (hopper.cuh), each stage completing on a `full` mbarrier and freed by
// the consumers through an `empty` one. The tensor maps are 3-D over
// [E,C,d] and over w as stored, so a tile never reads the next expert's
// rows and the edges of C, d and F read as zeros. The consumers run
// wgmma from shared memory with float32 accumulators in registers (w as
// [K,N] is MN-major, as [N,K] K-major), keeping one step's products in
// flight while the next waits for its tiles, and write bf16 with rows at
// or past the count as zeros. The grid runs row tiles fastest, so the row
// tiles of one (expert, column tile) share its w tile through L2. Every
// tile is read from L2 once per CTA that needs it, so the tile's shape
// sets the L2 traffic: 128x256 moves 1.15 GB at OLMoE's gate/up product,
// 128x128 moved 1.57 GB and ran 0.195 ms on an H100 against bmm's 0.153,
// 128x256 0.175. A thread-block cluster of the row tiles, each loading a
// share of the w tile and multicasting it to the others (0.61 GB), ran
// 0.51 ms there and is not used.
//
// bf16 with d or F not a multiple of 8, `gmm_bf16`: WMMA (16x16x16, float
// accumulators), a 64x128 tile, 8 warps of 32x32, K in steps of 32 staged
// through shared memory by element loads, the next step in flight in
// registers while the current step multiplies.
//
// float32, `gmm_f32`: the CUDA cores (64x64 tiles, 4x4 per thread), so a
// float32 model keeps float32 products. Edge tiles are masked on every
// route, never padded in memory.
#include "common.cuh"
#include "hopper.cuh"

#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;

// ---- bf16, 16-byte rows: wgmma + TMA -----------------------------------

constexpr int GBM = 128, GBN = 256, GBK = 64, GSTAGES = 4;
constexpr int GTHREADS = 2 * 128 + 32;  // two consumer warpgroups, a producer
constexpr int G_TILE_A = GBM * GBK * 2;  // x: [128 rows][64], one slab
constexpr int G_TILE_B = GBK * GBN * 2;  // w: [64][256] as four slabs, or
                                         // [256][64] as one
constexpr int G_SMEM = 1024 + GSTAGES * (G_TILE_A + G_TILE_B) + 128;

template <bool TRANS>
__global__ void __launch_bounds__(GTHREADS, 1)
    gmm_wgmma(const __grid_constant__ CUtensorMap mx,
              const __grid_constant__ CUtensorMap mw,
              const int* __restrict__ counts, __nv_bfloat16* __restrict__ y,
              int C, int K, int N) {
  const int m0 = blockIdx.x * GBM, n0 = blockIdx.y * GBN, e = blockIdx.z;
  const int live = min(max(counts[e], 0), C);
  __nv_bfloat16* ye = y + static_cast<long>(e) * C * N;
  if (m0 >= live) {  // a dead tile: zeros below C, no loads
    for (int i = threadIdx.x; i < GBM * (GBN / 8); i += GTHREADS) {
      const int r = i / (GBN / 8), c = (i % (GBN / 8)) * 8;
      if (m0 + r < C && n0 + c < N)
        *reinterpret_cast<uint4*>(ye + static_cast<long>(m0 + r) * N + n0 +
                                  c) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* sB = sA + GSTAGES * GBM * GBK;
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + GSTAGES * GBK * GBN);
  uint64_t* empty = full + GSTAGES;
  const int n_steps = (K + GBK - 1) / GBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {
    // ---- producer warp: TMA loads ----
    if (lane == 0) {
      for (int it = 0; it < n_steps; ++it) {
        const int st = it % GSTAGES, k0 = it * GBK;
        __nv_bfloat16* a = sA + st * GBM * GBK;
        __nv_bfloat16* b = sB + st * GBK * GBN;
        hop::mbar_wait(&empty[st], ((it / GSTAGES) & 1) ^ 1);
        hop::mbar_expect_tx(&full[st], G_TILE_A + G_TILE_B);
        hop::tma_load_3d(a, &mx, &full[st], k0, m0, e);
        if (TRANS) {  // w [E,N,K]: 256 rows of N, 64 of K
          hop::tma_load_3d(b, &mw, &full[st], k0, n0, e);
        } else {      // w [E,K,N]: 64 rows of K, four slabs of 64 N
#pragma unroll
          for (int s = 0; s < GBN / 64; ++s)
            hop::tma_load_3d(b + s * GBK * 64, &mw, &full[st], n0 + 64 * s,
                             k0, e);
        }
      }
    }
  } else {
    // ---- consumer warpgroup g: rows m0 + 64 g .. + 63 ----
    const int g = warp / 4;
    const bool rows_live = m0 + 64 * g < live;
    float acc[GBN / 2];
#pragma unroll
    for (int i = 0; i < GBN / 2; ++i) acc[i] = 0.f;
    hop::fence_regs(acc);
    for (int it = 0; it < n_steps; ++it) {
      const int st = it % GSTAGES;
      hop::mbar_wait(&full[st], (it / GSTAGES) & 1);
      if (rows_live) {
        const __nv_bfloat16* a = sA + st * GBM * GBK + g * 64 * 64;
        const __nv_bfloat16* b = sB + st * GBK * GBN;
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GBK / 16; ++kk) {
          const uint64_t da = hop::desc_sw128(a + kk * 16, 16, 1024);
          if (TRANS)  // K-major: k-step kk is 32 bytes into each row
            hop::wgmma_ss<0>(acc, da, hop::desc_sw128(b + kk * 16, 16, 1024),
                             1);
          else        // MN-major: 16 rows of K on; next 64 N a slab on
            hop::wgmma_ss<1>(acc, da,
                             hop::desc_sw128(b + kk * 16 * 64, GBK * 128,
                                             1024),
                             1);
        }
        hop::wgmma_commit();
        // the previous step's products are done: free its stage
        hop::wgmma_wait<1>();
        hop::fence_regs(acc);
      }
      if (it > 0 && lane == 0) hop::mbar_arrive(&empty[(it - 1) % GSTAGES]);
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);

    // epilogue: bf16 pairs; rows at or past the count as zeros
    const int c_lane = 2 * (lane % 4);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + 64 * g + 16 * (warp % 4) + lane / 4 + 8 * hh;
      if (m >= C) continue;
      const bool keep = m < live;
      __nv_bfloat16* yrow = ye + static_cast<long>(m) * N + n0 + c_lane;
#pragma unroll
      for (int j = 0; j < GBN / 8; ++j) {
        if (n0 + 8 * j + c_lane >= N) continue;
        *reinterpret_cast<uint32_t*>(yrow + 8 * j) =
            keep ? hop::pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1])
                 : 0u;
      }
    }
  }
}

template <bool TRANS>
int launch_wgmma(const void* x, const void* w, const int* counts, void* y,
                 int E, int C, int K, int N, cudaStream_t stream) {
  const cuuint64_t dx[3] = {static_cast<cuuint64_t>(K),
                            static_cast<cuuint64_t>(C),
                            static_cast<cuuint64_t>(E)};
  const cuuint64_t sx[2] = {static_cast<cuuint64_t>(K) * 2,
                            static_cast<cuuint64_t>(C) * K * 2};
  const cuuint32_t bx[3] = {GBK, GBM, 1};
  // w as stored: [E,N,K] (TRANS) or [E,K,N]
  const cuuint64_t inner = TRANS ? K : N, outer = TRANS ? N : K;
  const cuuint64_t dw[3] = {inner, outer, static_cast<cuuint64_t>(E)};
  const cuuint64_t sw[2] = {inner * 2, inner * outer * 2};
  const cuuint32_t bw[3] = {64, static_cast<cuuint32_t>(TRANS ? GBN : GBK),
                            1};
  CUtensorMap mx, mw;
  cudaError_t err = hop_host::bf16_map(&mx, x, 3, dx, sx, bx);
  if (err == cudaSuccess) err = hop_host::bf16_map(&mw, w, 3, dw, sw, bw);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gmm_wgmma<TRANS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((C + GBM - 1) / GBM, (N + GBN - 1) / GBN, E);
  gmm_wgmma<TRANS><<<grid, GTHREADS, G_SMEM, stream>>>(
      mx, mw, counts, static_cast<__nv_bfloat16*>(y), C, K, N);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16, rows not 16-byte multiples: WMMA ------------------------------

constexpr int TBM = 64, TBN = 128, TBK = 32;
constexpr int TTHREADS = 256;           // 8 warps: 2 (rows) x 4 (columns)
constexpr int A_LD = TBK + 8;           // sA [TBM][A_LD]   (bf16)
constexpr int B_LD = TBN + 8;           // sB [TBK][B_LD]   (w as [K,N])
constexpr int BT_LD = TBK + 8;          // sB [TBN][BT_LD]  (w as [N,K])
constexpr int C_LD = TBN + 4;           // sC [TBM][C_LD]   (float)
constexpr int SMEM_AB =
    2 * (TBM * A_LD + (TBK * B_LD > TBN * BT_LD ? TBK * B_LD : TBN * BT_LD));
constexpr int SMEM_C = 4 * TBM * C_LD;
constexpr int SMEM = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;

// 8 bf16 from row[col..col+7]; elements at or past n_valid read as zero.
// Element loads: on this route rows are not 16-byte multiples.
__device__ __forceinline__ uint4 load_chunk(const __nv_bfloat16* row,
                                            int col, int n_valid) {
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (n_valid <= 0) return out;
  const unsigned short* src = reinterpret_cast<const unsigned short*>(row);
  unsigned short* h = reinterpret_cast<unsigned short*>(&out);
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = e < n_valid ? src[col + e] : 0;
  return out;
}

template <bool TRANS>
__global__ void __launch_bounds__(TTHREADS)
    gmm_bf16(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ w,
             const int* __restrict__ counts, __nv_bfloat16* __restrict__ y,
             int C, int K, int N) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + TBM * A_LD;
  float* sC = reinterpret_cast<float*>(smem);

  const int n0 = blockIdx.x * TBN, m0 = blockIdx.y * TBM, e = blockIdx.z;
  const int live = min(max(counts[e], 0), C);
  const int rows_live = min(TBM, live - m0);  // <= 0: a dead tile
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  const __nv_bfloat16* xe = x + static_cast<long>(e) * C * K;
  const __nv_bfloat16* we = w + static_cast<long>(e) * K * N;
  __nv_bfloat16* ye = y + static_cast<long>(e) * C * N;

  if (rows_live > 0) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    // chunk layout: A 64 rows x 4 chunks (one per thread); B 512 chunks
    // (two per thread): [K,N] 32 rows x 16 chunks, or [N,K] 128 x 4
    const int ar = tid >> 2, ac = (tid & 3) * 8;
    uint4 ra, rb[2];
    auto fetch = [&](int k0) {
      ra = ar < rows_live
               ? load_chunk(xe + static_cast<long>(m0 + ar) * K, k0 + ac,
                            K - k0 - ac)
               : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int id = tid + j * TTHREADS;
        if (TRANS) {
          const int r = id >> 2, c = (id & 3) * 8;
          rb[j] = n0 + r < N
                      ? load_chunk(we + static_cast<long>(n0 + r) * K,
                                   k0 + c, K - k0 - c)
                      : make_uint4(0u, 0u, 0u, 0u);
        } else {
          const int r = id >> 4, c = (id & 15) * 8;
          rb[j] = k0 + r < K
                      ? load_chunk(we + static_cast<long>(k0 + r) * N,
                                   n0 + c, N - n0 - c)
                      : make_uint4(0u, 0u, 0u, 0u);
        }
      }
    };
    auto stage = [&]() {
      *reinterpret_cast<uint4*>(sA + ar * A_LD + ac) = ra;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int id = tid + j * TTHREADS;
        if (TRANS)
          *reinterpret_cast<uint4*>(sB + (id >> 2) * BT_LD +
                                    (id & 3) * 8) = rb[j];
        else
          *reinterpret_cast<uint4*>(sB + (id >> 4) * B_LD +
                                    (id & 15) * 8) = rb[j];
      }
    };

    using BLayout = typename std::conditional<TRANS, wmma::col_major,
                                              wmma::row_major>::type;
    fetch(0);
    for (int k0 = 0; k0 < K; k0 += TBK) {
      __syncthreads();  // the previous step's fragments are loaded
      stage();
      __syncthreads();
      if (k0 + TBK < K) fetch(k0 + TBK);  // in flight during the MMAs
#pragma unroll
      for (int kk = 0; kk < TBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout>
            fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], sA + (wm + 16 * i) * A_LD + kk, A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (TRANS)
            wmma::load_matrix_sync(fb[j], sB + (wn + 16 * j) * BT_LD + kk,
                                   BT_LD);
          else
            wmma::load_matrix_sync(fb[j], sB + kk * B_LD + wn + 16 * j,
                                   B_LD);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    __syncthreads();  // sC aliases sA and sB
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(sC + (wm + 16 * i) * C_LD + wn + 16 * j,
                                acc[i][j], C_LD, wmma::mem_row_major);
    __syncthreads();
  }

  // epilogue: live rows from sC, the tile's other rows below C as zeros
  for (int id = tid; id < TBM * (TBN / 8); id += TTHREADS) {
    const int r = id / (TBN / 8), c = (id % (TBN / 8)) * 8;
    const int m = m0 + r, n = n0 + c, nv = min(8, N - n);
    if (m >= C || nv <= 0) continue;
    uint4 out;
    unsigned short* h = reinterpret_cast<unsigned short*>(&out);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const __nv_bfloat16 v =
          __float2bfloat16(r < rows_live ? sC[r * C_LD + c + t] : 0.f);
      h[t] = *reinterpret_cast<const unsigned short*>(&v);
    }
    unsigned short* dst =
        reinterpret_cast<unsigned short*>(ye + static_cast<long>(m) * N + n);
    for (int t = 0; t < nv; ++t) dst[t] = h[t];
  }
}

// ---- float32: CUDA cores --------------------------------------------------

constexpr int FBM = 64, FBN = 64, FBK = 16;
constexpr int FTHREADS = 256;           // 16 x 16 threads, 4x4 outputs each

template <bool TRANS>
__global__ void __launch_bounds__(FTHREADS)
    gmm_f32(const float* __restrict__ x, const float* __restrict__ w,
            const int* __restrict__ counts, float* __restrict__ y, int C,
            int K, int N) {
  __shared__ __align__(16) float sA[FBK][FBM + 4];  // A transposed: [k][m]
  __shared__ __align__(16) float sB[FBK][FBN + 4];  // [k][n]
  const int n0 = blockIdx.x * FBN, m0 = blockIdx.y * FBM, e = blockIdx.z;
  const int live = min(max(counts[e], 0), C);
  const int rows_live = min(FBM, live - m0);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* xe = x + static_cast<long>(e) * C * K;
  const float* we = w + static_cast<long>(e) * K * N;
  float* ye = y + static_cast<long>(e) * C * N;

  float acc[4][4] = {};
  if (rows_live > 0) {
    for (int k0 = 0; k0 < K; k0 += FBK) {
      __syncthreads();
      for (int i = tid; i < FBM * FBK; i += FTHREADS) {
        const int r = i / FBK, c = i % FBK;
        sA[c][r] = r < rows_live && k0 + c < K
                       ? xe[static_cast<long>(m0 + r) * K + k0 + c]
                       : 0.f;
      }
      for (int i = tid; i < FBK * FBN; i += FTHREADS) {
        if (TRANS) {  // w [N,K]: consecutive threads walk k
          const int r = i / FBK, c = i % FBK;
          sB[c][r] = n0 + r < N && k0 + c < K
                         ? we[static_cast<long>(n0 + r) * K + k0 + c]
                         : 0.f;
        } else {      // w [K,N]: consecutive threads walk n
          const int r = i / FBN, c = i % FBN;
          sB[r][c] = k0 + r < K && n0 + c < N
                         ? we[static_cast<long>(k0 + r) * N + n0 + c]
                         : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FBK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&sA[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&sB[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, m = m0 + r;
    if (m >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) ye[static_cast<long>(m) * N + n] = r < rows_live ? acc[i][j]
                                                                  : 0.f;
    }
  }
}

}  // namespace

// x [E,C,K]; w [E,K,N] (trans_w = 0) or [E,N,K] (trans_w = 1); counts [E]
// int32; y [E,C,N]; all contiguous, one dtype, 16-byte aligned. *route
// says which route ran. Returns a cudaError_t code (0 = launched).
extern "C" int moe_gmm_grouped(const void* x, const void* w, const void* counts,
                               void* y, int E, int C, int K, int N,
                               int trans_w, int dtype, void* stream,
                               int* route) {
  if (E < 0 || C < 0 || K < 0 || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* cnt = static_cast<const int*>(counts);
  if (dtype == RT_BF16 && K % 8 == 0 && N % 8 == 0) {
    *route = RT_ROUTE_WGMMA;
    if (E == 0 || C == 0 || N == 0) return 0;
    return trans_w ? launch_wgmma<true>(x, w, cnt, y, E, C, K, N, st)
                   : launch_wgmma<false>(x, w, cnt, y, E, C, K, N, st);
  }
  if (dtype == RT_BF16) {
    *route = RT_ROUTE_WMMA;
    if (E == 0 || C == 0 || N == 0) return 0;
    dim3 grid((N + TBN - 1) / TBN, (C + TBM - 1) / TBM, E);
    auto xp = static_cast<const __nv_bfloat16*>(x);
    auto wp = static_cast<const __nv_bfloat16*>(w);
    auto yp = static_cast<__nv_bfloat16*>(y);
    if (trans_w)
      gmm_bf16<true><<<grid, TTHREADS, 0, st>>>(xp, wp, cnt, yp, C, K, N);
    else
      gmm_bf16<false><<<grid, TTHREADS, 0, st>>>(xp, wp, cnt, yp, C, K, N);
  } else if (dtype == RT_F32) {
    *route = RT_ROUTE_SIMT;
    if (E == 0 || C == 0 || N == 0) return 0;
    dim3 grid((N + FBN - 1) / FBN, (C + FBM - 1) / FBM, E);
    auto xp = static_cast<const float*>(x);
    auto wp = static_cast<const float*>(w);
    auto yp = static_cast<float*>(y);
    if (trans_w)
      gmm_f32<true><<<grid, FTHREADS, 0, st>>>(xp, wp, cnt, yp, C, K, N);
    else
      gmm_f32<false><<<grid, FTHREADS, 0, st>>>(xp, wp, cnt, yp, C, K, N);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
