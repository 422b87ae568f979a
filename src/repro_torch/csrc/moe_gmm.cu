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
#include "common.cuh"

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

}  // namespace

// x [U,C,d]; wg/wu [E,d,F]; wd [E,F,d]; counts [U] i32; expert_ids [U] i32
// or null (then E == U and slot u uses expert u); h [U,C,F] f32 scratch;
// y [U,C,d]. d and F even; one dtype for x, weights and y. wg is ignored
// (may be null) when swiglu == 0. Returns a cudaError_t code (0 = launched).
extern "C" int moe_gmm_fused(const void* x, const void* wg, const void* wu,
                             const void* wd, const int* counts,
                             const int* expert_ids, float* h, void* y,
                             int U, int C, int d, int F, int swiglu,
                             int dtype, void* stream) {
  if (U <= 0 || C <= 0 || d <= 0 || F <= 0 || d % 2 || F % 2 ||
      C > 65535 * 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // verification spans (C <= 8) take 8-row blocks: half the registers, so
  // more CTAs, and more weight loads in flight, per SM
#define RT_MOE(TT, BCC)                                                     \
  return launch<TT, BCC>(x, wg, wu, wd, counts, expert_ids, h, y, U, C, d,  \
                         F, swiglu != 0, st)
  if (dtype == RT_BF16 && C <= 8) RT_MOE(__nv_bfloat16, 8);
  if (dtype == RT_BF16) RT_MOE(__nv_bfloat16, 16);
  if (dtype == RT_F32 && C <= 8) RT_MOE(float, 8);
  if (dtype == RT_F32) RT_MOE(float, 16);
#undef RT_MOE
  return static_cast<int>(cudaErrorInvalidValue);
}
