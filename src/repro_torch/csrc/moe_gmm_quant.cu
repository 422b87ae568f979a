// Fused MoE expert FFN over int8 expert weights: for each slot u with
// counts[u] live rows, y[u] = (silu(x[u] @ (wg[e]*sg[e])) * (x[u] @
// (wu[e]*su[e]))) @ (wd[e]*sd[e]), or gelu_tanh(x[u] @ (wu[e]*su[e])) @
// (wd[e]*sd[e]), where e = expert_ids[u] (or u when no ids are given) and
// s*[e] is expert e's float32 absmax scale. Accumulated in float32, cast to
// the input type; rows past the count and dead slots are exact zeros.
//
// Replaces: src/repro/kernels/moe_gmm/kernel.py, `moe_gmm_fused_quant` (the
// Pallas TPU kernel that dequantizes each weight block in VMEM,
// `w.astype(f32) * scale`, with the scales riding the scalar-prefetch path
// beside the counts that steer dead slots' fetches).
//
// What bounds it on the card: bytes. A verification pass does a few
// operations per weight byte, so the int8 weights of the live experts
// streamed from device memory are the cost: at Mixtral's d=4096, F=14336
// one expert is 3*d*F = 176.2 MB per layer, half its bf16 size. A B=4
// [1+4] pass (7 live experts) moves 1.23 GB per layer, 0.37 ms at
// 3.35 TB/s; a one-token pass (2 live) 0.35 GB, 0.105 ms. A 512-token
// prefill does 2*3*d*F operations per routed row, ~0.18 ms at the bf16
// tensor-core rate, under its 0.43 ms of bytes.
//
// Both routes run K1's two deterministic passes (csrc/moe_gmm.cu):
//   1. gate/up: h = silu(sg*(x @ wg)) * (su*(x @ wu)) (or gelu_tanh(su*(x @
//      wu))) into a scratch [U,C,F];
//   2. down: y = sd*(h @ wd), written in the input type.
// Each slot's scale multiplies the finished float32 dot product once, never
// the weights. A slot whose rows start at or past its count loads nothing;
// sums run in one fixed order (no atomics, no split K), so a slot gives
// the same bits whatever layout (dense or packed) holds it. The route is
// chosen in `moe_gmm_fused_quant` from the dtype and C (d and F are
// multiples of 16 on both), with the token tile from C (never from U or
// expert_ids), and reported back to the wrapper.
//
// bf16, `ffn_q8_wgmma`: the tensor cores. A CTA computes 64 output features
// (F in pass 1, d in pass 2) of one slot as h^T = W^T x^T: the weights are
// wgmma's A operand (M = 64 features), the slot's token rows its B operand
// in tiles of N = 8, 16 or 32 rows when C <= 8, 16 or 32 (a verification
// span), else 128: each row tile in a CTA of its own, so a slot of many
// rows runs its tiles side by side. A tile is multiplied at the least of
// 8 and N (64 and 128 at N = 128) wgmma widths that holds its live rows,
// since a span's slot holds a few of its C rows and a prefill slot's
// rarely fill 128. One producer warp streams the contraction in steps of
// 64 through a ring of stages behind full/empty mbarriers, by TMA: the
// int8 weight tiles as stored ([64 K][64 M], 4 KB, 64-byte swizzle) and
// the live token rows in 8-row boxes (rows past the count are never
// loaded; their columns of the product are never stored). The consumer warpgroup dequantizes straight into wgmma's A
// fragments: ldmatrix.trans hands each thread the bytes of two adjacent
// features at two adjacent k, and a byte permute, two masks and one bf16x2
// fma turn two of them into an exact bf16 pair (|q| <= 127 fits bf16's 8
// significand bits: 0x4300 | (q & 0x7F) is 128 + (q & 127), 0x4300 |
// (q & 0x80) is 128 or 256, and their difference is q). Feeding A from
// registers (wgmma RS) keeps the converted tile out of shared memory, which
// would otherwise carry ~7 bytes of traffic per weight byte at a span's
// small N. A warp's 16 rows of A are its features 2p, 2p + 1 (p = lane / 4)
// in the order ldmatrix delivers them. In a span, each half stage's
// fragments are converted while the previous half's wgmmas run (the next
// stage's only if its data is in: a stage is never held waiting for the
// next). Pass 1 keeps h at float32 precision as two bf16 planes, hi =
// bf16(h) and lo = bf16(h - hi) (the scratch is the float32 one's size);
// pass 2 multiplies each weight fragment into both, so h is carried to
// ~2^-17 relative, as the reference's float32 h, and adds each stage's
// products to its accumulators in float32. At N = 128 (prefill: routing
// makes a slot's rows uneven) the CTAs take the slots in order of their
// live rows, most first.
//
// float32, and bf16 at C = 1 (a one-token pass: two live experts give too
// few CTAs to keep TMA rings fed, and this route was faster there),
// `gate_up_q8` / `down_q8`: the CUDA cores, h in float32.
// Each thread loads 16 int8 weights of one row of W at a time (one 16-byte
// load: 8 or 4 lanes cover a row segment of 128 or 64 bytes, the other
// lanes of the warp take the next rows of the contraction) and converts
// them in registers with integer byte permutes and one float subtract (no
// int-to-float conversion unit): 2^23 + (q + 128) is built as a bit
// pattern, so subtracting 2^23 + 128 gives q exactly. The activations are
// staged in shared memory as float32, [k][row], so one vector load gives a
// thread every row of its step. A chunk's first weights are loaded before
// the barriers that stage its activations, so their latency overlaps
// them; 1- and 4-row blocks are held to 128 registers, so two CTAs share
// an SM and keep twice the loads in flight. Partial sums over the
// contraction are reduced by warp shuffles and then through shared memory,
// both in a fixed order. The row block is the fastest grid index, so the
// CTAs of one weight tile run together and a second row block finds the
// tile in L2.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int VEC = 16;      // int8 weights per thread per load
constexpr int STEPS = 16;    // contraction steps per thread per chunk
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LN_UP = 8;     // lanes across columns, pass 1 (128 columns)
constexpr int LN_DOWN = 4;   // lanes across columns, pass 2 (64 columns)
// CTAs per SM the register budget must allow: two for 1- and 4-row blocks
// (at most 128 registers a thread), so more weight loads are in flight
#define MIN_CTAS(BC) ((BC) <= 4 ? 2 : 1)

// NW weight matrices share the staged rows (gate and up: NW = 2); the
// warps are split evenly between them, each warp taking a slice of the
// contraction. LN lanes of a warp cover a row segment of W, the KG = 32/LN
// lane groups take consecutive rows of the contraction.
template <int BC, int NW, int LN>
struct QTile {
  static constexpr int KG = 32 / LN;
  static constexpr int BN = LN * VEC;
  static constexpr int KSPLIT = WARPS / NW;
  static constexpr int KW = KG * STEPS;        // contraction rows per warp
  static constexpr int DK = KSPLIT * KW;       // contraction rows per chunk
  static constexpr int SA = DK * BC;           // staged activations
  static constexpr int RED = NW * KSPLIT * BC * BN;  // warps' partial sums
  static constexpr int BUF = SA > RED ? SA : RED;
};

// Four signed bytes of `w` as exact floats.
__device__ __forceinline__ void i8x4(unsigned w, float* f) {
  const unsigned u = w ^ 0x80808080u;  // q + 128, an unsigned byte
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
           8388736.f;  // 2^23 + 128
}

__device__ __forceinline__ int4 load16(const int8_t* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

// out[j][r][n] = sum_k A[r][k] * W_j[k][n0 + n] over this CTA's rows
// r < nrows (rows past nrows read as zeros) and its BN columns, for the NW
// int8 matrices W_0 = W0, W_1 = W1 ([K, N], N % 16 == 0) sharing A ([rows,
// K], row stride lda). Unscaled: the caller applies the slot's scale. buf
// holds BUF floats and out NW*BC*BN floats, both in shared memory.
template <int BC, int NW, int LN, typename TA>
__device__ __forceinline__ void rows_times_q8(
    const TA* __restrict__ A, long lda, int nrows, int K,
    const int8_t* __restrict__ W0, const int8_t* __restrict__ W1, int N,
    int n0, float* buf, float* out) {
  using Q = QTile<BC, NW, LN>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j = warp / Q::KSPLIT, kw = warp % Q::KSPLIT;
  const int g = lane / LN, cl = lane % LN;
  const int n = n0 + cl * VEC;
  const bool n_in = n < N;
  const int8_t* Wj = (NW == 2 && j == 1) ? W1 : W0;
  const int kb = kw * Q::KW + g;  // this thread's first row within a chunk

  float acc[BC][VEC];
#pragma unroll
  for (int r = 0; r < BC; ++r)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[r][c] = 0.f;

  for (int kc = 0; kc < K; kc += Q::DK) {
    int4 w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // first weights, before the barriers
      const int k = kc + kb + u * Q::KG;
      w[u] = (n_in && k < K) ? load16(Wj + static_cast<long>(k) * N + n)
                             : make_int4(0, 0, 0, 0);
    }
    __syncthreads();
    for (int i = tid; i < BC * Q::DK; i += THREADS) {
      const int r = i / Q::DK, kk = i % Q::DK;
      buf[kk * BC + r] = (r < nrows && kc + kk < K)
                             ? rt::to_f(A[r * lda + kc + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int s0 = 0; s0 < STEPS; s0 += 4) {
      if (s0 > 0) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {  // the next four rows
          const int k = kc + kb + (s0 + u) * Q::KG;
          w[u] = (n_in && k < K) ? load16(Wj + static_cast<long>(k) * N + n)
                                 : make_int4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* as = buf + (kb + (s0 + u) * Q::KG) * BC;
        float a[BC];
        if constexpr (BC % 4 == 0) {
#pragma unroll
          for (int r = 0; r < BC; r += 4) {
            const float4 v = *reinterpret_cast<const float4*>(as + r);
            a[r] = v.x; a[r + 1] = v.y; a[r + 2] = v.z; a[r + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int r = 0; r < BC; ++r) a[r] = as[r];
        }
        float wf[VEC];
        i8x4(static_cast<unsigned>(w[u].x), wf);
        i8x4(static_cast<unsigned>(w[u].y), wf + 4);
        i8x4(static_cast<unsigned>(w[u].z), wf + 8);
        i8x4(static_cast<unsigned>(w[u].w), wf + 12);
#pragma unroll
        for (int r = 0; r < BC; ++r)
#pragma unroll
          for (int c = 0; c < VEC; ++c)
            acc[r][c] = fmaf(a[r], wf[c], acc[r][c]);
      }
    }
  }

  // sum the KG lane groups of each column (a butterfly: every lane ends
  // with the same bits), then the warps of each matrix in a fixed order
#pragma unroll
  for (int r = 0; r < BC; ++r)
#pragma unroll
    for (int c = 0; c < VEC; ++c)
#pragma unroll
      for (int o = LN; o < 32; o <<= 1)
        acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], o);
  __syncthreads();  // buf is free: every warp is past its last chunk
  if (g == 0) {
    float* red = buf + ((j * Q::KSPLIT + kw) * BC) * Q::BN + cl * VEC;
#pragma unroll
    for (int r = 0; r < BC; ++r)
#pragma unroll
      for (int c = 0; c < VEC; c += 4)
        *reinterpret_cast<float4*>(red + r * Q::BN + c) =
            make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2],
                        acc[r][c + 3]);
  }
  __syncthreads();
  for (int i = tid; i < NW * BC * Q::BN; i += THREADS) {
    const int jj = i / (BC * Q::BN), rest = i % (BC * Q::BN);
    const float* red = buf + jj * Q::KSPLIT * BC * Q::BN + rest;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < Q::KSPLIT; ++w) s += red[w * BC * Q::BN];
    out[i] = s;
  }
  __syncthreads();
}

// pass 1: h[u, row, f] for the live rows of slot u
template <typename T, bool SWIGLU, int BC>
__global__ void __launch_bounds__(THREADS, MIN_CTAS(BC))
    gate_up_q8(const T* __restrict__ x, const int8_t* __restrict__ wg,
               const int8_t* __restrict__ wu, const float* __restrict__ sg,
               const float* __restrict__ su, const int* __restrict__ counts,
               const int* __restrict__ expert_ids, float* __restrict__ h,
               int C, int d, int F) {
  constexpr int NW = SWIGLU ? 2 : 1;
  using Q = QTile<BC, NW, LN_UP>;
  __shared__ __align__(16) float buf[Q::BUF];
  __shared__ __align__(16) float sOut[NW * BC * Q::BN];
  const int row0 = blockIdx.x * BC, f0 = blockIdx.y * Q::BN, u = blockIdx.z;
  const int cnt = min(counts[u], C);
  if (row0 >= cnt) return;  // dead slot or rows past the count: no loads
  const int nrows = min(BC, cnt - row0);
  const long e = expert_ids ? expert_ids[u] : u;
  const T* xs = x + (static_cast<long>(u) * C + row0) * d;
  const long off = e * d * F;
  if constexpr (SWIGLU)
    rows_times_q8<BC, 2, LN_UP>(xs, d, nrows, d, wg + off, wu + off, F, f0,
                                buf, sOut);
  else
    rows_times_q8<BC, 1, LN_UP>(xs, d, nrows, d, wu + off, nullptr, F, f0,
                                buf, sOut);
  const float s_up = su[e];
  const float s_gate = SWIGLU ? sg[e] : 0.f;
  float* hs = h + (static_cast<long>(u) * C + row0) * F;
  for (int i = threadIdx.x; i < BC * Q::BN; i += THREADS) {
    const int r = i / Q::BN, f = f0 + i % Q::BN;
    if (r < nrows && f < F) {
      const float up = s_up * sOut[(NW - 1) * BC * Q::BN + i];
      hs[static_cast<long>(r) * F + f] =
          SWIGLU ? rt::silu(s_gate * sOut[i]) * up : rt::gelu_tanh(up);
    }
  }
}

// pass 2: y[u, row, :] = sd * (h[u, row, :] @ wd[e]); zeros past the count
template <typename T, int BC>
__global__ void __launch_bounds__(THREADS, MIN_CTAS(BC))
    down_q8(const float* __restrict__ h, const int8_t* __restrict__ wd,
            const float* __restrict__ sd, const int* __restrict__ counts,
            const int* __restrict__ expert_ids, T* __restrict__ y, int C,
            int d, int F) {
  using Q = QTile<BC, 1, LN_DOWN>;
  __shared__ __align__(16) float buf[Q::BUF];
  __shared__ __align__(16) float sOut[BC * Q::BN];
  const int row0 = blockIdx.x * BC, n0 = blockIdx.y * Q::BN, u = blockIdx.z;
  const int cnt = min(counts[u], C);
  const int nrows = max(0, min(BC, cnt - row0));
  float s_down = 0.f;
  if (nrows > 0) {
    const long e = expert_ids ? expert_ids[u] : u;
    rows_times_q8<BC, 1, LN_DOWN>(h + (static_cast<long>(u) * C + row0) * F,
                                  F, nrows, F, wd + e * F * d, nullptr, d,
                                  n0, buf, sOut);
    s_down = sd[e];
  }
  T* ys = y + (static_cast<long>(u) * C + row0) * d;
  for (int i = threadIdx.x; i < BC * Q::BN; i += THREADS) {
    const int r = i / Q::BN, c = n0 + i % Q::BN;
    if (row0 + r < C && c < d)
      ys[static_cast<long>(r) * d + c] =
          rt::from_f<T>(r < nrows ? s_down * sOut[i] : 0.f);
  }
}

template <typename T, int BC>
int launch(const void* x, const int8_t* wg, const int8_t* wu,
           const int8_t* wd, const float* sg, const float* su,
           const float* sd, const int* counts, const int* expert_ids,
           float* h, void* y, int U, int C, int d, int F, bool swiglu,
           cudaStream_t stream) {
  const int rb = (C + BC - 1) / BC;
  dim3 grid1(rb, (F + 127) / 128, U);
  if (swiglu)
    gate_up_q8<T, true, BC><<<grid1, THREADS, 0, stream>>>(
        static_cast<const T*>(x), wg, wu, sg, su, counts, expert_ids, h, C,
        d, F);
  else
    gate_up_q8<T, false, BC><<<grid1, THREADS, 0, stream>>>(
        static_cast<const T*>(x), nullptr, wu, nullptr, su, counts,
        expert_ids, h, C, d, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid2(rb, (d + 63) / 64, U);
  down_q8<T, BC><<<grid2, THREADS, 0, stream>>>(
      h, wd, sd, counts, expert_ids, static_cast<T*>(y), C, d, F);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: int8 tiles by TMA, dequantized into wgmma's A fragments -------

constexpr int QBM = 64;                 // output features per CTA (wgmma M)
constexpr int QBK = 64;                 // K per stage
constexpr int Q_TILE = QBK * QBM;       // an int8 weight tile [64 K][64 M]
constexpr int QROWS = 8;                // token rows per TMA box
constexpr int QTHREADS = 128 + 32;      // a consumer warpgroup, a producer
enum { Q_SWIGLU = 0, Q_GELU = 1, Q_DOWN = 2 };

// A pass's plan at token tile N: pass 1 reads NW = 2 weight tiles (gate,
// up; 1 for gelu) and one token plane, pass 2 one weight tile and the two
// planes of h. A stage is the weight tiles, then each plane's N-row token
// tile ([N][64] bf16, 128-byte rows, 128-byte swizzle); every tile starts
// on a 1024-byte boundary. MINB CTAs share an SM: its shared memory (a
// CTA's ring fills its share, 2 to 8 stages) and registers. DB (spans):
// two sets of half a stage's A fragments (KS = 2 k steps of 16), the next
// half converted while this one's wgmmas run; else (N = 128) one set of
// KS k steps (1 with two weights, whose 128 accumulators leave room for
// no more), converted after the previous wgmmas end. PROMOTE (pass 2, the
// long K): each stage's products land in a fresh partial sum, added to the
// accumulator in float32 when the stage ends: wgmma's own accumulation
// keeps fewer bits than a float32 add, and over F = 14336 (896 k steps,
// twice for h's two planes) that drift shows in y's bf16 rounding
// (PERF.md).
template <int N, int EPI>
struct QPlan {
  static constexpr int NW = EPI == Q_SWIGLU ? 2 : 1;
  static constexpr int NB = EPI == Q_DOWN ? 2 : 1;
  static constexpr int MINB = N == 128 ? 2 : (NW == 2 ? 3 : 4);
  static constexpr bool DB = N != 128;
  static constexpr int KS = DB ? 2 : (N == 128 && NW == 2 ? 1 : 4);
  static constexpr bool PROMOTE = EPI == Q_DOWN;
  static constexpr int STAGE = NW * Q_TILE + NB * N * 128;
  static constexpr int BUDGET = 227 * 1024 / MINB - 2048;
  static constexpr int FIT = (BUDGET - 1024) / (STAGE + 16);
  static constexpr int STAGES = FIT < 2 ? 2 : (FIT > 8 ? 8 : FIT);
  static constexpr int SMEM = 1024 + STAGES * STAGE + 16 * STAGES;
};

// Two signed bytes of `w`, picked by the byte-permute selector `sel` into
// the low bytes of its halves, as an exact bf16x2 (see the header).
__device__ __forceinline__ uint32_t i8x2_bf16(uint32_t w, uint32_t sel) {
  const uint32_t x = __byte_perm(w, 0x43u, sel);
  const uint32_t low7 = x & 0xFF7FFF7Fu;   // 128 + (q & 127)
  const uint32_t sign = x & 0xFF80FF80u;   // 128, or 256 where q < 0
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(sign), "r"(0xBF80BF80u), "r"(low7));  // low7 - sign
  return r;
}

// One slot u, output features m0..m0+63: out[u, r, m] over the live rows
// r < counts[u] of the int8 A_w^T (as stored: [E][K][M]) times the rows'
// B ([U][C][K]), K in steps of 64, each product scaled by the expert's
// s0/s1. Q_SWIGLU: h = silu(s0 B A_0) * (s1 B A_1); Q_GELU: h =
// gelu_tanh(s0 B A_0); both stored as the planes hi (out) and lo (out +
// plane). Q_DOWN: y = s0 (B_hi A_0 + B_lo A_0), and zeros in rows
// counts[u]..C-1.
template <int N, int EPI>
__global__ void __launch_bounds__(QTHREADS, (QPlan<N, EPI>::MINB))
    ffn_q8_wgmma(const __grid_constant__ CUtensorMap ma0,
                 const __grid_constant__ CUtensorMap ma1,
                 const __grid_constant__ CUtensorMap mb0,
                 const __grid_constant__ CUtensorMap mb1,
                 const float* __restrict__ s0, const float* __restrict__ s1,
                 const int* __restrict__ counts,
                 const int* __restrict__ expert_ids,
                 __nv_bfloat16* __restrict__ out, long plane, int C, int K,
                 int M) {
  using P = QPlan<N, EPI>;
  constexpr int NW = P::NW, NB = P::NB, STAGES = P::STAGES;
  constexpr int STAGE = P::STAGE;
  // row tile t of the slot's T = ceil(C / N) (one at a span), each in a
  // CTA of its own: a slot of many rows runs its tiles side by side
  const int T = (C + N - 1) / N, MT = gridDim.x / T;
  const int t = blockIdx.x / MT;
  const int m0 = blockIdx.x % MT * QBM, row0 = t * N;
  int u = blockIdx.y;
  if constexpr (N == 128) {  // prefill: the slots, most rows first
    if (gridDim.y <= rt::LPT_MAX)
      u = rt::slot_by_rows(counts, gridDim.y, C, blockIdx.y);
  }
  const int cnt = min(max(counts[u], 0), C);
  __nv_bfloat16* outs = out + static_cast<long>(u) * C * M;
  if (EPI == Q_DOWN) {  // the tile's rows past the count: zeros, 16 bytes
    constexpr int CH = QBM / 8;    // a store
    const int z0 = max(cnt, row0), z1 = min(C, row0 + N);
    for (int i = threadIdx.x; i < (z1 - z0) * CH; i += QTHREADS) {
      const int r = z0 + i / CH, c = m0 + (i % CH) * 8;
      if (c < M)
        *reinterpret_cast<uint4*>(outs + static_cast<long>(r) * M + c) =
            make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (cnt <= row0) return;  // no live row in the tile: no loads
  const int e = expert_ids ? expert_ids[u] : u;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* tiles = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int n_k = (K + QBK - 1) / QBK;
  const int rows = min(N, cnt - row0);  // the tile's live rows
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
    // ---- producer warp: TMA loads of the weight tiles and live rows ----
    if (lane == 0) {
      const int boxes = (rows + QROWS - 1) / QROWS;
      for (int it = 0; it < n_k; ++it) {
        const int st = it % STAGES, k0 = it * QBK;
        unsigned char* stage = tiles + st * STAGE;
        hop::mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
        hop::mbar_expect_tx(&full[st],
                            NW * Q_TILE + NB * boxes * QROWS * QBK * 2);
        hop::tma_load_3d(stage, &ma0, &full[st], m0, k0, e);
        if (NW == 2)
          hop::tma_load_3d(stage + Q_TILE, &ma1, &full[st], m0, k0, e);
        for (int b = 0; b < boxes; ++b) {
          unsigned char* box = stage + NW * Q_TILE + b * QROWS * QBK * 2;
          hop::tma_load_3d(box, &mb0, &full[st], k0, row0 + QROWS * b, u);
          if (NB == 2)
            hop::tma_load_3d(box + N * QBK * 2, &mb1, &full[st], k0,
                             row0 + QROWS * b, u);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup ----
  // A fragments of KS k steps of 16 ([weight][k step][register]): warp w's
  // rows p and p + 8 (p = lane / 4) are features 16w + 2p and 16w + 2p + 1,
  // the pair ldmatrix.trans gives a lane from a 16-byte row segment; each
  // of its registers holds those two features at two adjacent k.
  constexpr int KS = P::KS, CHUNKS = QBK / 16 / KS;
  static_assert(!P::DB || CHUNKS == 2, "DB alternates two chunk sets");
  uint32_t fa[NW][KS][4], fb[NW][KS][4];
  const float scale0 = s0[e], scale1 = NW == 2 ? s1[e] : 0.f;

  // k steps KS ch .. KS ch + KS - 1 of stage st into f
  auto load_frags = [&](int st, int ch, uint32_t(&f)[NW][KS][4]) {
    const unsigned char* stage = tiles + st * STAGE;
    if constexpr (KS == 1) {  // one k step: lanes 0-15 give k = 16 ch + lane
      const int k = 16 * ch + (lane & 15);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        uint32_t r[2];
        hop::ldmatrix_x2_trans(
            r, stage + w * Q_TILE + k * QBM + 16 * (warp ^ ((k >> 1) & 3)));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          f[w][0][2 * i] = i8x2_bf16(r[i], 0x4240u);
          f[w][0][2 * i + 1] = i8x2_bf16(r[i], 0x4341u);
        }
      }
    } else {
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int hh = 0; hh < KS / 2; ++hh) {
          // lane l gives row k = 32 half + l of the tile: matrix l / 8
          // holds k = 32 half + 8 (l / 8) .. + 7 (64-byte swizzle: 16-byte
          // chunk c of row k sits at chunk c ^ ((k / 2) % 4))
          const int k = 32 * (ch * KS / 2 + hh) + lane;
          uint32_t r[4];
          hop::ldmatrix_x4_trans(
              r, stage + w * Q_TILE + k * QBM + 16 * (warp ^ ((k >> 1) & 3)));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // r[i]: bytes (k, 2p), (k, 2p + 1), (k + 1, 2p), (k + 1, 2p +
            // 1) at k = 32 half + 8i + 2 (lane % 4): k step 2 hh + i / 2 of
            // the chunk, registers 2 (i % 2) (row p) and + 1 (row p + 8)
            f[w][2 * hh + i / 2][2 * (i % 2)] = i8x2_bf16(r[i], 0x4240u);
            f[w][2 * hh + i / 2][2 * (i % 2) + 1] =
                i8x2_bf16(r[i], 0x4341u);
          }
        }
    }
  };

  // The row tile's products at wgmma width NT: 8 where its live rows fit
  // 8 (a span's slot holds a few of its C rows), 64 where they fit 64 at
  // N = 128 (a prefill slot's rarely fill a 128-row tile), else N; more
  // widths spill. A D element's sum does not depend on NT, and NT follows
  // the slot's count alone, so a slot's bits do not depend on its layout.
  auto row_tile = [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    float acc[NW][NT / 2];
    float part[NT / 2];  // PROMOTE: this stage's products
#pragma unroll
    for (int w = 0; w < NW; ++w) {
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[w][i] = 0.f;
      hop::fence_regs(acc[w]);
    }

    auto step = [&](int it) {
      const int st = it % STAGES, nx = (it + 1) % STAGES;
      bool converted = false;  // DB: the next stage's first chunk is in fa
      if (!P::DB) hop::mbar_wait(&full[st], (it / STAGES) & 1);
      const unsigned char* b = tiles + st * STAGE + NW * Q_TILE;
      // KS k steps of the stage on cur; DB: meanwhile the next chunk (this
      // stage's, or the next stage's first if its data is in) into nxt
      auto chunk = [&](int ch, uint32_t(&cur)[NW][KS][4],
                       uint32_t(&nxt)[NW][KS][4]) {
        if (!P::DB) load_frags(st, ch, cur);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
          for (int pl = 0; pl < NB; ++pl) {
            // B (token rows, K-major): k step j is 32 bytes into each row
            const uint64_t db = hop::desc_sw128(
                b + pl * N * QBK * 2 + (ch * KS + kk) * 32, 16, 1024);
#pragma unroll
            for (int w = 0; w < NW; ++w) {
              if (P::PROMOTE)
                hop::wgmma_rs<0>(part, cur[w][kk], db, ch + kk + pl > 0);
              else
                hop::wgmma_rs<0>(acc[w], cur[w][kk], db, 1);
            }
          }
        }
        hop::wgmma_commit();
        if (P::DB && ch + 1 < CHUNKS) {
          load_frags(st, ch + 1, nxt);
        } else if (P::DB && it + 1 < n_k &&
                   hop::mbar_test(&full[nx], ((it + 1) / STAGES) & 1)) {
          load_frags(nx, 0, nxt);
          converted = true;
        }
        hop::wgmma_wait<0>();
#pragma unroll
        for (int w = 0; w < NW; ++w) hop::fence_regs(acc[w]);
      };
      if constexpr (P::DB) {  // two chunks: fa, then fb
        chunk(0, fa, fb);
        chunk(1, fb, fa);
      } else {
#pragma unroll
        for (int ch = 0; ch < CHUNKS; ++ch) chunk(ch, fa, fa);
      }
      if (P::PROMOTE) {
        hop::fence_regs(part);
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) acc[0][i] += part[i];
      }
      // free the stage, then (never holding it waiting) the next stage's
      // first chunk if it was not in yet
      if (lane == 0) hop::mbar_arrive(&empty[st]);
      if (P::DB && it + 1 < n_k && !converted) {
        hop::mbar_wait(&full[nx], ((it + 1) / STAGES) & 1);
        load_frags(nx, 0, fa);
      }
    };

    for (int it = 0; it < n_k; ++it) step(it);  // DB: stage 0's first
                                                  // chunk already in fa

    // epilogue: acc[w][4j + r] is features f0 + r / 2, token row 8j +
    // 2 (lane % 4) + r % 2 of the tile
    const int f0 = m0 + 16 * warp + 2 * (lane / 4);
    if (f0 >= M) return;  // M even, so f0 + 1 < M too
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * j + 2 * (lane % 4) + r;
        if (row >= cnt) continue;
        float v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * j + 2 * c + r;
          if (EPI == Q_SWIGLU)
            v[c] = rt::silu(scale0 * acc[0][i]) * (scale1 * acc[NW - 1][i]);
          else
            v[c] = EPI == Q_GELU ? rt::gelu_tanh(scale0 * acc[0][i])
                                 : scale0 * acc[0][i];
        }
        __nv_bfloat16* o = outs + static_cast<long>(row) * M + f0;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[0], v[1]);
        *reinterpret_cast<__nv_bfloat162*>(o) = hi;
        if (EPI != Q_DOWN) {
          const float2 hf = __bfloat1622float2(hi);
          *reinterpret_cast<__nv_bfloat162*>(o + plane) =
              __floats2bfloat162_rn(v[0] - hf.x, v[1] - hf.y);
        }
      }
    }
  };

  if (P::DB) {
    hop::mbar_wait(&full[0], 0);
    load_frags(0, 0, fa);
  }
  if constexpr (N == 128) {
    if (rows <= 64)
      row_tile(std::integral_constant<int, 64>{});
    else
      row_tile(std::integral_constant<int, 128>{});
  } else if constexpr (N > 8) {
    if (rows <= 8)
      row_tile(std::integral_constant<int, 8>{});
    else
      row_tile(std::integral_constant<int, N>{});
  } else {
    row_tile(std::integral_constant<int, N>{});
  }
}

// int8 [outer][mid][inner] read in boxes of {64, 64, 1} (a weight tile)
// with the 64-byte swizzle.
cudaError_t map_q8(CUtensorMap* m, const void* base, int inner, int mid,
                   int outer) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(mid),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner),
                                 static_cast<cuuint64_t>(inner) * mid};
  const cuuint32_t box[3] = {QBM, QBK, 1};
  return hop_host::tiled_map(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, 3, dims,
                             strides, box, CU_TENSOR_MAP_SWIZZLE_64B);
}

// bf16 [outer][mid][inner] read in boxes of {64, 8, 1} (8 token rows).
cudaError_t map_rows(CUtensorMap* m, const void* base, int inner, int mid,
                     int outer) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(mid),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * 2,
                                 static_cast<cuuint64_t>(inner) * mid * 2};
  const cuuint32_t box[3] = {QBK, QROWS, 1};
  return hop_host::bf16_map(m, base, 3, dims, strides, box);
}

template <int N, int EPI>
cudaError_t launch_q8_pass(const CUtensorMap& ma0, const CUtensorMap& ma1,
                           const CUtensorMap& mb0, const CUtensorMap& mb1,
                           const float* s0, const float* s1,
                           const int* counts, const int* expert_ids,
                           __nv_bfloat16* out, long plane, int U, int C,
                           int K, int M, cudaStream_t stream) {
  static bool smem_set = false;
  auto kern = ffn_q8_wgmma<N, EPI>;
  constexpr int smem = QPlan<N, EPI>::SMEM;
  cudaError_t err = hop_host::allow_smem(kern, smem, smem_set);
  if (err != cudaSuccess) return err;
  // the feature tiles of row tile 0, then of row tile 1, ... (one at a
  // span): a tile past every slot's count exits at once
  dim3 grid((M + QBM - 1) / QBM * ((C + N - 1) / N), U);
  kern<<<grid, QTHREADS, smem, stream>>>(ma0, ma1, mb0, mb1, s0, s1, counts,
                                         expert_ids, out, plane, C, K, M);
  return cudaGetLastError();
}

template <int N>
int launch_wgmma(const void* x, const int8_t* wg, const int8_t* wu,
                 const int8_t* wd, const float* sg, const float* su,
                 const float* sd, const int* counts, const int* expert_ids,
                 void* h, void* y, int U, int C, int d, int F, int E,
                 bool swiglu, cudaStream_t stream) {
  auto hp = static_cast<__nv_bfloat16*>(h);
  const long plane = static_cast<long>(U) * C * F;  // h's lo plane
  CUtensorMap mx, mg, mu, md, mhi, mlo;
  cudaError_t err = map_rows(&mx, x, d, C, U);
  if (err == cudaSuccess && swiglu) err = map_q8(&mg, wg, F, d, E);
  if (err == cudaSuccess) err = map_q8(&mu, wu, F, d, E);
  if (err == cudaSuccess) err = map_q8(&md, wd, d, F, E);
  if (err == cudaSuccess) err = map_rows(&mhi, hp, F, C, U);
  if (err == cudaSuccess) err = map_rows(&mlo, hp + plane, F, C, U);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = swiglu ? launch_q8_pass<N, Q_SWIGLU>(mg, mu, mx, mx, sg, su, counts,
                                             expert_ids, hp, plane, U, C, d,
                                             F, stream)
               : launch_q8_pass<N, Q_GELU>(mu, mu, mx, mx, su, su, counts,
                                           expert_ids, hp, plane, U, C, d, F,
                                           stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_q8_pass<N, Q_DOWN>(
      md, md, mhi, mlo, sd, sd, counts, expert_ids,
      static_cast<__nv_bfloat16*>(y), 0, U, C, F, d, stream));
}

}  // namespace

// x [U,C,d]; wg/wu int8 [E,d,F]; wd int8 [E,F,d]; sg/su/sd f32 [E];
// counts [U] i32; expert_ids [U] i32 or null (then E == U and slot u uses
// expert u); h [U,C,F] f32 scratch on the simt route, the bf16 planes
// [2,U,C,F] (hi, lo: the same bytes) on the wgmma route; y [U,C,d]. d and
// F multiples of 16; x and y share one dtype; all 16-byte aligned. wg and
// sg are ignored (may be null) when swiglu == 0. *route says which route
// ran. Returns a cudaError_t code (0 = launched).
extern "C" int moe_gmm_fused_quant(const void* x, const int8_t* wg,
                                   const int8_t* wu, const int8_t* wd,
                                   const float* sg, const float* su,
                                   const float* sd, const int* counts,
                                   const int* expert_ids, void* h, void* y,
                                   int U, int C, int d, int F, int E,
                                   int swiglu, int dtype, void* stream,
                                   int* route) {
  if (U <= 0 || C <= 0 || d <= 0 || F <= 0 || E <= 0 || d % VEC || F % VEC ||
      U > 65535 || (F + 127) / 128 > 65535 || (d + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == RT_BF16 && C > 1) {
    *route = RT_ROUTE_WGMMA;
#define RT_MOE_QW(NN)                                                        \
  return launch_wgmma<NN>(x, wg, wu, wd, sg, su, sd, counts, expert_ids, h,  \
                          y, U, C, d, F, E, swiglu != 0, st)
    if (C <= 8) RT_MOE_QW(8);
    if (C <= 16) RT_MOE_QW(16);
    if (C <= 32) RT_MOE_QW(32);
    RT_MOE_QW(128);
#undef RT_MOE_QW
  }
  *route = RT_ROUTE_SIMT;
  float* hf = static_cast<float*>(h);
  // one row (a decode token), a verification span, or a prefill block
#define RT_MOE_Q(TT, BCC)                                                   \
  return launch<TT, BCC>(x, wg, wu, wd, sg, su, sd, counts, expert_ids, hf, \
                         y, U, C, d, F, swiglu != 0, st)
  if (dtype == RT_BF16 && C == 1) RT_MOE_Q(__nv_bfloat16, 1);
  if (dtype == RT_F32 && C == 1) RT_MOE_Q(float, 1);
  if (dtype == RT_F32 && C <= 32) RT_MOE_Q(float, 4);
  if (dtype == RT_F32) RT_MOE_Q(float, 8);
#undef RT_MOE_Q
  return static_cast<int>(cudaErrorInvalidValue);
}
