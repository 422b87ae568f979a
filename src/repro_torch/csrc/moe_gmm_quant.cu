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
// [1+4] pass (8 live experts) moves 1.41 GB per layer, 0.42 ms at
// 3.35 TB/s; a one-token pass (2 live) 0.35 GB, 0.105 ms.
//
// Design: K1's two deterministic passes (csrc/moe_gmm.cu), with the weight
// side rebuilt for one byte per element.
//   1. gate/up: a CTA per (block of BC rows, 128 F columns, slot) computes
//      h = silu(sg*(x @ wg)) * (su*(x @ wu)) (or gelu_tanh(su*(x @ wu)))
//      into a float32 scratch [U,C,F].
//   2. down: a CTA per (block of rows, 64 d columns, slot) computes
//      y = sd*(h @ wd) and writes it in the input type.
// Each thread loads 16 int8 weights of one row of W at a time (one 16-byte
// load: 8 or 4 lanes cover a row segment of 128 or 64 bytes, the other
// lanes of the warp take the next rows of the contraction) and converts
// them in registers with integer byte permutes and one float subtract (no
// int-to-float conversion unit): 2^23 + (q + 128) is built as a bit
// pattern, so subtracting 2^23 + 128 gives q exactly. The activations are
// staged in shared memory as float32, [k][row], so one vector load gives a
// thread every row of its step. Each slot's scale multiplies the finished
// float32 dot product once, never the weights. A chunk's first weights are
// loaded before the barriers that stage its activations, so their latency
// overlaps them; 1- and 4-row blocks are held to 128 registers, so two CTAs
// share an SM and keep twice the loads in flight.
// Partial sums over the contraction are reduced by warp shuffles and then
// through shared memory, both in a fixed order: no atomics, so a slot
// gives the same bits whatever layout (dense or packed) holds it. The row
// block is the fastest grid index, so the CTAs of one weight tile run
// together and a second row block finds the tile in L2. A CTA whose rows
// start at or past its slot's count loads nothing.
#include "common.cuh"

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

}  // namespace

// x [U,C,d]; wg/wu int8 [E,d,F]; wd int8 [E,F,d]; sg/su/sd f32 [E];
// counts [U] i32; expert_ids [U] i32 or null (then E == U and slot u uses
// expert u); h [U,C,F] f32 scratch; y [U,C,d]. d and F multiples of 16;
// x and y share one dtype. wg and sg are ignored (may be null) when
// swiglu == 0. Returns a cudaError_t code (0 = launched).
extern "C" int moe_gmm_fused_quant(const void* x, const int8_t* wg,
                                   const int8_t* wu, const int8_t* wd,
                                   const float* sg, const float* su,
                                   const float* sd, const int* counts,
                                   const int* expert_ids, float* h, void* y,
                                   int U, int C, int d, int F, int swiglu,
                                   int dtype, void* stream) {
  if (U <= 0 || C <= 0 || d <= 0 || F <= 0 || d % VEC || F % VEC ||
      U > 65535 || (F + 127) / 128 > 65535 || (d + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // one row (a decode token), a verification span, or a prefill block
#define RT_MOE_Q(TT, BCC)                                                   \
  return launch<TT, BCC>(x, wg, wu, wd, sg, su, sd, counts, expert_ids, h, \
                         y, U, C, d, F, swiglu != 0, st)
  if (dtype == RT_BF16 && C == 1) RT_MOE_Q(__nv_bfloat16, 1);
  if (dtype == RT_BF16 && C <= 32) RT_MOE_Q(__nv_bfloat16, 4);
  if (dtype == RT_BF16) RT_MOE_Q(__nv_bfloat16, 8);
  if (dtype == RT_F32 && C == 1) RT_MOE_Q(float, 1);
  if (dtype == RT_F32 && C <= 32) RT_MOE_Q(float, 4);
  if (dtype == RT_F32) RT_MOE_Q(float, 8);
#undef RT_MOE_Q
  return static_cast<int>(cudaErrorInvalidValue);
}
