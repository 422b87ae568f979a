// The RWKV-6 WKV recurrence, per (batch row b, head h) with an N x N float32
// state S indexed [k, v]:
//     y_t[v] = sum_k r_t[k] * (S[k,v] + u[k] * k_t[k] * v_t[v])
//     S[k,v] <- w_t[k] * S[k,v] + k_t[k] * v_t[v]
// optionally writing the state after every token (the staged states that
// speculative rollback selects from).
//
// Replaces: src/repro/kernels/rwkv_scan/kernel.py, `rwkv_scan` (the Pallas
// TPU kernel: grid (B, H, T/bt) with T sequential, the whole N x N state
// resident in VMEM, bt a divisor of T). This kernel also writes the staged
// states the model path's verification passes need (the TPU kernel has no
// such output; the JAX model path stages them with `wkv_scan`), and takes
// any T >= 1: spans are 1+K tokens and chunks any power of two.
//
// What bounds it on the card: bytes. r, k, v, w are read once and y written
// once (20 bytes per (token, head, channel)), the state read and written
// once per (b, h), and with staged states 4*N*N bytes per (token, b, h):
// at N = 64 the staged states are most of the bytes of a verification pass.
// The arithmetic, ~5*N*N float32 operations per (token, b, h), is below
// the card's operations-per-byte balance point. A walk over T in series is
// latency-bound instead: at a 512-token prefill one CTA per 16 columns of
// a head gives 160 CTAs, 2.4 warps an SM, for 512 steps.
//
// Two routes, chosen by the wrapper (kernels/rwkv_scan/ops.py: `route`):
//
// "serial", for every call that stages states and every call of at most
// CL tokens (the verification spans, the batched engine's chunk passes):
// the columns of S are independent (column v evolves from k, w and v_t[v]
// alone, and y_t[v] reads only that column), so one CTA takes a block of
// CB = 16 columns of one (b, h): N/16 CTAs per head. Four threads share a
// column, each holding N/4 of its rows in registers (rows ks, ks+4, ...,
// so the four read distinct banks of the staged rows); the dot product
// for y_t[v] is reduced over the four by two warp shuffles. r, k, w
// (whole rows) and the CTA's slice of v are staged in shared memory
// TC = 16 tokens at a time with cp.async, the next chunk's copy in flight
// while the current one is computed. A warp's store of a staged state
// covers 4 rows x 8 adjacent columns, 4 full 32-byte sectors. Slot 0 of
// the staged states is written from the registers the initial state was
// loaded into, so it is a copy of s0 as it was.
//
// "chunked", for a call of more than CL tokens that stages nothing (the
// prefill): T is cut into chunks of CL = 32 tokens and the state passed
// from chunk to chunk, exact algebra in float32 with no division by a
// decay. With D_t[k] = prod of w_s[k] over the chunk's tokens s before t,
// and S_in the state entering the chunk,
//     y_t = y_local_t + (r_t * D_t)^T S_in,
// where y_local is the chunk's own recurrence run from a zero state. Three
// kernels:
//   1. `wkv_chunk_local`, one CTA of N threads per (b, h, chunk): the
//      recurrence from zero over the chunk's tokens, their copies in four
//      groups of 8 tokens so it starts on the first group. It writes
//      y_local into y, the chunk's end state S_local and its decay
//      W_c = D_CL into the scratch. A thread holds N/4 adjacent rows x 4
//      adjacent columns of S, so one 16-byte shared load of r, k or w
//      serves 4 rows x 4 columns: three float32 operations per state
//      element and token (k*v, the decayed update, the product for y)
//      against ~13 shared loads per 3*N*4 operations. The u term is the
//      scalar c_t = sum_k r u k (per token, computed once per CTA for each
//      group) times v_t[v]. The four threads of a column block reduce
//      their partial sums for y by a reduce-scatter of 3 shuffles, each
//      left with one column.
//   2. `wkv_chunk_carry`, one thread per (b, h, k, v): the walk over the
//      chunks, S_in(c+1) = W_c * S_in(c) + S_local(c) from s0, writing
//      each S_in(c) in place of S_local(c), and s_last.
//   3. `wkv_chunk_out`, one CTA per (b, h, chunk): q_t = r_t * D_t, then
//      Q S_in, a [CL x N] x [N x N] float32 product on the CUDA cores,
//      each thread 4 tokens x 4 columns, added to y_local by one vector
//      reduction (red.add.v4) a thread a token: exactly one addition per
//      element, so the result does not depend on timing.
// The serial depth falls from T to CL + T/CL; the CTAs of step 1 multiply
// by T/CL (640 at a 512-token prefill over 40 heads, 4.8 an SM, one wave).
// The price is the scratch, N*N + N floats per (b, h, chunk), written by
// step 1, read and rewritten by step 2 and read by step 3 (42 MB at that
// prefill, mostly in L2), and y written by step 1 and added to by step 3.
// CL trades the two: on the card CL = 64 (with eight row groups, to keep
// step 1's warps) halved the scratch but cost step 1 more than it saved.
// At that prefill step 1 is bound by instruction issue (1280 warps on the
// card's 528 schedulers); PERF.md has each step's time.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int CB = 16;              // state columns per CTA
constexpr int KS = 4;               // threads per column
constexpr int THREADS = CB * KS;    // 64
constexpr int TC = 16;              // tokens per staged chunk

template <int N>
struct Stage {
  __align__(16) float r[2][TC][N];
  __align__(16) float k[2][TC][N];
  __align__(16) float w[2][TC][N];
  __align__(16) float v[2][TC][CB];
  float u[N];
};

// Copy tokens [t0, t0 + ntok) of this (b, h) into buffer `buf`: whole rows of
// r, k, w and the CTA's CB columns of v, in 16-byte pieces.
template <int N>
__device__ __forceinline__ void stage_chunk(Stage<N>& sm, int buf,
                                            const float* r, const float* k,
                                            const float* v, const float* w,
                                            size_t row0, size_t tstride,
                                            int ntok, int v0, int tid) {
  constexpr int P = N / 4;
  for (int i = tid; i < ntok * P; i += THREADS) {
    const int tt = i / P, p = (i % P) * 4;
    const size_t off = row0 + tt * tstride + p;
    __pipeline_memcpy_async(&sm.r[buf][tt][p], r + off, 16);
    __pipeline_memcpy_async(&sm.k[buf][tt][p], k + off, 16);
    __pipeline_memcpy_async(&sm.w[buf][tt][p], w + off, 16);
  }
  constexpr int PV = CB / 4;
  for (int i = tid; i < ntok * PV; i += THREADS) {
    const int tt = i / PV, p = (i % PV) * 4;
    __pipeline_memcpy_async(&sm.v[buf][tt][p], v + row0 + tt * tstride + v0 + p,
                            16);
  }
  __pipeline_commit();
}

template <int N>
__global__ void __launch_bounds__(THREADS)
    wkv_scan(const float* __restrict__ r, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ s0,
             float* __restrict__ y, float* __restrict__ s_last,
             float* __restrict__ states, int B, int T, int H) {
  constexpr int KR = N / KS;  // state rows per thread
  __shared__ Stage<N> sm;
  const int tid = threadIdx.x;
  const int c = tid / KS, ks = tid % KS;
  const int v0 = blockIdx.x * CB, col = v0 + c;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t tstride = static_cast<size_t>(H) * N;       // token to token
  const size_t seq0 = (static_cast<size_t>(b) * T * H + h) * N;  // (b,0,h,0)
  const size_t plane = static_cast<size_t>(B) * H * N * N;  // one staged slot
  const size_t st0 = bh * N * N + col;                     // (b,h,0,col)

  const int nchunk = (T + TC - 1) / TC;
  stage_chunk<N>(sm, 0, r, k, v, w, seq0, tstride, min(TC, T), v0, tid);
  if (tid < N) sm.u[tid] = u[static_cast<size_t>(h) * N + tid];

  float S[KR];
#pragma unroll
  for (int i = 0; i < KR; ++i) S[i] = s0[st0 + (i * KS + ks) * N];
  if (states != nullptr) {
#pragma unroll
    for (int i = 0; i < KR; ++i) states[st0 + (i * KS + ks) * N] = S[i];
  }

  for (int ch = 0; ch < nchunk; ++ch) {
    const int buf = ch & 1;
    const int t0 = ch * TC;
    const int ntok = min(TC, T - t0);
    if (ch + 1 < nchunk) {
      // the buffer refilled here was last read in chunk ch-1, whose closing
      // barrier every thread has passed
      stage_chunk<N>(sm, buf ^ 1, r, k, v, w, seq0 + (t0 + TC) * tstride,
                     tstride, min(TC, T - t0 - TC), v0, tid);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    for (int tt = 0; tt < ntok; ++tt) {
      const float vv = sm.v[buf][tt][c];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        const int kk = i * KS + ks;
        const float kv = sm.k[buf][tt][kk] * vv;
        acc = fmaf(sm.r[buf][tt][kk], fmaf(sm.u[kk], kv, S[i]), acc);
        S[i] = fmaf(sm.w[buf][tt][kk], S[i], kv);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      const size_t t = static_cast<size_t>(t0 + tt);
      if (ks == 0) y[seq0 + t * tstride + col] = acc;
      if (states != nullptr) {
        float* st = states + (t + 1) * plane + st0;
#pragma unroll
        for (int i = 0; i < KR; ++i) st[(i * KS + ks) * N] = S[i];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < KR; ++i) s_last[st0 + (i * KS + ks) * N] = S[i];
}

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* s_last,
           float* states, int B, int T, int H, cudaStream_t stream) {
  dim3 grid(N / CB, H, B);
  wkv_scan<N><<<grid, THREADS, 0, stream>>>(r, k, v, w, u, s0, y, s_last,
                                           states, B, T, H);
  return static_cast<int>(cudaGetLastError());
}

// ---- the chunked route ----------------------------------------------------

constexpr int CL = 32;               // tokens per chunk (ops.py: CHUNK)
constexpr int CARRY_THREADS = 256;   // step 2: one thread per state element
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Step 1's shared memory: the chunk's r, k, w as padded row vectors (the
// rows [ks*R, ks*R + R) of thread group ks start at ks*RS, so the four
// groups' 16-byte loads in a warp fall in distinct banks), v as it is, and
// c_t = sum_k r_t[k] u[k] k_t[k] per token.
template <int N>
struct Local {
  static constexpr int R = N / 4;                      // rows a thread holds
  static constexpr int RS = R % 32 == 16 ? R + 4 : R;  // padded group stride
  __align__(16) float r[CL][4 * RS];
  __align__(16) float k[CL][4 * RS];
  __align__(16) float w[CL][4 * RS];
  __align__(16) float v[CL][N];
  float c[CL];
  static __device__ __forceinline__ int at(int row) {
    return (row / R) * RS + row % R;
  }
};

// One row of a thread's 4 columns for one token: y's partial sums read the
// state before the token, then the decayed rank-1 update.
__device__ __forceinline__ void row_step(float (&s)[4], float r, float k,
                                         float w, float4 v, float (&a)[4]) {
  a[0] = fmaf(r, s[0], a[0]);
  a[1] = fmaf(r, s[1], a[1]);
  a[2] = fmaf(r, s[2], a[2]);
  a[3] = fmaf(r, s[3], a[3]);
  s[0] = fmaf(w, s[0], k * v.x);
  s[1] = fmaf(w, s[1], k * v.y);
  s[2] = fmaf(w, s[2], k * v.z);
  s[3] = fmaf(w, s[3], k * v.w);
}

// Step 1, grid (nchunk, H, B), N threads: thread (cg, ks) = (tid / 4,
// tid % 4) holds rows [ks*R, ks*R + R) x columns [4cg, 4cg + 4) of the
// chunk's state, run from zero. Writes y_local into y, S_local and W_c
// into the scratch.
template <int N>
__global__ void __launch_bounds__(N)
    wkv_chunk_local(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u, float* __restrict__ y,
                    float* __restrict__ sstate, float* __restrict__ sdecay,
                    int T, int H, int nchunk) {
  using Sm = Local<N>;
  constexpr int R = Sm::R, RS = Sm::RS, P = N / 4;
  constexpr int G = 4, TG = CL / G;  // copy groups, tokens a group
  static_assert(N % TG == 0 && G == 4, "N is 32 or 64");
  __shared__ Sm sm;
  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * CL, ntok = min(CL, T - t0);
  const size_t tstride = static_cast<size_t>(H) * N;
  const size_t base = ((static_cast<size_t>(b) * T + t0) * H + h) * N;
  const size_t bhc = (static_cast<size_t>(b) * H + h) * nchunk + c;

  // the chunk's tokens in G groups of TG, each group's copies committed
  // on its own, so the recurrence starts once the first group has landed
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int lo = g * TG, hi = min(ntok, lo + TG);
    for (int i = lo * P + tid; i < hi * P; i += N) {
      const int tt = i / P, p = 4 * (i % P), q = Sm::at(p);
      const size_t off = base + tt * tstride + p;
      __pipeline_memcpy_async(&sm.r[tt][q], r + off, 16);
      __pipeline_memcpy_async(&sm.k[tt][q], k + off, 16);
      __pipeline_memcpy_async(&sm.w[tt][q], w + off, 16);
      __pipeline_memcpy_async(&sm.v[tt][p], v + off, 16);
    }
    __pipeline_commit();
  }

  // c_t: TPT adjacent lanes per token, KPT adjacent rows each (within one
  // row group, so at padded positions c_q0 ..)
  constexpr int TPT = N / TG, KPT = N / TPT;
  static_assert(KPT == 8 && R % KPT == 0, "N is 32 or 64");
  const int c_k0 = (tid % TPT) * KPT, c_q0 = Sm::at(c_k0);
  float uk[KPT];
#pragma unroll
  for (int j = 0; j < KPT; ++j) uk[j] = __ldg(u + h * N + c_k0 + j);

  const int ks = tid & 3, col0 = (tid >> 2) * 4, rq = ks * RS;
  const bool hi2 = ks & 2, hi1 = ks & 1;
  float S[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i) S[i][0] = S[i][1] = S[i][2] = S[i][3] = 0.f;
  float* yt = y + base + col0 + ks;  // y_t[col0 + ks], advanced a token a step
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int lo = g * TG, hi = min(ntok, lo + TG);
    if (lo >= ntok) break;
    switch (g) {  // the wait's count must be a constant
      case 0: __pipeline_wait_prior(G - 1); break;
      case 1: __pipeline_wait_prior(G - 2); break;
      case 2: __pipeline_wait_prior(G - 3); break;
      default: __pipeline_wait_prior(0); break;
    }
    __syncthreads();
    {
      const int tt = lo + tid / TPT;
      float acc = 0.f;
      if (tt < hi) {
#pragma unroll
        for (int j = 0; j < KPT; j += 4) {
          const float4 rr = ld4(&sm.r[tt][c_q0 + j]);
          const float4 kk = ld4(&sm.k[tt][c_q0 + j]);
          acc = fmaf(rr.x * uk[j], kk.x, acc);
          acc = fmaf(rr.y * uk[j + 1], kk.y, acc);
          acc = fmaf(rr.z * uk[j + 2], kk.z, acc);
          acc = fmaf(rr.w * uk[j + 3], kk.w, acc);
        }
      }
#pragma unroll
      for (int o = 1; o < TPT; o <<= 1) acc += __shfl_xor_sync(FULL, acc, o);
      if (tt < hi && tid % TPT == 0) sm.c[tt] = acc;
    }
    __syncthreads();
    for (int tt = lo; tt < hi; ++tt) {
      const float4 vv = ld4(&sm.v[tt][col0]);
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < R; i += 4) {
        const float4 rr = ld4(&sm.r[tt][rq + i]);
        const float4 kk = ld4(&sm.k[tt][rq + i]);
        const float4 ww = ld4(&sm.w[tt][rq + i]);
        row_step(S[i], rr.x, kk.x, ww.x, vv, a);
        row_step(S[i + 1], rr.y, kk.y, ww.y, vv, a);
        row_step(S[i + 2], rr.z, kk.z, ww.z, vv, a);
        row_step(S[i + 3], rr.w, kk.w, ww.w, vv, a);
      }
      // reduce-scatter over the four row groups: lane ks ends with column
      // col0 + ks summed over all N rows
      float p0 = hi2 ? a[2] : a[0], p1 = hi2 ? a[3] : a[1];
      p0 += __shfl_xor_sync(FULL, hi2 ? a[0] : a[2], 2);
      p1 += __shfl_xor_sync(FULL, hi2 ? a[1] : a[3], 2);
      float sum = hi1 ? p1 : p0;
      sum += __shfl_xor_sync(FULL, hi1 ? p0 : p1, 1);
      const float vc = ks == 0 ? vv.x : ks == 1 ? vv.y : ks == 2 ? vv.z
                                                                 : vv.w;
      *yt = fmaf(sm.c[tt], vc, sum);
      yt += tstride;
    }
  }
  {
    // W_c, one thread per row, once every token has landed
    const int q = Sm::at(tid);
    float dec = 1.f;
    for (int t = 0; t < ntok; ++t) dec *= sm.w[t][q];
    sdecay[bhc * N + tid] = dec;
  }
  float* st = sstate + bhc * N * N + col0;
#pragma unroll
  for (int i = 0; i < R; ++i)
    *reinterpret_cast<float4*>(st + (ks * R + i) * N) =
        make_float4(S[i][0], S[i][1], S[i][2], S[i][3]);
}

// Step 2, grid (N*N / CARRY_THREADS, H, B): element e = k*N + v of each
// chunk's state, S_in(c+1) = W_c[k] * S_in(c) + S_local(c) from s0, S_in(c)
// written over S_local(c); the loads of 8 chunks issued ahead of their use.
template <int N>
__global__ void __launch_bounds__(CARRY_THREADS)
    wkv_chunk_carry(const float* __restrict__ s0, float* __restrict__ s_last,
                    float* __restrict__ sstate,
                    const float* __restrict__ sdecay, int H, int nchunk) {
  constexpr int NN = N * N, U = 8;
  const int e = blockIdx.x * CARRY_THREADS + threadIdx.x;
  const size_t bh = static_cast<size_t>(blockIdx.z) * H + blockIdx.y;
  float* st = sstate + bh * nchunk * NN + e;
  const float* dec = sdecay + bh * nchunk * N + e / N;
  float s = s0[bh * NN + e];
  for (int c0 = 0; c0 < nchunk; c0 += U) {
    float sl[U], wc[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (c0 + j < nchunk) {
        sl[j] = st[static_cast<size_t>(c0 + j) * NN];
        wc[j] = dec[static_cast<size_t>(c0 + j) * N];
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (c0 + j < nchunk) {
        st[static_cast<size_t>(c0 + j) * NN] = s;
        s = fmaf(wc[j], s, sl[j]);
      }
    }
  }
  s_last[bh * NN + e] = s;
}

// Step 3's shared memory: S_in, the chunk's r (then q = r * D) and w.
template <int N>
struct Out {
  __align__(16) float s[N][N];
  __align__(16) float q[CL][N];
  __align__(16) float w[CL][N];
};

// Step 3, grid (nchunk, H, B), (CL/4) * (N/4) threads: thread (tg, vg)
// adds (Q S_in)[4tg.., 4vg..] to y, 4 tokens x 4 columns.
template <int N>
__global__ void __launch_bounds__(CL / 4 * N / 4)
    wkv_chunk_out(const float* __restrict__ r, const float* __restrict__ w,
                  float* __restrict__ y, const float* __restrict__ sstate,
                  int T, int H, int nchunk) {
  constexpr int THREADS = CL / 4 * N / 4, P = N / 4;
  __shared__ Out<N> sm;
  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * CL, ntok = min(CL, T - t0);
  const size_t tstride = static_cast<size_t>(H) * N;
  const size_t base = ((static_cast<size_t>(b) * T + t0) * H + h) * N;
  const float* st =
      sstate + ((static_cast<size_t>(b) * H + h) * nchunk + c) * N * N;
  // r and w first, then S_in: the decay walk overlaps S_in's copy
  for (int i = tid; i < ntok * P; i += THREADS) {
    const int tt = i / P, p = 4 * (i % P);
    const size_t off = base + tt * tstride + p;
    __pipeline_memcpy_async(&sm.q[tt][p], r + off, 16);
    __pipeline_memcpy_async(&sm.w[tt][p], w + off, 16);
  }
  __pipeline_commit();
  for (int i = tid; i < N * P; i += THREADS)
    __pipeline_memcpy_async(&sm.s[0][0] + 4 * i, st + 4 * i, 16);
  __pipeline_commit();
  __pipeline_wait_prior(1);
  __syncthreads();
  if (tid < N) {
    float d = 1.f;
    for (int tt = 0; tt < ntok; ++tt) {
      sm.q[tt][tid] *= d;
      d *= sm.w[tt][tid];
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  const int tq = (tid / P) * 4, v0 = (tid % P) * 4;
  float acc[4][4] = {};
#pragma unroll 4
  for (int kk = 0; kk < N; kk += 4) {
    float4 qa[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) qa[j] = ld4(&sm.q[tq + j][kk]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 sv = ld4(&sm.s[kk + i][v0]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float qj = i == 0 ? qa[j].x : i == 1 ? qa[j].y
                       : i == 2 ? qa[j].z : qa[j].w;
        acc[j][0] = fmaf(qj, sv.x, acc[j][0]);
        acc[j][1] = fmaf(qj, sv.y, acc[j][1]);
        acc[j][2] = fmaf(qj, sv.z, acc[j][2]);
        acc[j][3] = fmaf(qj, sv.w, acc[j][3]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (tq + j < ntok) {
      float* yp = y + base + (tq + j) * tstride + v0;
      asm volatile("red.relaxed.gpu.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
                   ::"l"(yp), "f"(acc[j][0]), "f"(acc[j][1]), "f"(acc[j][2]),
                   "f"(acc[j][3])
                   : "memory");
    }
  }
}

template <int N>
int launch_chunked(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s0, float* y,
                   float* s_last, float* scratch, int B, int T, int H,
                   cudaStream_t stream) {
  const int nchunk = (T + CL - 1) / CL;
  float* sstate = scratch;
  float* sdecay = scratch + static_cast<size_t>(B) * H * nchunk * N * N;
  wkv_chunk_local<N><<<dim3(nchunk, H, B), N, 0, stream>>>(
      r, k, v, w, u, y, sstate, sdecay, T, H, nchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_chunk_carry<N><<<dim3(N * N / CARRY_THREADS, H, B), CARRY_THREADS, 0,
                       stream>>>(s0, s_last, sstate, sdecay, H, nchunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_chunk_out<N><<<dim3(nchunk, H, B), CL / 4 * N / 4, 0, stream>>>(
      r, w, y, sstate, T, H, nchunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, w, y [B,T,H,N]; u [H,N]; s0, s_last [B,H,N,N]; all float32,
// contiguous, 16-byte aligned. N is 32 or 64. `chunk` names the route:
// 0 the serial one, with `states`, when not null, [T+1,B,H,N,N]; CL (32)
// the chunked one, for T > CL and no states, with `scratch` holding
// ceil(T/CL) * B*H*(N*N + N) floats. Returns a cudaError_t code
// (0 = launched).
extern "C" int rwkv_scan_f32(const float* r, const float* k, const float* v,
                             const float* w, const float* u, const float* s0,
                             float* y, float* s_last, float* states,
                             float* scratch, int B, int T, int H, int N,
                             int chunk, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > 65535 || B > 65535 ||
      (N != 32 && N != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunk == 0) {
    if (N == 64)
      return launch<64>(r, k, v, w, u, s0, y, s_last, states, B, T, H, st);
    return launch<32>(r, k, v, w, u, s0, y, s_last, states, B, T, H, st);
  }
  if (chunk != CL || T <= CL || states != nullptr || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 64)
    return launch_chunked<64>(r, k, v, w, u, s0, y, s_last, scratch, B, T, H,
                              st);
  return launch_chunked<32>(r, k, v, w, u, s0, y, s_last, scratch, B, T, H,
                            st);
}
