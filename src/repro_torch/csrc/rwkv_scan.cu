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
// The arithmetic, ~5*N*N float32 operations per (token, b, h), is far below
// the card's operations-per-byte balance point. At prefill the serial loop
// over T makes it latency-bound instead.
//
// Design: the columns of S are independent (column v evolves from k, w and
// v_t[v] alone, and y_t[v] reads only that column), so one CTA takes a block
// of CB = 16 columns of one (b, h): N/16 CTAs per head, 160 at B = 1 on
// RWKV-6-3B's 40 heads. Four threads share a column, each holding N/4 of its
// rows in registers (rows ks, ks+4, ..., so the four read distinct banks of
// the staged rows); the dot product for y_t[v] is reduced over the four by
// two warp shuffles. r, k, w (whole rows) and the CTA's slice of v are
// staged in shared memory TC = 16 tokens at a time with cp.async, the next
// chunk's copy in flight while the current one is computed. A warp's store
// of a staged state covers 4 rows x 8 adjacent columns, 4 full 32-byte
// sectors. Slot 0 of the staged states is written from the registers the
// initial state was loaded into, so it is a copy of s0 as it was.
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

}  // namespace

// r, k, v, w, y [B,T,H,N]; u [H,N]; s0, s_last [B,H,N,N]; states, when not
// null, [T+1,B,H,N,N]; all float32, contiguous, 16-byte aligned. N is 32 or
// 64. Returns a cudaError_t code (0 = launched).
extern "C" int rwkv_scan_f32(const float* r, const float* k, const float* v,
                             const float* w, const float* u, const float* s0,
                             float* y, float* s_last, float* states, int B,
                             int T, int H, int N, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 64)
    return launch<64>(r, k, v, w, u, s0, y, s_last, states, B, T, H, st);
  if (N == 32)
    return launch<32>(r, k, v, w, u, s0, y, s_last, states, B, T, H, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
