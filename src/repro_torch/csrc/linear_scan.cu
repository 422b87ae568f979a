// The RG-LRU's linear recurrence, elementwise per (batch row b, channel d):
//     h_t = a_t * h_{t-1} + x_t,    y_t = h_t,
// from h_0 = h0[b], in float32, for any T >= 1 and any D >= 1. Each step
// rounds the product and the sum separately (no fused multiply-add), as
// the serial float32 loop of the plain version does, so a call that runs
// in one chunk (T <= TC: every verification span) gives its results bit
// for bit.
//
// Replaces: src/repro/kernels/linear_scan/kernel.py, `linear_scan` (the
// Pallas TPU kernel: grid (B, D/bd, T/bt) with the T axis run in order,
// the running state carried in VMEM scratch from one T block to the next,
// and a log-depth associative scan inside a block; it needs T % bt == 0
// and D % bd == 0).
//
// What bounds it on the card: bytes. a and x are read once and y written
// once, 12 bytes per (row, token, channel), against 2 float32 operations:
// far below the card's operations-per-byte balance point. The dependence
// through h is the other limit: two dependent operations (~8 cycles) per
// token of a channel, so a short T over few channels is latency-bound.
//
// Design: the card runs blocks in no order, so the TPU kernel's carry from
// one T block to the next is made explicit, by reduce-then-scan over
// chunks of TC tokens:
//   1. `chunk_reduce`: one thread per (row, chunk, channel), for every
//      chunk but the last, folds the chunk's tokens into its transfer:
//      A = prod a_t and H = the state at the chunk's end from h = 0;
//   2. `chunk_carry`: one thread per (row, channel) walks the chunks in
//      order, h <- A*h + H, leaving each chunk's incoming state in place of
//      its H;
//   3. `chunk_scan`: one thread per (row, chunk, channel) runs the chunk's
//      recurrence from its incoming state, writes y, and the last chunk's
//      thread writes h_last.
// a and x are read twice (steps 1 and 3) and y written once, 20 bytes per
// element against the bound's 12; in exchange ceil(T/TC)*B*D threads share
// the work instead of B*D (at a 3000-token prefill over d_rnn = 4096: 192 k
// threads instead of 4096, one warp per SM). When T <= TC only step 3 runs,
// from h0. Neighbouring threads take neighbouring channels, so a warp's
// load of one token is 128 contiguous bytes, and each thread loads U
// tokens of a and x ahead of the steps that consume them: 2*U loads in
// flight per thread.
#include "common.cuh"

namespace {

constexpr int TC = 64;        // tokens per chunk
constexpr int U = 8;          // tokens loaded ahead
constexpr int THREADS = 128;  // channels per CTA

__device__ __forceinline__ float step(float a, float h, float x) {
  return __fadd_rn(__fmul_rn(a, h), x);
}

// Fold n tokens of one channel (element i of token t at off + t * D) into
// h; with kWriteY, write each state to y. a_prod accumulates prod a_t.
template <bool kWriteY>
__device__ __forceinline__ float fold(const float* __restrict__ a,
                                      const float* __restrict__ x,
                                      float* __restrict__ y, size_t off,
                                      int D, int n, float h, float& a_prod) {
  for (int t0 = 0; t0 < n; t0 += U) {
    float av[U], xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t i = off + static_cast<size_t>(t0 + u) * D;
      // past the end: a = 1, x = 0 leave h and a_prod exactly as they are
      av[u] = t0 + u < n ? __ldg(a + i) : 1.f;
      xv[u] = t0 + u < n ? __ldg(x + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = step(av[u], h, xv[u]);
      a_prod = __fmul_rn(a_prod, av[u]);
      if (kWriteY && t0 + u < n) y[off + static_cast<size_t>(t0 + u) * D] = h;
    }
  }
  return h;
}

// grid (ceil(D/THREADS), nchunk - 1, B): the transfer (A, H) of every chunk
// but the last, into ta, th [B, nchunk-1 (ta) or nchunk (th), D].
__global__ void __launch_bounds__(THREADS)
    chunk_reduce(const float* __restrict__ a, const float* __restrict__ x,
                 float* __restrict__ ta, float* __restrict__ th, int T,
                 int D, int nchunk) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  if (d >= D) return;
  const int c = blockIdx.y, b = blockIdx.z;
  const size_t off = (static_cast<size_t>(b) * T + c * TC) * D + d;
  float a_prod = 1.f;
  const float h = fold<false>(a, x, nullptr, off, D, TC, 0.f, a_prod);
  ta[(static_cast<size_t>(b) * (nchunk - 1) + c) * D + d] = a_prod;
  th[(static_cast<size_t>(b) * nchunk + c) * D + d] = h;
}

// grid (ceil(D/THREADS), B): each chunk's incoming state into th.
__global__ void __launch_bounds__(THREADS)
    chunk_carry(const float* __restrict__ h0, const float* __restrict__ ta,
                float* __restrict__ th, int D, int nchunk) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  if (d >= D) return;
  const size_t b = blockIdx.y;
  float h = h0[b * D + d];
#pragma unroll 4
  for (int c = 0; c < nchunk - 1; ++c) {
    const size_t s = (b * nchunk + c) * D + d;
    const float H = th[s];
    const float A = ta[(b * (nchunk - 1) + c) * D + d];
    th[s] = h;
    h = step(A, h, H);
  }
  th[(b * nchunk + nchunk - 1) * D + d] = h;
}

// grid (ceil(D/THREADS), nchunk, B): y from each chunk's incoming state
// h_in [B, nchunk, D] (h0 itself when nchunk == 1), and h_last.
__global__ void __launch_bounds__(THREADS)
    chunk_scan(const float* __restrict__ a, const float* __restrict__ x,
               const float* __restrict__ h_in, float* __restrict__ y,
               float* __restrict__ h_last, int T, int D) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  if (d >= D) return;
  const int c = blockIdx.y, b = blockIdx.z, nchunk = gridDim.y;
  const int n = min(TC, T - c * TC);
  const size_t off = (static_cast<size_t>(b) * T + c * TC) * D + d;
  const size_t s = (static_cast<size_t>(b) * nchunk + c) * D + d;
  float a_prod = 1.f;
  const float h = fold<true>(a, x, y, off, D, n, h_in[s], a_prod);
  if (c == nchunk - 1) h_last[static_cast<size_t>(b) * D + d] = h;
}

}  // namespace

// Chunks of a T-token call: the wrapper's scratch is ta [B, nchunk-1, D]
// and th [B, nchunk, D] float32 when nchunk > 1 (none otherwise).
extern "C" int linear_scan_chunks(int T) { return (T + TC - 1) / TC; }

// a, x, y [B,T,D]; h0, h_last [B,D]; all float32 and contiguous. ta, th:
// the scratch of `linear_scan_chunks(T)` chunks, or null for one chunk.
// Returns a cudaError_t code (0 = launched).
extern "C" int linear_scan_f32(const float* a, const float* x,
                               const float* h0, float* y, float* h_last,
                               float* ta, float* th, int B, int T, int D,
                               void* stream) {
  const int nchunk = linear_scan_chunks(T);
  if (B <= 0 || T <= 0 || D <= 0 || B > 65535 || nchunk > 65535 ||
      (nchunk > 1 && (ta == nullptr || th == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dblocks = (D + THREADS - 1) / THREADS;
  const float* h_in = h0;
  if (nchunk > 1) {
    chunk_reduce<<<dim3(dblocks, nchunk - 1, B), THREADS, 0, st>>>(
        a, x, ta, th, T, D, nchunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    chunk_carry<<<dim3(dblocks, B), THREADS, 0, st>>>(h0, ta, th, D, nchunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    h_in = th;
  }
  chunk_scan<<<dim3(dblocks, nchunk, B), THREADS, 0, st>>>(a, x, h_in, y,
                                                           h_last, T, D);
  return static_cast<int>(cudaGetLastError());
}
