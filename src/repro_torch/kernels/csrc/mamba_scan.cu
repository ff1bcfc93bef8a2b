// Mamba-1 selective scan from a zero state for Hopper (sm_90a), fp32:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t      (per (channel, state))
//   y_t = sum_n h_t[:, n] * C_t[n]
// xs/dt (B, T, di), Bs/Cs (B, T, n), A (di, n) -> y (B, T, di), final state (B, di, n).
//
// Replaces: src/repro/kernels/mamba_scan.py `mamba_scan_pallas` (body
// `_mamba_kernel`), reached from models/hymba.py `mamba_mixer(
// use_pallas=True)` through kernels/ops.py `mamba_scan`: the SSM side of
// every Hymba layer's prefill.
//
// What bounds it on this card: each input is read once and each output
// written once (4 bytes each), against about 7 operations per (b, t,
// channel, state) element (one of them an exp): at n = 16 the bytes and
// the operations are of one order, and the published rates put the bound
// on the bytes, (2*B*T*di + 2*B*T*n + di*n + B*T*di + B*di*n) * 4 / 3.35 TB/s.
// In practice the accurate expf (no --use_fast_math: the tolerance is fp32
// 1e-4) and the serial time loop set the pace.
//
// Design: the Pallas kernel keeps the (di, n) state in VMEM across an
// ordered time grid; blocks on this card run in no order and nothing
// carries between them, so the whole time loop runs inside one block with
// the state in registers. One thread per (batch, channel, state), N lanes
// per channel (N = n, a power of two from 4 to 32), 256 threads = 256/N
// channels per block, grid (channel blocks, B). Time chunks of 32 steps of
// xs/dt (the block's channels) and of B/C are staged through shared memory
// with coalesced loads; y_t is the sum over the N lanes by warp shuffles,
// staged in shared memory and written back per chunk. Operation order as
// the Pallas kernel: dA = exp(dt*A), dBx = (dt*x)*B, h = dA*h + dBx.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int TC = 32;            // time steps per staged chunk

template <int N>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const float* __restrict__ xs, const float* __restrict__ dt,
                  const float* __restrict__ Bs, const float* __restrict__ Cs,
                  const float* __restrict__ A, float* __restrict__ y, float* __restrict__ state,
                  int T, int di) {
  constexpr int CPB = THREADS / N;  // channels per block
  __shared__ float s_x[TC][CPB];
  __shared__ float s_dt[TC][CPB];
  __shared__ float s_y[TC][CPB];
  __shared__ float s_b[TC][N];
  __shared__ float s_c[TC][N];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CPB;
  const int lc = threadIdx.x / N;   // channel within the block
  const int ln = threadIdx.x % N;   // state index
  const int c = c0 + lc;
  const bool live = c < di;
  const float a = live ? A[static_cast<int64_t>(c) * N + ln] : 0.f;
  const int64_t row0 = static_cast<int64_t>(b) * T;
  float h = 0.f;

  for (int t0 = 0; t0 < T; t0 += TC) {
    const int tn = min(TC, T - t0);
    for (int e = threadIdx.x; e < TC * CPB; e += THREADS) {
      const int tt = e / CPB, cc = e % CPB;
      const bool in = tt < tn && c0 + cc < di;
      const int64_t off = (row0 + t0 + tt) * di + c0 + cc;
      s_x[tt][cc] = in ? xs[off] : 0.f;
      s_dt[tt][cc] = in ? dt[off] : 0.f;
    }
    for (int e = threadIdx.x; e < TC * N; e += THREADS) {
      const int tt = e / N, k = e % N;
      const bool in = tt < tn;
      const int64_t off = (row0 + t0 + tt) * N + k;
      s_b[tt][k] = in ? Bs[off] : 0.f;
      s_c[tt][k] = in ? Cs[off] : 0.f;
    }
    __syncthreads();

    for (int tt = 0; tt < tn; ++tt) {
      const float dtv = s_dt[tt][lc];
      const float dA = expf(dtv * a);
      const float dBx = (dtv * s_x[tt][lc]) * s_b[tt][ln];
      h = dA * h + dBx;
      float yv = h * s_c[tt][ln];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1) yv += __shfl_xor_sync(0xffffffffu, yv, off);
      if (ln == 0) s_y[tt][lc] = yv;
    }
    __syncthreads();

    for (int e = threadIdx.x; e < TC * CPB; e += THREADS) {
      const int tt = e / CPB, cc = e % CPB;
      if (tt < tn && c0 + cc < di) y[(row0 + t0 + tt) * di + c0 + cc] = s_y[tt][cc];
    }
    __syncthreads();  // s_y and the staged chunk are free for the next chunk
  }
  if (live) state[(static_cast<int64_t>(b) * di + c) * N + ln] = h;
}

template <int N>
int launch_n(const void* xs, const void* dt, const void* Bs, const void* Cs, const void* A,
             void* y, void* state, int B, int T, int di, cudaStream_t stream) {
  constexpr int CPB = THREADS / N;
  const dim3 grid((di + CPB - 1) / CPB, B);
  mamba_scan_kernel<N><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(xs), static_cast<const float*>(dt),
      static_cast<const float*>(Bs), static_cast<const float*>(Cs),
      static_cast<const float*>(A), static_cast<float*>(y), static_cast<float*>(state), T, di);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (bound with ctypes). All arrays contiguous fp32; n is 4, 8,
// 16 or 32 and B at most 65535 (the wrapper checks both). Returns
// cudaGetLastError() right after the launch; 0 means it was accepted.
extern "C" int mapple_mamba_scan_f32(const void* xs, const void* dt, const void* Bs,
                                     const void* Cs, const void* A, void* y, void* state, int B,
                                     int T, int di, int n, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (n) {
    case 4: return launch_n<4>(xs, dt, Bs, Cs, A, y, state, B, T, di, stream);
    case 8: return launch_n<8>(xs, dt, Bs, Cs, A, y, state, B, T, di, stream);
    case 16: return launch_n<16>(xs, dt, Bs, Cs, A, y, state, B, T, di, stream);
    case 32: return launch_n<32>(xs, dt, Bs, Cs, A, y, state, B, T, di, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
