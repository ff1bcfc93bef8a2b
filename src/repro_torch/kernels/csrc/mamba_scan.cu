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
// What bounds it on this card. Bytes: each input is read once and each
// output written once, 4 bytes a value, (2*B*T*di + 2*B*T*n + di*n +
// B*T*di + B*di*n) * 4 / 3.35 TB/s, 0.0945 ms at the hymba-1.5b prefill
// (B=4, T=2048, di=3200, n=16). Operations: about 7 per (b, t, channel,
// state) element, far below the fp32 peak; but one of them is an
// exponential, and the SM's special-function unit gives 16 MUFU.EX2
// results a clock: the 419M of that prefill take 0.100 ms at 1.98 GHz, a
// floor just above the bytes bound. Beneath both lies the serial time
// loop: each (channel, state) is one dependent chain of 2048 steps, so
// the kernel is fast only if a warp overlaps many steps' loads,
// exponentials and FMAs.
//
// Design: the Pallas kernel keeps the (di, n) state in VMEM across an
// ordered time grid; blocks on this card run in no order and nothing
// carries between them, so the whole time loop runs inside one block with
// the state in registers. Each thread holds 2 adjacent channels by 4
// consecutive states (L = n/4 lanes a channel pair): B_t and C_t, read as
// one float4 each, serve both channels, and dt, x as one float2 each, so
// a step costs a lane 14 words of shared memory for 8 elements; shared
// memory gives an SM 32 words a clock, so fewer words an element leave
// it room beside the exponentials. h and A*log2(e) stay in registers
// and each exponential is one `ex2.approx.ftz` (one MUFU.EX2; relative
// error about 2^-22, inside the fp32 1e-4; results below 2^-126 flush to
// zero, against a true value under 1.2e-38). 32 channels a block, grid
// (channel blocks, B): 400 blocks of 2 warps at the hymba prefill. Chunks
// of TC = 32 steps of xs, dt (the block's channels) and of Bs, Cs are
// copied into shared memory with cp.async, double-buffered, so the next
// chunk's loads are in flight while the current one is scanned; 16-byte
// copies where di is a multiple of 4 and the arrays 16-byte aligned, else
// 4-byte ones. y_t is closed once per chunk, not per step: each lane keeps
// its partial sums over its 4 states for all 32 steps in registers and
// stores them after the chunk's last step (a shared store between two
// steps would keep the compiler from overlapping them), then the block
// sums the L partials of each (step, channel) and writes y as float4.
// Any T >= 1: steps of the ragged last chunk past T are neither copied
// nor run. Operation order as the Pallas kernel: dA = exp(dt*A), dBx =
// (dt*x)*B, h = dA*h + dBx (one fused multiply-add), y = sum_n h*C.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TC = 32;                       // time steps per staged chunk
constexpr int CPB = 32;                      // channels per block, 2 per thread
constexpr float LOG2E = 1.4426950408889634f;

template <int N>
struct Cfg {
  static constexpr int L = N / 4;            // lanes per channel pair, 4 states each
  static constexpr int THREADS = CPB / 2 * L;     // 16, 32, 64, 128
  // A row of partial sums is CPB + PAD floats, so that the lanes of a
  // half-warp store to distinct banks.
  static constexpr int PAD = 32 / L;
};

template <int N>
struct Stage {       // one chunk of a block's inputs in shared memory
  float x[TC][CPB], dt[TC][CPB], b[TC][N], c[TC][N];
};

template <int N>
struct Smem {
  Stage<N> buf[2];
  float part[TC][Cfg<N>::L][CPB + Cfg<N>::PAD];   // each lane's partial y
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Issue the asynchronous copies of the chunk starting at step t0 (steps
// past T are skipped, and so are channels past di) and commit them.
template <int N, bool VEC>
__device__ __forceinline__ void stage(Stage<N>& st, const float* xs, const float* dt,
                                      const float* Bs, const float* Cs, int64_t row0, int t0,
                                      int T, int c0, int di) {
  constexpr int THREADS = Cfg<N>::THREADS;
  constexpr int W = VEC ? 4 : 1;             // floats per copy
  const int tn = min(TC, T - t0);
  const int64_t bc0 = (row0 + t0) * N;       // the chunk's B/C rows are contiguous
  for (int e = threadIdx.x; e < tn * (CPB / W); e += THREADS) {
    const int tt = e / (CPB / W), q = W * (e % (CPB / W));
    if (c0 + q < di) {                       // with W = 4, di % 4 == 0: all or none
      const int64_t off = (row0 + t0 + tt) * di + c0 + q;
      __pipeline_memcpy_async(&st.x[tt][q], xs + off, 4 * W);
      __pipeline_memcpy_async(&st.dt[tt][q], dt + off, 4 * W);
    }
  }
  for (int e = threadIdx.x; e < tn * (N / W); e += THREADS) {
    __pipeline_memcpy_async(&st.b[0][0] + W * e, Bs + bc0 + W * e, 4 * W);
    __pipeline_memcpy_async(&st.c[0][0] + W * e, Cs + bc0 + W * e, 4 * W);
  }
  __pipeline_commit();
}

template <int N, bool VEC>
__global__ void __launch_bounds__(Cfg<N>::THREADS)
mamba_scan_kernel(const float* __restrict__ xs, const float* __restrict__ dt,
                  const float* __restrict__ Bs, const float* __restrict__ Cs,
                  const float* __restrict__ A, float* __restrict__ y, float* __restrict__ state,
                  int T, int di) {
  constexpr int L = Cfg<N>::L, THREADS = Cfg<N>::THREADS;
  extern __shared__ float4 smem_raw[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(smem_raw);

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CPB;
  const int lc = 2 * (threadIdx.x / L);      // this thread's channels: c0 + lc, c0 + lc + 1
  const int ln = threadIdx.x % L;            // states 4*ln .. 4*ln + 3
  const int64_t row0 = static_cast<int64_t>(b) * T;
  float al[2][4], h[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = c0 + lc + i;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      al[i][e] = c < di ? A[static_cast<int64_t>(c) * N + 4 * ln + e] * LOG2E : 0.f;
      h[i][e] = 0.f;
    }
  }

  const int n_chunks = (T + TC - 1) / TC;
  stage<N, VEC>(sm.buf[0], xs, dt, Bs, Cs, row0, 0, T, c0, di);
  for (int ck = 0; ck < n_chunks; ++ck) {
    const int t0 = ck * TC;
    if (ck + 1 < n_chunks) {
      // buf[(ck+1) & 1] was last read in chunk ck-1, before the barrier
      // that closed its steps.
      stage<N, VEC>(sm.buf[(ck + 1) & 1], xs, dt, Bs, Cs, row0, t0 + TC, T, c0, di);
      __pipeline_wait_prior(1);   // this thread's copies of chunk ck have landed
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();              // ... and every thread's; part is free again
    const Stage<N>& st = sm.buf[ck & 1];
    const int tn = min(TC, T - t0);

    // One step for this thread's 8 elements, returning its 2 partial sums
    // of y_t; only h carries from one step to the next.
    const auto step = [&](int tt) {
      const float2 dt2 = *reinterpret_cast<const float2*>(&st.dt[tt][lc]);
      const float2 x2 = *reinterpret_cast<const float2*>(&st.x[tt][lc]);
      const float4 b4 = *reinterpret_cast<const float4*>(&st.b[tt][4 * ln]);
      const float4 c4 = *reinterpret_cast<const float4*>(&st.c[tt][4 * ln]);
      const float dtv[2] = {dt2.x, dt2.y};
      const float dtx[2] = {dt2.x * x2.x, dt2.y * x2.y};
      float yp[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        h[i][0] = fmaf(ex2(dtv[i] * al[i][0]), h[i][0], dtx[i] * b4.x);
        h[i][1] = fmaf(ex2(dtv[i] * al[i][1]), h[i][1], dtx[i] * b4.y);
        h[i][2] = fmaf(ex2(dtv[i] * al[i][2]), h[i][2], dtx[i] * b4.z);
        h[i][3] = fmaf(ex2(dtv[i] * al[i][3]), h[i][3], dtx[i] * b4.w);
        yp[i] = fmaf(h[i][3], c4.w, fmaf(h[i][2], c4.z, fmaf(h[i][1], c4.y, h[i][0] * c4.x)));
      }
      return make_float2(yp[0], yp[1]);
    };
    if (tn == TC) {
      // The chunk's partials stay in registers until its last step: with
      // no shared store among the steps, the compiler is free to issue
      // later steps' loads and exponentials early and overlap the steps.
      float2 yp[TC];
#pragma unroll
      for (int tt = 0; tt < TC; ++tt) yp[tt] = step(tt);
#pragma unroll
      for (int tt = 0; tt < TC; ++tt) {
        *reinterpret_cast<float2*>(&sm.part[tt][ln][lc]) = yp[tt];
      }
    } else {
      for (int tt = 0; tt < tn; ++tt) {
        *reinterpret_cast<float2*>(&sm.part[tt][ln][lc]) = step(tt);
      }
    }
    __syncthreads();              // part is complete; buf[ck & 1] is free for chunk ck + 2

    // y of the chunk: each (step, channel) sums its L lanes' partials; a
    // thread writes 4 adjacent channels of one step.
    for (int e = threadIdx.x; e < tn * (CPB / 4); e += THREADS) {
      const int tt = e / (CPB / 4), q = 4 * (e % (CPB / 4));
      float4 sum = *reinterpret_cast<const float4*>(&sm.part[tt][0][q]);
#pragma unroll
      for (int l = 1; l < L; ++l) {
        const float4 p = *reinterpret_cast<const float4*>(&sm.part[tt][l][q]);
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
      float* out = y + (row0 + t0 + tt) * di + c0 + q;
      if constexpr (VEC) {
        if (c0 + q < di) *reinterpret_cast<float4*>(out) = sum;
      } else {
        const float sv[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (c0 + q + i < di) out[i] = sv[i];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = c0 + lc + i;
    if (c < di) {
      *reinterpret_cast<float4*>(state + (static_cast<int64_t>(b) * di + c) * N + 4 * ln) =
          make_float4(h[i][0], h[i][1], h[i][2], h[i][3]);
    }
  }
}

// Shared memory above 48 KB (n = 32) must be granted to the kernel first.
template <int N, bool VEC>
cudaError_t allow_smem() {
  constexpr int BYTES = sizeof(Smem<N>);
  if (BYTES <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(mamba_scan_kernel<N, VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
}

template <int N, bool VEC>
int launch(const float* xs, const float* dt, const float* Bs, const float* Cs, const float* A,
           float* y, float* state, int B, int T, int di, cudaStream_t stream) {
  const cudaError_t err = allow_smem<N, VEC>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((di + CPB - 1) / CPB, B);
  mamba_scan_kernel<N, VEC><<<grid, Cfg<N>::THREADS, sizeof(Smem<N>), stream>>>(
      xs, dt, Bs, Cs, A, y, state, T, di);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_n(const void* xs, const void* dt, const void* Bs, const void* Cs, const void* A,
             void* y, void* state, int B, int T, int di, cudaStream_t stream) {
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const bool vec =
      di % 4 == 0 && (addr(xs) | addr(dt) | addr(Bs) | addr(Cs) | addr(y)) % 16 == 0;
  const auto* fx = static_cast<const float*>(xs);
  const auto* fdt = static_cast<const float*>(dt);
  const auto* fb = static_cast<const float*>(Bs);
  const auto* fc = static_cast<const float*>(Cs);
  const auto* fa = static_cast<const float*>(A);
  auto* fy = static_cast<float*>(y);
  auto* fs = static_cast<float*>(state);
  return vec ? launch<N, true>(fx, fdt, fb, fc, fa, fy, fs, B, T, di, stream)
             : launch<N, false>(fx, fdt, fb, fc, fa, fy, fs, B, T, di, stream);
}

template <int N>
int occupancy_n(int* regs, int* warps) {
  cudaFuncAttributes attr{};
  int blocks = 0;
  cudaError_t err = allow_smem<N, true>();
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, mamba_scan_kernel<N, true>);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mamba_scan_kernel<N, true>,
                                                        Cfg<N>::THREADS, sizeof(Smem<N>));
  }
  *regs = attr.numRegs;
  *warps = blocks * ((Cfg<N>::THREADS + 31) / 32);
  return static_cast<int>(err);
}

}  // namespace

// Registers per thread and resident warps per SM of the kernel that
// mapple_mamba_scan_f32 launches for state size n (16-byte copies).
extern "C" int mapple_mamba_scan_occupancy(int n, int* regs, int* warps) {
  switch (n) {
    case 4: return occupancy_n<4>(regs, warps);
    case 8: return occupancy_n<8>(regs, warps);
    case 16: return occupancy_n<16>(regs, warps);
    case 32: return occupancy_n<32>(regs, warps);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
