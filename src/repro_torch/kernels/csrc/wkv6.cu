// RWKV-6 WKV recurrence for Hopper (sm_90a), fp32, from a zero state:
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] = w_t[i] * S[i][j] + k_t[i] * v_t[j]
// r/k/v/w (B, T, H, N), u (H, N) -> y (B, T, H, N), final state (B, H, N, N).
//
// Replaces: src/repro/kernels/wkv6.py `wkv6_pallas` (body `_wkv6_kernel`),
// reached from models/rwkv6.py `timemix(use_pallas=True)` through
// kernels/ops.py `wkv6`: the time mix of every RWKV-6 layer's prefill.
//
// What bounds it on this card: each of r, k, v, w is read once and y and
// the state written once, 4 bytes a value. The least work per (batch, head,
// step) is 5*N^2 operations (r.S, 2N^2; the state's decay, outer product
// and sum, 3N^2; the bonus term is O(N)) against 20*N bytes (four inputs
// read, y written): N/4 operations per byte, 16 at N = 64, below the 20 per
// byte at which the fp32 CUDA cores (67 TFLOP/s) overtake the memory (3.35
// TB/s). So the bound is the bytes, (4*B*T*H*N + H*N + B*T*H*N + B*H*N*N)
// * 4 / 3.35 TB/s: 0.126 ms at the rwkv6-3b prefill (B=4, T=2048, H=40,
// N=64), against 0.100 ms for its 6.7e9 operations. Those operations are
// at least 3 fp32 instructions per state element and step (k*v, the decay
// FMA, r*S into y), 0.12 ms at the SMs' 128 fp32 lanes a clock if every
// scheduler issued one every clock. They cannot: each of the 655K state
// elements of a step is a serial chain over the 2048 steps, and a
// register tile that reads little shared memory per element leaves few
// warps. At 16 elements a thread there are 1280 warps for the 528
// schedulers of 132 SMs, so the busiest schedulers carry 3 and wait on
// each step's loads and FMA chains with little else to issue; the time
// follows the busiest scheduler's instructions, not the bound.
//
// Design: the Pallas kernel keeps the (N, N) state in VMEM across an
// ordered time-chunk grid axis; blocks on this card run in no order and
// nothing carries between them, so the whole time loop runs inside one
// block, with the state in registers. Each thread holds a register tile of
// the state, R rows by 4 value columns (R = 4 at N = 64 and 16, 8 at N =
// 32), so each float4 of r, k and w read from shared memory feeds 4 columns
// and each float4 of v feeds R rows: 4 shared loads per 16 state elements
// at R = 4. R = 4 and not 8 at N = 64, though R = 8 reads less shared
// memory an element: it leaves half the warps, and on the card the busiest
// schedulers then wait longer. The RT = N/R row-threads of a column group
// are adjacent lanes, rows interleaved so that their float4 reads are
// conflict-free (thread g holds rows 4*RT*m + 4*g + e); each thread's 4
// sums for y_j are independent chains of R FMAs. y is closed once per
// chunk, not per step: each thread stores its 4 partial sums of a step to
// shared memory, and after the chunk the block sums the RT partials of each
// (step, column) and writes y as float4, so the step loop has no shuffle.
// Value columns are independent, so a (batch, head) is cut into N/COLS
// blocks of COLS columns (COLS = 16 at N = 64: 640 blocks of 2 warps at the
// rwkv6-3b prefill, all resident at once). Chunks of TC = 16 steps of r, k,
// w (all N rows) and v (the block's columns) are copied into shared memory
// with cp.async, double-buffered: the next chunk's copies are in flight
// while the current chunk is computed, at no cost in registers; 16-byte
// copies where the strides and pointers allow it, else 4-byte ones. The
// inputs are read through their (batch, step, head) element strides with
// the last dim contiguous, so the model layout needs no transposed copy; y
// and the state are written contiguous. Any T >= 1: the steps of the ragged
// last chunk past T are neither copied nor run. Operation order per (i, j)
// as the Pallas kernel: kv = k*v; y += r*S + (r*u*k)*v (the bonus summed
// over a thread's rows first); S = w*S + kv; the sums over i run in another
// order.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TC = 16;            // time steps per staged chunk

template <int N>
struct Cfg {
  static constexpr int R = N == 32 ? 8 : 4;  // state rows per thread
  static constexpr int RT = N / R;           // row-threads per column group: 16, 4, 4
  static constexpr int M = R / 4;            // float4 groups of rows per thread
  static constexpr int COLS = N == 64 ? 16 : N;   // value columns per block
  static constexpr int THREADS = RT * COLS / 4;   // 64, 32, 16
  // One step's partial sums of y: column group cg's RT float4 at cg * GS,
  // so that a quarter-warp's stores are contiguous; GS and PROW are
  // skewed so that the reads that close y fall on distinct banks.
  static constexpr int GS = 4 * RT + 4;
  static constexpr int PROW = COLS / 4 * GS + (48 - COLS / 4 * GS % 32) % 32;
};

struct Strides {     // element strides of (batch, step, head); the last dim is contiguous
  int64_t b, t, h;
};

template <int N>
struct Stage {       // one chunk of a block's inputs in shared memory
  float r[TC][N], k[TC][N], w[TC][N], v[TC][Cfg<N>::COLS];
};

// Issue the asynchronous copies of the chunk starting at step t0 (steps
// past T are skipped) and commit them as one batch.
template <int N, bool VEC>
__device__ __forceinline__ void stage(Stage<N>& st, const float* rb, const float* kb,
                                      const float* vb, const float* wb, Strides rs, Strides ks,
                                      Strides vs, Strides ws, int j0, int t0, int T) {
  constexpr int COLS = Cfg<N>::COLS, THREADS = Cfg<N>::THREADS;
  constexpr int W = VEC ? 4 : 1;   // floats per copy
  const int tn = min(TC, T - t0);
  for (int e = threadIdx.x; e < tn * (N / W); e += THREADS) {
    const int tt = e / (N / W), col = W * (e % (N / W));
    const int64_t t = t0 + tt;
    __pipeline_memcpy_async(&st.r[tt][col], rb + t * rs.t + col, 4 * W);
    __pipeline_memcpy_async(&st.k[tt][col], kb + t * ks.t + col, 4 * W);
    __pipeline_memcpy_async(&st.w[tt][col], wb + t * ws.t + col, 4 * W);
  }
  for (int e = threadIdx.x; e < tn * (COLS / W); e += THREADS) {
    const int tt = e / (COLS / W), col = W * (e % (COLS / W));
    const int64_t t = t0 + tt;
    __pipeline_memcpy_async(&st.v[tt][col], vb + t * vs.t + j0 + col, 4 * W);
  }
  __pipeline_commit();
}

template <int N, bool VEC>
__global__ void __launch_bounds__(Cfg<N>::THREADS)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ y, float* __restrict__ state,
            Strides rs, Strides ks, Strides vs, Strides ws, int T, int H) {
  constexpr int RT = Cfg<N>::RT, M = Cfg<N>::M;
  constexpr int COLS = Cfg<N>::COLS, THREADS = Cfg<N>::THREADS;
  __shared__ __align__(16) Stage<N> buf[2];
  __shared__ __align__(16) float part[TC][Cfg<N>::PROW];   // each thread's partial y

  const int g = threadIdx.x % RT;   // row-thread: rows 4*RT*m + 4*g + e
  const int cg = threadIdx.x / RT;  // column group: columns j0 + 4*cg + c
  const int j0 = blockIdx.y * COLS;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const float* rb = r + b * rs.b + h * rs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* wb = w + b * ws.b + h * ws.h;
  const int64_t y_step = static_cast<int64_t>(H) * N;
  float* yb = y + (static_cast<int64_t>(b) * T * H + h) * N + j0;

  float uu[M][4], S[M][4][4];
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uu[m][e] = u[h * N + 4 * RT * m + 4 * g + e];
#pragma unroll
      for (int c = 0; c < 4; ++c) S[m][e][c] = 0.f;
    }
  }

  const int n_chunks = (T + TC - 1) / TC;
  stage<N, VEC>(buf[0], rb, kb, vb, wb, rs, ks, vs, ws, j0, 0, T);
  for (int ck = 0; ck < n_chunks; ++ck) {
    const int t0 = ck * TC;
    if (ck + 1 < n_chunks) {
      // buf[(ck+1) & 1] was last read in chunk ck-1, before the barrier
      // that closed its steps.
      stage<N, VEC>(buf[(ck + 1) & 1], rb, kb, vb, wb, rs, ks, vs, ws, j0, t0 + TC, T);
      __pipeline_wait_prior(1);   // this thread's copies of chunk ck have landed
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();              // ... and every thread's; part is free again
    const Stage<N>& st = buf[ck & 1];
    const int tn = min(TC, T - t0);

    // One step: this thread's share of y for its 4 columns, stored as a
    // partial sum, and the state update; only S carries between steps.
    const auto step = [&](int tt) {
      const float4 v4 = *reinterpret_cast<const float4*>(&st.v[tt][4 * cg]);
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      float bonus = 0.f;                     // sum over this thread's rows of r*u*k
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int i0 = 4 * RT * m + 4 * g;
        const float4 r4 = *reinterpret_cast<const float4*>(&st.r[tt][i0]);
        const float4 k4 = *reinterpret_cast<const float4*>(&st.k[tt][i0]);
        const float4 w4 = *reinterpret_cast<const float4*>(&st.w[tt][i0]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bonus = fmaf(rr[e] * uu[m][e], kk[e], bonus);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[c] = fmaf(rr[e], S[m][e][c], acc[c]);
            S[m][e][c] = fmaf(ww[e], S[m][e][c], kk[e] * vv[c]);
          }
        }
      }
      *reinterpret_cast<float4*>(&part[tt][cg * Cfg<N>::GS + 4 * g]) =
          make_float4(fmaf(bonus, vv[0], acc[0]), fmaf(bonus, vv[1], acc[1]),
                      fmaf(bonus, vv[2], acc[2]), fmaf(bonus, vv[3], acc[3]));
    };
    if (tn == TC) {
#pragma unroll 2
      for (int tt = 0; tt < TC; ++tt) step(tt);
    } else {
      for (int tt = 0; tt < tn; ++tt) step(tt);
    }
    __syncthreads();              // part is complete; buf[ck & 1] is free for chunk ck + 2

    // y of the chunk: each (step, column) sums its RT row-threads'
    // partials; a thread writes 4 adjacent columns of one step.
    for (int e = threadIdx.x; e < tn * (COLS / 4); e += THREADS) {
      const int tt = e / (COLS / 4), q = 4 * (e % (COLS / 4));
      const float* pq = &part[tt][q / 4 * Cfg<N>::GS];
      float4 sum = *reinterpret_cast<const float4*>(pq);
#pragma unroll
      for (int gg = 1; gg < RT; ++gg) {
        const float4 p = *reinterpret_cast<const float4*>(pq + 4 * gg);
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
      *reinterpret_cast<float4*>(yb + (t0 + tt) * y_step + q) = sum;
    }
  }

  float* sb = state + static_cast<int64_t>(blockIdx.x) * N * N + j0 + 4 * cg;
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      *reinterpret_cast<float4*>(sb + (4 * RT * m + 4 * g + e) * N) =
          make_float4(S[m][e][0], S[m][e][1], S[m][e][2], S[m][e][3]);
    }
  }
}

template <int N>
int launch_n(const void* r, const void* k, const void* v, const void* w, const void* u, void* y,
             void* state, const int64_t* st, int B, int T, int H, cudaStream_t stream) {
  const Strides rs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]}, ws{st[9], st[10], st[11]};
  const dim3 grid(B * H, N / Cfg<N>::COLS);
  // 16-byte copies need every row start 16-byte aligned: aligned pointers
  // and strides that are multiples of 4 elements.
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  bool vec = (addr(r) | addr(k) | addr(v) | addr(w)) % 16 == 0;
  for (int i = 0; i < 12; ++i) vec = vec && st[i] % 4 == 0;
  const auto* fr = static_cast<const float*>(r);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fw = static_cast<const float*>(w);
  const auto* fu = static_cast<const float*>(u);
  auto* fy = static_cast<float*>(y);
  auto* fs = static_cast<float*>(state);
  if (vec) {
    wkv6_kernel<N, true><<<grid, Cfg<N>::THREADS, 0, stream>>>(fr, fk, fv, fw, fu, fy, fs, rs,
                                                               ks, vs, ws, T, H);
  } else {
    wkv6_kernel<N, false><<<grid, Cfg<N>::THREADS, 0, stream>>>(fr, fk, fv, fw, fu, fy, fs, rs,
                                                                ks, vs, ws, T, H);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int occupancy_n(int* regs, int* warps) {
  cudaFuncAttributes attr{};
  int blocks = 0;
  cudaError_t err = cudaFuncGetAttributes(&attr, wkv6_kernel<N, true>);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wkv6_kernel<N, true>,
                                                        Cfg<N>::THREADS, 0);
  }
  *regs = attr.numRegs;
  *warps = blocks * ((Cfg<N>::THREADS + 31) / 32);
  return static_cast<int>(err);
}

}  // namespace

// Registers per thread and resident warps per SM of the kernel that
// mapple_wkv6_f32 launches for head size N (16-byte copies).
extern "C" int mapple_wkv6_occupancy(int N, int* regs, int* warps) {
  switch (N) {
    case 16: return occupancy_n<16>(regs, warps);
    case 32: return occupancy_n<32>(regs, warps);
    case 64: return occupancy_n<64>(regs, warps);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// C entry point (bound with ctypes). r, k, v, w (B, T, H, N) are addressed
// through `strides`, 12 int64 element strides (batch, step, head) of r, k,
// v and w in that order, the last dim contiguous; u (H, N), y (B, T, H, N)
// and state (B, H, N, N) are contiguous. N is 16, 32 or 64, T >= 1 and
// B*H at most 2^31 - 1 (the wrapper checks all three). Returns
// cudaGetLastError() right after the launch; 0 means it was accepted.
extern "C" int mapple_wkv6_f32(const void* r, const void* k, const void* v, const void* w,
                               const void* u, void* y, void* state, const void* strides, int B,
                               int T, int H, int N, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t* st = static_cast<const int64_t*>(strides);
  switch (N) {
    case 16: return launch_n<16>(r, k, v, w, u, y, state, st, B, T, H, stream);
    case 32: return launch_n<32>(r, k, v, w, u, y, state, st, B, T, H, stream);
    case 64: return launch_n<64>(r, k, v, w, u, y, state, st, B, T, H, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
