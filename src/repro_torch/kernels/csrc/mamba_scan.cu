// Mamba-1 selective scan from a zero state for Hopper (sm_90a):
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t      (per (channel, state))
//   y_t = sum_n h_t[:, n] * C_t[n]
// xs/dt (B, T, di), Bs/Cs (B, T, n), A (di, n) -> y (B, T, di), final state (B, di, n).
// Two instantiations of one kernel template:
//   * the plain scan: all fp32, as above;
//   * the gated scan, the whole of Hymba's mixer between its projections
//     and w_out: dt is the raw projection and the kernel takes
//     dt = softplus(dt_raw + dt_bias) itself (torch's threshold 20), and
//     writes y = (y + x * D) * silu(z) in the model dtype (fp32 or bf16);
//     xs, dt_raw, Bs, Cs, z, D arrive in the model dtype, rows at any
//     stride (Bs, Cs the two halves of the bc projection, z the second half
//     of xz, all read in place). The state, the sums and the gate run in
//     fp32; y is rounded once.
//
// Replaces: src/repro/kernels/mamba_scan.py `mamba_scan_pallas` (body
// `_mamba_kernel`), reached from models/hymba.py `mamba_mixer(
// use_pallas=True)` through kernels/ops.py `mamba_scan`: the SSM side of
// every Hymba layer's prefill; the gated scan also replaces that mixer's
// dt cast, bias and softplus, the fp32 copies of xs, B and C, and the five
// passes of its output gate.
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
// copies where the channels and rows allow them and the arrays are
// 16-byte aligned, else one element a copy. y_t is closed once per chunk,
// not per step: each lane keeps its partial sums over its 4 states for all
// 32 steps in registers and stores them after the chunk's last step (a
// shared store between two steps would keep the compiler from overlapping
// them), then the block sums the L partials of each (step, channel) and
// writes 4 adjacent channels of y. Any T >= 1: steps of the ragged last
// chunk past T are neither copied nor run. Operation order as the Pallas
// kernel: dA = exp(dt*A), dBx = (dt*x)*B, h = dA*h + dBx (one fused
// multiply-add), y = sum_n h*C.
//
// The gated scan's block adds two warps of helpers (HELP_WARPS) that stage
// the inputs as they arrive (and z beside them) and widen each chunk into
// the plain scan's fp32 layout, dt through the softplus and z through the
// SiLU, once per (step, channel): while the scan's warps run chunk ck, the
// helpers widen chunk ck + 1 and stage chunk ck + 2, so the widening
// overlaps the time loop instead of adding to it. The SM holds only the
// few warps of one or two blocks, and the same widening as a pass between
// two barriers, by the scan's own warps, made the kernel 1.6 to 2.6 times
// the plain scan's time at the hymba prefill cell. The softplus and the
// SiLU take one MUFU.EX2 each and FMAs (a polynomial log1p, a Newton
// reciprocal): the MUFU is the scan's own bottleneck. The time loop is the
// plain scan's, unchanged; the gate is applied where the block sums the
// partials.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

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

// The gated scan's block: the scan's warps and HELP_WARPS warps of helpers
// that stage and widen the chunks, interleaved: warps 1 and 3 help where
// the scan has two warps or more (scan, helper, scan, helper at the hymba
// prefill's state size 16), else warps 1 and 2. How the warps of the one
// or two blocks an SM holds share its four schedulers follows their order;
// the orders measured at the hymba prefill cell (B=2, T=32768, bf16), with
// idle helpers and with working ones: scan warps at 0 and 2 of 4, 1.92 and
// 3.22 ms; at 0 and 1 of 4, 2.75 and 3.66; one helper (scan, helper,
// scan), 2.01 and 4.52; three helpers in blocks of five, 3.48 and 4.30.
constexpr int HELP_WARPS = 2;
constexpr int HELPERS = 32 * HELP_WARPS;
template <int N, bool GATED>
struct Block {
  static constexpr int SCAN_WARPS = (Cfg<N>::THREADS + 31) / 32;
  static constexpr int SIZE = GATED ? (SCAN_WARPS + HELP_WARPS) * 32 : Cfg<N>::THREADS;
  // Bit w set: warp w helps.
  static constexpr unsigned HELP_MASK = SCAN_WARPS >= 2 ? 0b1010u : 0b0110u;
};

// A thread's role: its index among the scan's threads (or -1) and among the
// helpers (or -1).
template <int N, bool GATED>
__device__ __forceinline__ int2 role() {
  if constexpr (!GATED) {
    return make_int2(threadIdx.x, -1);
  } else {
    constexpr unsigned MASK = Block<N, GATED>::HELP_MASK;
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int below = __popc(MASK & ((1u << w) - 1));   // helper warps before warp w
    if ((MASK >> w) & 1u) return make_int2(-1, 32 * below + lane);
    const int s = 32 * (w - below) + lane;
    return make_int2(s < Cfg<N>::THREADS ? s : -1, -1);
  }
}

template <int N>
struct Stage {       // one chunk of a block's inputs in fp32, as the time loop reads them
  float x[TC][CPB], dt[TC][CPB], b[TC][N], c[TC][N];
};

template <typename E, int N>
struct Raw {         // one chunk of the gated scan's inputs as they arrive
  E x[TC][CPB], dt[TC][CPB], z[TC][CPB], b[TC][N], c[TC][N];
};

// The plain scan stages its fp32 inputs as they are, double-buffered.
template <typename E, int N, bool GATED>
struct Smem {
  Stage<N> buf[2];
  float part[TC][Cfg<N>::L][CPB + Cfg<N>::PAD];   // each lane's partial y
};

// The gated scan stages the arrivals, double-buffered, and widens each
// chunk into an fp32 stage, double-buffered too: the helpers widen one
// chunk while the scan reads the one before.
template <typename E, int N>
struct Smem<E, N, true> {
  Raw<E, N> buf[2];
  Stage<N> st[2];
  float gate[2][TC][CPB];                    // silu(z)
  float bias[CPB], d[CPB];                   // dt_bias and D of the block's channels
  float part[TC][Cfg<N>::L][CPB + Cfg<N>::PAD];
};

template <typename E>
struct Args {
  const E* xs;
  const E* dt;                               // the gated scan: dt before bias and softplus
  const E* bs;
  const E* cs;
  const float* A;
  const float* dt_bias;                      // the gated scan's only, as are D and z
  const E* D;
  const E* z;
  E* y;
  float* state;
  int64_t sx, sdt, sb, sc, sz;               // row strides, in elements
  int T, di;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// log1p(w) for w in [0, 1]: w times a degree-7 polynomial (a least-squares
// fit on Chebyshev nodes; relative error 3.6e-7 in fp32), FMAs only.
__device__ __forceinline__ float log1p01(float w) {
  float q = -0.008574780076742172f;
  q = fmaf(q, w, 0.044214725494384766f);
  q = fmaf(q, w, -0.1078546941280365f);
  q = fmaf(q, w, 0.17757117748260498f);
  q = fmaf(q, w, -0.2449965626001358f);
  q = fmaf(q, w, 0.33276188373565674f);
  q = fmaf(q, w, -0.4999745190143585f);
  q = fmaf(q, w, 0.9999998211860657f);
  return w * q;
}

// 1/d for d in [1, 2]: a linear seed and three Newton steps (relative
// error 1.4e-10 before rounding), FMAs only.
__device__ __forceinline__ float rcp12(float d) {
  float r = fmaf(-0.47058823529411764f, d, 1.411764705882353f);
  r = r * fmaf(-d, r, 2.f);
  r = r * fmaf(-d, r, 2.f);
  return r * fmaf(-d, r, 2.f);
}

// softplus(v) = max(v, 0) + log1p(e^-|v|): one MUFU.EX2 and FMAs, no
// branch. Past torch's threshold of 20 the log1p term is below half an
// ulp of v, so the sum is v, as torch returns.
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1p01(ex2(-fabsf(v) * LOG2E));
}

// silu(v) = v * sigmoid(v), sigmoid from w = e^-|v|: 1 / (1 + w) for v >= 0,
// w / (1 + w) below: one MUFU.EX2 and FMAs, no branch.
__device__ __forceinline__ float silu(float v) {
  const float w = ex2(-fabsf(v) * LOG2E);
  const float r = rcp12(1.f + w);
  return v * (v >= 0.f ? r : w * r);
}

// Copy one unit: 16 bytes where VEC, else one element (cp.async takes 4,
// 8 or 16 bytes, so a 2-byte element is loaded and stored).
template <typename E, bool VEC>
__device__ __forceinline__ void copy(E* dst, const E* src) {
  if constexpr (VEC) {
    __pipeline_memcpy_async(dst, src, 16);
  } else if constexpr (sizeof(E) == 4) {
    __pipeline_memcpy_async(dst, src, 4);
  } else {
    *dst = *src;
  }
}

// Write 4 adjacent channels of y, those below di (with VEC, di is a
// multiple of 4: all or none).
template <typename E, bool VEC>
__device__ __forceinline__ void store4(E* out, const float (&v)[4], int valid) {
  if constexpr (VEC && std::is_same_v<E, float>) {
    if (valid > 0) *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    memcpy(&u.x, &lo, 4);
    memcpy(&u.y, &hi, 4);
    if (valid > 0) *reinterpret_cast<uint2*>(out) = u;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < valid) {
        if constexpr (std::is_same_v<E, float>) {
          out[i] = v[i];
        } else {
          out[i] = __float2bfloat16_rn(v[i]);
        }
      }
    }
  }
}

// Issue the copies of the chunk starting at step t0 (steps past T are
// skipped, and so are channels past di) and commit them: the plain scan's,
// whose inputs are contiguous (the chunk's B and C rows are one run).
template <int N, bool VEC>
__device__ __forceinline__ void stage(Stage<N>& st, const Args<float>& a, int64_t row0, int t0,
                                      int c0) {
  constexpr int THREADS = Cfg<N>::THREADS;
  constexpr int W = VEC ? 4 : 1;             // floats per copy
  const int tn = min(TC, a.T - t0);
  const int64_t bc0 = (row0 + t0) * N;
  for (int e = threadIdx.x; e < tn * (CPB / W); e += THREADS) {
    const int tt = e / (CPB / W), q = W * (e % (CPB / W));
    if (c0 + q < a.di) {                     // with W = 4, di % 4 == 0: all or none
      const int64_t off = (row0 + t0 + tt) * a.di + c0 + q;
      copy<float, VEC>(&st.x[tt][q], a.xs + off);
      copy<float, VEC>(&st.dt[tt][q], a.dt + off);
    }
  }
  for (int e = threadIdx.x; e < tn * (N / W); e += THREADS) {
    copy<float, VEC>(&st.b[0][0] + W * e, a.bs + bc0 + W * e);
    copy<float, VEC>(&st.c[0][0] + W * e, a.cs + bc0 + W * e);
  }
  __pipeline_commit();
}

// The helpers' copies of the chunk starting at step t0 into a raw buffer:
// helper h takes one channel group of every RP-th step (and likewise for B
// and C), its pointers stepped a whole pass at a time, so that a copy
// costs few instructions on a scheduler shared with a scan warp.
template <int N, bool VEC, typename E>
__device__ __forceinline__ void stage_raw(Raw<E, N>& st, const Args<E>& a, int64_t row0, int t0,
                                          int c0, int h) {
  constexpr int V = VEC ? 16 / sizeof(E) : 1;    // elements a copy
  constexpr int PR = CPB / V, RP = HELPERS / PR; // copies a row, rows a pass
  constexpr int PB = N / V, RB = HELPERS / PB;   // the same for B and C
  const int tn = min(TC, a.T - t0);
  const int q = V * (h % PR), r = h / PR;
  if (c0 + q < a.di) {                           // with VEC, di % V == 0: all or none
    const int64_t row = row0 + t0 + r;
    const E* px = a.xs + row * a.sx + c0 + q;
    const E* pdt = a.dt + row * a.sdt + c0 + q;
    const E* pz = a.z + row * a.sz + c0 + q;
    // Unrolled only with 16-byte copies: one element a copy makes 32
    // passes, whose loads in flight would take the registers of the scan.
#pragma unroll(VEC ? TC : 1)
    for (int k = 0; k < (TC + RP - 1) / RP; ++k) {
      const int tt = k * RP + r;
      if (tt < tn) {
        copy<E, VEC>(&st.x[tt][q], px + k * RP * a.sx);
        copy<E, VEC>(&st.dt[tt][q], pdt + k * RP * a.sdt);
        copy<E, VEC>(&st.z[tt][q], pz + k * RP * a.sz);
      }
    }
  }
  const int qb = V * (h % PB), rb = h / PB;
  const E* pb = a.bs + (row0 + t0 + rb) * a.sb + qb;
  const E* pc = a.cs + (row0 + t0 + rb) * a.sc + qb;
#pragma unroll(VEC ? TC : 1)
  for (int k = 0; k < (TC + RB - 1) / RB; ++k) {
    const int tt = k * RB + rb;
    if (tt < tn) {
      copy<E, VEC>(&st.b[tt][qb], pb + k * RB * a.sb);
      copy<E, VEC>(&st.c[tt][qb], pc + k * RB * a.sc);
    }
  }
  __pipeline_commit();
}

// The helpers' widening pass over a landed chunk into stage j: helper warp
// hw takes steps hw, hw + HELP_WARPS, ..., lane l channel l (and the
// helpers the (step, state) elements of B and C in turn), in rounds of RW
// steps whose shared loads are all issued before their first store (the
// compiler cannot move a load from one shared array above a store to
// another), and whose math is branch-free, so that a round's chains
// overlap.
template <int N, typename E>
__device__ __forceinline__ void widen(Smem<E, N, true>& sm, const Raw<E, N>& raw, int j, int tn,
                                      int h) {
  constexpr int K = (TC + HELP_WARPS - 1) / HELP_WARPS, RW = 4;
  const int hw = h / 32, lane = h % 32;
  Stage<N>& st = sm.st[j];
  const float bias = sm.bias[lane];
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += RW) {
    float x[RW], dt[RW], z[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int tt = min(hw + HELP_WARPS * (k0 + i), TC - 1);
      x[i] = to_f(raw.x[tt][lane]);
      dt[i] = to_f(raw.dt[tt][lane]) + bias;
      z[i] = to_f(raw.z[tt][lane]);
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int tt = hw + HELP_WARPS * (k0 + i);
      if (k0 + i < K && tt < tn) {
        st.x[tt][lane] = x[i];
        st.dt[tt][lane] = softplus(dt[i]);
        sm.gate[j][tt][lane] = silu(z[i]);
      }
    }
  }
  constexpr int KB = (TC * N + HELPERS - 1) / HELPERS;   // (step, state) elements a helper
#pragma unroll
  for (int i0 = 0; i0 < KB; i0 += RW) {
    float b[RW], c[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int f = min(h + HELPERS * (i0 + i), TC * N - 1);
      b[i] = to_f((&raw.b[0][0])[f]);
      c[i] = to_f((&raw.c[0][0])[f]);
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int f = h + HELPERS * (i0 + i);
      if (i0 + i < KB && f / N < tn) {
        (&st.b[0][0])[f] = b[i];
        (&st.c[0][0])[f] = c[i];
      }
    }
  }
}

// The helpers' share of chunk ck (ck = -1 before the first, with chunk 0
// staged): stage chunk ck + 2 into the raw buffer that chunk ck's widening
// freed, wait for chunk ck + 1's copies (issued a chunk earlier), and widen
// it. Not inlined: inlined, its registers joined the scan's (255 a thread,
// and 112 bytes spilled at state size 16).
template <int N, bool VEC, typename E>
__device__ __noinline__ void help(Smem<E, N, true>& sm, const Args<E>& a, int64_t row0, int c0,
                                  int ck, int n_chunks, int h) {
  if (ck + 2 < n_chunks) {
    stage_raw<N, VEC>(sm.buf[ck & 1], a, row0, (ck + 2) * TC, c0, h);
    __pipeline_wait_prior(1);
  } else {
    __pipeline_wait_prior(0);
  }
  asm volatile("bar.sync 1, %0;" ::"n"(HELPERS));   // every helper's copies have landed
  if (ck + 1 < n_chunks) {
    widen<N>(sm, sm.buf[(ck + 1) & 1], (ck + 1) & 1, min(TC, a.T - (ck + 1) * TC), h);
  }
}

template <int N, bool VEC, typename E, bool GATED>
__global__ void __launch_bounds__(Block<N, GATED>::SIZE)
mamba_scan_kernel(const Args<E> a) {
  constexpr int L = Cfg<N>::L, SIZE = Block<N, GATED>::SIZE;
  extern __shared__ float4 smem_raw[];
  Smem<E, N, GATED>& sm = *reinterpret_cast<Smem<E, N, GATED>*>(smem_raw);

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * CPB;
  const int2 who = role<N, GATED>();
  const bool scans = who.x >= 0;
  const int helper = who.y;                  // the gated scan's helpers: >= 0
  const int lc = 2 * (who.x / L);            // this thread's channels: c0 + lc, c0 + lc + 1
  const int ln = who.x % L;                  // states 4*ln .. 4*ln + 3
  const int di = a.di, T = a.T;
  const int64_t row0 = static_cast<int64_t>(b) * T;
  float al[2][4], h[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = c0 + lc + i;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      al[i][e] = scans && c < di ? a.A[static_cast<int64_t>(c) * N + 4 * ln + e] * LOG2E : 0.f;
      h[i][e] = 0.f;
    }
  }

  const int n_chunks = (T + TC - 1) / TC;
  if constexpr (GATED) {
    for (int q = threadIdx.x; q < CPB; q += SIZE) {
      const bool in = c0 + q < di;
      sm.bias[q] = in ? a.dt_bias[c0 + q] : 0.f;
      sm.d[q] = in ? to_f(a.D[c0 + q]) : 0.f;
    }
    __syncthreads();
    if (helper >= 0) {      // chunks 0 and 1 staged, chunk 0 widened
      stage_raw<N, VEC>(sm.buf[0], a, row0, 0, c0, helper);
      help<N, VEC>(sm, a, row0, c0, -1, n_chunks, helper);
    }
  } else {
    stage<N, VEC>(sm.buf[0], a, row0, 0, c0);
  }
  for (int ck = 0; ck < n_chunks; ++ck) {
    const int t0 = ck * TC;
    if constexpr (!GATED) {
      if (ck + 1 < n_chunks) {
        // buf[(ck+1) & 1] was last read in chunk ck-1, before the barrier
        // that closed its steps.
        stage<N, VEC>(sm.buf[(ck + 1) & 1], a, row0, t0 + TC, c0);
        __pipeline_wait_prior(1);   // this thread's copies of chunk ck have landed
      } else {
        __pipeline_wait_prior(0);
      }
    }
    // Chunk ck is staged (gated: widened, in the helpers' previous share)
    // and part is free again.
    __syncthreads();
    const int tn = min(TC, T - t0);
    const Stage<N>& st = [&]() -> const Stage<N>& {
      if constexpr (GATED) {
        return sm.st[ck & 1];
      } else {
        return sm.buf[ck & 1];
      }
    }();

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
    if (scans) {
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
    }
    if constexpr (GATED) {
      if (helper >= 0) help<N, VEC>(sm, a, row0, c0, ck, n_chunks, helper);
    }
    __syncthreads();              // part is complete; buf[ck & 1] is free for chunk ck + 2

    // y of the chunk: each (step, channel) sums its L lanes' partials (and
    // the gated scan applies its gate); a thread writes 4 adjacent
    // channels of one step.
    for (int e = threadIdx.x; e < tn * (CPB / 4); e += SIZE) {
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
      float sv[4] = {sum.x, sum.y, sum.z, sum.w};
      if constexpr (GATED) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sv[i] = (sv[i] + st.x[tt][q + i] * sm.d[q + i]) * sm.gate[ck & 1][tt][q + i];
        }
      }
      store4<E, VEC>(a.y + (row0 + t0 + tt) * di + c0 + q, sv, di - (c0 + q));
    }
  }
  if (scans) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = c0 + lc + i;
      if (c < di) {
        *reinterpret_cast<float4*>(a.state + (static_cast<int64_t>(b) * di + c) * N + 4 * ln) =
            make_float4(h[i][0], h[i][1], h[i][2], h[i][3]);
      }
    }
  }
}

// Shared memory above 48 KB must be granted to the kernel first.
template <int N, bool VEC, typename E, bool GATED>
cudaError_t allow_smem() {
  constexpr int BYTES = sizeof(Smem<E, N, GATED>);
  if (BYTES <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(mamba_scan_kernel<N, VEC, E, GATED>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
}

template <int N, bool VEC, typename E, bool GATED>
int launch(const Args<E>& a, int B, cudaStream_t stream) {
  const cudaError_t err = allow_smem<N, VEC, E, GATED>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.di + CPB - 1) / CPB, B);
  mamba_scan_kernel<N, VEC, E, GATED>
      <<<grid, Block<N, GATED>::SIZE, sizeof(Smem<E, N, GATED>), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte copies and y stores where every channel run and row fits them.
template <int N, typename E, bool GATED>
int launch_n(const Args<E>& a, int B, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(E);
  if constexpr (N % V == 0) {                // else a row of B is under 16 bytes
    const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
    const bool vec = a.di % V == 0 &&
                     (a.sx | a.sdt | a.sb | a.sc | (GATED ? a.sz : 0)) % V == 0 &&
                     (addr(a.xs) | addr(a.dt) | addr(a.bs) | addr(a.cs) | addr(a.y) |
                      addr(a.z)) % 16 == 0;
    if (vec) return launch<N, true, E, GATED>(a, B, stream);
  }
  return launch<N, false, E, GATED>(a, B, stream);
}

template <typename E, bool GATED>
int launch_any(const Args<E>& a, int B, int n, cudaStream_t stream) {
  switch (n) {
    case 4: return launch_n<4, E, GATED>(a, B, stream);
    case 8: return launch_n<8, E, GATED>(a, B, stream);
    case 16: return launch_n<16, E, GATED>(a, B, stream);
    case 32: return launch_n<32, E, GATED>(a, B, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int N>
int occupancy_n(int* regs, int* warps) {
  cudaFuncAttributes attr{};
  int blocks = 0;
  cudaError_t err = allow_smem<N, true, float, false>();
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&attr, mamba_scan_kernel<N, true, float, false>);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, mamba_scan_kernel<N, true, float, false>, Cfg<N>::THREADS,
        sizeof(Smem<float, N, false>));
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

// C entry point (bound with ctypes): the plain scan. All arrays contiguous
// fp32; n is 4, 8, 16 or 32 and B at most 65535 (the wrapper checks both).
// Returns cudaGetLastError() right after the launch; 0 means it was
// accepted.
extern "C" int mapple_mamba_scan_f32(const void* xs, const void* dt, const void* Bs,
                                     const void* Cs, const void* A, void* y, void* state, int B,
                                     int T, int di, int n, void* stream_ptr) {
  Args<float> a{static_cast<const float*>(xs), static_cast<const float*>(dt),
                static_cast<const float*>(Bs), static_cast<const float*>(Cs),
                static_cast<const float*>(A), nullptr, nullptr, nullptr,
                static_cast<float*>(y), static_cast<float*>(state),
                di, di, n, n, 0, T, di};
  return launch_any<float, false>(a, B, n, static_cast<cudaStream_t>(stream_ptr));
}

// C entry point: the gated scan. xs, dt (raw), Bs, Cs, z (B, T, .) with
// unit channel stride and the row strides in `strides` (5 x int64 on the
// host: xs, dt, Bs, Cs, z); D (di,) and y (B, T, di) contiguous, all of
// dtype 0 (fp32) or 1 (bf16); A (di, n), dt_bias (di,) and state
// (B, di, n) fp32. n and B as the plain scan's.
extern "C" int mapple_mamba_scan_gated(const void* xs, const void* dt, const void* Bs,
                                       const void* Cs, const void* A, const void* dt_bias,
                                       const void* D, const void* z, void* y, void* state,
                                       const int64_t* strides, int B, int T, int di, int n,
                                       int dtype, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto args = [&](auto* e) {
    using E = std::remove_pointer_t<decltype(e)>;
    return Args<E>{static_cast<const E*>(xs), static_cast<const E*>(dt),
                   static_cast<const E*>(Bs), static_cast<const E*>(Cs),
                   static_cast<const float*>(A), static_cast<const float*>(dt_bias),
                   static_cast<const E*>(D), static_cast<const E*>(z),
                   static_cast<E*>(y), static_cast<float*>(state),
                   strides[0], strides[1], strides[2], strides[3], strides[4], T, di};
  };
  switch (dtype) {
    case 0: return launch_any<float, true>(args(static_cast<float*>(nullptr)), B, n, stream);
    case 1:
      return launch_any<__nv_bfloat16, true>(args(static_cast<__nv_bfloat16*>(nullptr)), B, n,
                                             stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
