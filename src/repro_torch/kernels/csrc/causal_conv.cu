// Causal depthwise conv1d with the SiLU after it, for Hopper (sm_90a): the
// input stage of Hymba's Mamba mixer on the prefill.
//   xp = [tail; x]                                 (B, W-1+T, di), zeros for no tail
//   y[b, t, c] = silu(sum_{i<W} k[i, c] * xp[b, t + i, c])
// x (B, T, di) with rows at any stride (the xs half of the in-projection's
// xz, read in place), k (W, di) with W = 4, tail (B, W-1, di) or none -> y (B, T, di)
// contiguous, new tail (B, W-1, di) = the last W-1 rows of xp. All in one
// dtype, fp32 or bf16; the sum and the SiLU run in fp32, rounded once.
//
// Replaces: models/hymba.py `_causal_conv` + `F.silu` on the kernel path,
// a zero pad, a concatenation (a copy of the strided xs), W multiplies, W-1
// adds and the SiLU, each a pass over (B, T, di) rounded to bf16.
//
// What bounds it on this card: bytes. x is read once and y written once:
// 2 * B*T*di * 2 bytes, 0.25 ms at the hymba-1.5b prefill cell (B=2,
// T=32768, di=3200) at 3.35 TB/s, against 2*W + 4 operations an element.
//
// Design: a thread owns V adjacent channels (16 bytes: 8 bf16 or 4 fp32;
// 1 where di or the rows are not 16-byte aligned) over TT = 8 consecutive
// steps. It loads its TT rows at once (all in flight together) and keeps
// the W-1 inputs before the current step in fp32 registers, so each row is
// read once, and W-1 rows more at a chunk's start (from x, the tail or
// zeros; mostly from L2, where the previous chunk's thread read them).
// Adjacent threads own adjacent channel groups: a warp's load of one step
// is 32 x 16 contiguous bytes. The SiLU is one MUFU.EX2 and one MUFU.RCP,
// with no branch. The thread whose chunk ends at T writes the new tail
// from its registers. At the cell's shape this ran 0.47 ms, against 0.51
// ms for torch's copy of the same strided half (TT = 4: 0.57; 16: 0.52;
// every row loaded in one array and widened at each tap: 0.69).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int W = 4;            // the conv's width: Mamba's d_conv, Hymba's conv_width
constexpr int TT = 8;           // steps a thread
constexpr int THREADS = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename E>
__device__ __forceinline__ E from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename E, int V>
struct alignas(sizeof(E) * V) Pack {
  E v[V];
};

template <typename E, int V>
__device__ __forceinline__ void widen(float (&out)[V], const Pack<E, V>& pk) {
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = to_f(pk.v[j]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// silu(v) = v / (1 + e^-v) on the MUFU's 2^x and reciprocal (each about
// one ulp; -0 below v = -88), with no branch.
__device__ __forceinline__ float silu(float v) {
  return v * rcp(1.f + ex2(-1.4426950408889634f * v));
}

// Grid (groups of THREADS (chunk, channel group) pairs, B). V channels a
// thread, from channel V * (g % groups), steps t0 .. t0 + TT - 1.
template <typename E, int V>
__global__ void __launch_bounds__(THREADS)
causal_conv_silu_kernel(const E* __restrict__ x, const E* __restrict__ k,
                        const E* __restrict__ tail, E* __restrict__ y,
                        E* __restrict__ tail_out, int64_t sx, int T, int di) {
  const int groups = di / V;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int chunks = (T + TT - 1) / TT;
  if (g >= static_cast<int64_t>(groups) * chunks) return;
  const int b = blockIdx.y;
  const int c = V * static_cast<int>(g % groups);
  const int t0 = TT * static_cast<int>(g / groups);
  const int tn = min(TT, T - t0);
  const E* xb = x + static_cast<int64_t>(b) * T * sx + c;
  const E* tb =
      tail == nullptr ? nullptr : tail + (static_cast<int64_t>(b) * (W - 1)) * di + c;

  float kw[W][V];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const E* row = k + static_cast<int64_t>(i) * di + c;
    widen<E, V>(kw[i], *reinterpret_cast<const Pack<E, V>*>(row));
  }
  // win[i] is xp's row t + i for the next step t (x's row t + i - (W-1):
  // below 0 from the tail or zeros).
  float win[W - 1][V];
#pragma unroll
  for (int i = 0; i < W - 1; ++i) {
    const int r = t0 + i - (W - 1);
    Pack<E, V> pk;
    if (r >= 0) {
      pk = *reinterpret_cast<const Pack<E, V>*>(xb + static_cast<int64_t>(r) * sx);
    } else if (tb != nullptr) {
      pk = *reinterpret_cast<const Pack<E, V>*>(tb + static_cast<int64_t>(r + W - 1) * di);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) pk.v[j] = from_f<E>(0.f);
    }
    widen<E, V>(win[i], pk);
  }
  // The chunk's rows are all loaded before the first is used, so that a
  // thread has its TT loads in flight together.
  Pack<E, V> rows[TT];
#pragma unroll
  for (int tt = 0; tt < TT; ++tt) {
    if (tt < tn) {
      rows[tt] = *reinterpret_cast<const Pack<E, V>*>(xb + static_cast<int64_t>(t0 + tt) * sx);
    }
  }
  E* yb = y + static_cast<int64_t>(b) * T * di + c;
#pragma unroll
  for (int tt = 0; tt < TT; ++tt) {
    if (tt < tn) {
      float cur[V];
      widen<E, V>(cur, rows[tt]);
      Pack<E, V> out;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        // The order of models/hymba.py `_causal_conv`: xp[t] k[0], then
        // each later tap added.
        float acc = win[0][j] * kw[0][j];
#pragma unroll
        for (int i = 1; i < W - 1; ++i) acc = fmaf(win[i][j], kw[i][j], acc);
        acc = fmaf(cur[j], kw[W - 1][j], acc);
        out.v[j] = from_f<E>(silu(acc));
      }
      *reinterpret_cast<Pack<E, V>*>(yb + static_cast<int64_t>(t0 + tt) * di) = out;
#pragma unroll
      for (int i = 0; i < W - 2; ++i) {
#pragma unroll
        for (int j = 0; j < V; ++j) win[i][j] = win[i + 1][j];
      }
#pragma unroll
      for (int j = 0; j < V; ++j) win[W - 2][j] = cur[j];
    }
  }
  if (t0 + tn == T) {       // the last chunk: its window is xp's last W-1 rows
    E* ob = tail_out + (static_cast<int64_t>(b) * (W - 1)) * di + c;
#pragma unroll
    for (int i = 0; i < W - 1; ++i) {
      Pack<E, V> pk;
#pragma unroll
      for (int j = 0; j < V; ++j) pk.v[j] = from_f<E>(win[i][j]);
      *reinterpret_cast<Pack<E, V>*>(ob + static_cast<int64_t>(i) * di) = pk;
    }
  }
}

template <typename E, int V>
int launch(const void* x, const void* k, const void* tail, void* y, void* tail_out, int64_t sx,
           int B, int T, int di, cudaStream_t stream) {
  const int64_t pairs = static_cast<int64_t>(di / V) * ((T + TT - 1) / TT);
  const dim3 grid(static_cast<unsigned>((pairs + THREADS - 1) / THREADS), B);
  causal_conv_silu_kernel<E, V><<<grid, THREADS, 0, stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(k), static_cast<const E*>(tail),
      static_cast<E*>(y), static_cast<E*>(tail_out), sx, T, di);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_v(const void* x, const void* k, const void* tail, void* y, void* tail_out,
             int64_t sx, int B, int T, int di, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(E);
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const bool vec = di % V == 0 && sx % V == 0 &&
                   (addr(x) | addr(k) | addr(tail) | addr(y) | addr(tail_out)) % 16 == 0;
  return vec ? launch<E, V>(x, k, tail, y, tail_out, sx, B, T, di, stream)
             : launch<E, 1>(x, k, tail, y, tail_out, sx, B, T, di, stream);
}

}  // namespace

// C entry point (bound with ctypes). x (B, T, di) with row stride sx
// elements and unit channel stride; k (W, di), tail (B, W-1, di) or null,
// y (B, T, di) and tail_out (B, W-1, di) contiguous; all of dtype 0 (fp32)
// or 1 (bf16); W = 4 and B at most 65535 (the wrapper checks). Returns
// cudaGetLastError() right after the launch; 0 means it was accepted.
extern "C" int mapple_causal_conv_silu(const void* x, const void* k, const void* tail, void* y,
                                       void* tail_out, int64_t sx, int B, int T, int di,
                                       int width, int dtype, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (width != W) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return launch_v<float>(x, k, tail, y, tail_out, sx, B, T, di, stream);
    case 1: return launch_v<__nv_bfloat16>(x, k, tail, y, tail_out, sx, B, T, di, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
