// Causal (optionally sliding-window) flash attention for Hopper (sm_90a),
// fp32 inputs, fp32 online softmax on the CUDA cores. bf16 inputs take
// flash_attention_bf16.cu (tensor cores).
//
// Replaces: src/repro/kernels/flash_attention.py `flash_attention_pallas`
// (body `_flash_kernel`) for fp32 inputs, reached from models/layers.py
// `attention(use_pallas=True)` through kernels/ops.py `flash_attention`:
// the prefill attention of the dense decoder and of Hymba.
//
//   s = (q . k) * scale, masked to -1e30 where k > q (causal) or
//   q - k >= window; running max m and denominator l in fp32;
//   p = exp(s - m); acc = acc * exp(m_prev - m) + p @ v;
//   out = acc / max(l, 1e-30).
//
// The mask stays the finite -1e30 of the reference, not -inf: a row whose
// first tile is wholly masked takes m = -1e30 and p = 1 on it, and the
// first valid score wipes that exactly (exp(-1e30 - m) == 0); with -inf the
// difference -inf - -inf would be NaN.
//
// What bounds it on this card: 4*d operations per (query, key) pair that
// the mask lets through (q.k and p.v), against 4 bytes of q, k, v and out
// per row element: far above one operation per byte at S = 2048, so the
// bound is the CUDA cores' fp32 rate (67 TFLOP/s). fp32 stays in full fp32
// (TF32 is off everywhere), so the tensor cores are not an option here.
//
// Design: one block of 256 threads per (batch*head, 64-query tile). The Q
// tile and each 64-key K/V tile are staged in shared memory (K transposed,
// rows padded by one float so that neither the transposing stores nor the
// reads conflict in banks). A 16 x 16 thread grid: thread (ty, tx) owns
// query rows ty + 16i (i < 4) and, for the scores, key columns tx + 16j
// (j < 4), for the output, head-dim columns tx + 16j (j < d/16). Row max
// and row sum reduce over the 16 tx lanes with warp shuffles; p goes
// through shared memory to the PV product. Key tiles above the diagonal,
// and with a window the tiles wholly left of it, are never loaded. Any S:
// the ragged tile's missing rows are zero-filled, its missing keys masked,
// and its missing queries not stored. GQA without a repeat: query head h
// reads KV head h / (H / Kv). The kernel reads q, k, v and writes out
// through element strides (last dim contiguous), so the model layout
// (B, S, heads, d) needs no copy.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per tile
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int THREADS = TX * TY;
constexpr int RI = BQ / TY;       // query rows per thread
constexpr int CJ = BK / TX;       // key columns per thread
constexpr int KP = BK + 1;        // padded row of K^T and P
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

struct Strides {     // element strides of (batch, seq, head); the last dim is contiguous
  int64_t b, s, h;
};

template <int NJ>
constexpr size_t smem_bytes() {
  constexpr int D = 16 * NJ;
  return sizeof(float) * (BQ * (D + 1) + D * KP + BK * D + BQ * KP);
}

template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os, int S, int H,
             int group, float scale, int window, int causal) {
  constexpr int D = 16 * NJ;
  constexpr int DP = D + 1;
  extern __shared__ float smem[];
  float* sQ = smem;                 // [BQ][DP]
  float* sKt = sQ + BQ * DP;        // [D][KP]
  float* sV = sKt + D * KP;         // [BK][D]
  float* sP = sV + BK * D;          // [BQ][KP]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / group) * ks.h;
  const T* vb = v + b * vs.b + (h / group) * vs.h;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D, s = q0 + r;
    sQ[r * DP + c] = s < S ? to_f(qb[s * qs.s + c]) : 0.f;
  }

  float acc[RI][NJ];
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(S, q0 + BQ) : S;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (k_first / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // the Q tile is in; the last tile's K/V/P reads are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D, s = k0 + r;
      const bool in = s < S;
      sKt[c * KP + r] = in ? to_f(kb[s * ks.s + c]) : 0.f;
      sV[r * D + c] = in ? to_f(vb[s * vs.s + c]) : 0.f;
    }
    __syncthreads();

    float sc[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = sQ[(ty + TY * i) * DP + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = sKt[c * KP + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qp = q0 + ty + TY * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kp = k0 + tx + TX * j;
        bool ok = kp < S;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && qp - kp < window;
        sc[i][j] = ok ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        sP[(ty + TY * i) * KP + tx + TX * j] = to_f(from_f<T>(p));
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RI], vv[NJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = sP[(ty + TY * i) * KP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = sV[c * D + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int s = q0 + ty + TY * i;
    if (s >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) ob[s * os.s + tx + TX * j] = from_f<T>(acc[i][j] / denom);
  }
}

template <typename T, int NJ>
int launch_nj(const void* q, const void* k, const void* v, void* o, const int64_t* st, int B,
              int S, int H, int Kv, float scale, int window, int causal, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<NJ>();
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_kernel<T, NJ><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), qs, ks, vs, os, S, H, H / Kv, scale, window, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, const int64_t* st, int B, int S,
           int H, int Kv, int d, float scale, int window, int causal, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (d) {
    case 16: return launch_nj<T, 1>(q, k, v, o, st, B, S, H, Kv, scale, window, causal, stream);
    case 32: return launch_nj<T, 2>(q, k, v, o, st, B, S, H, Kv, scale, window, causal, stream);
    case 48: return launch_nj<T, 3>(q, k, v, o, st, B, S, H, Kv, scale, window, causal, stream);
    case 64: return launch_nj<T, 4>(q, k, v, o, st, B, S, H, Kv, scale, window, causal, stream);
    case 80: return launch_nj<T, 5>(q, k, v, o, st, B, S, H, Kv, scale, window, causal, stream);
    case 96: return launch_nj<T, 6>(q, k, v, o, st, B, S, H, Kv, scale, window, causal, stream);
    case 112: return launch_nj<T, 7>(q, k, v, o, st, B, S, H, Kv, scale, window, causal, stream);
    case 128: return launch_nj<T, 8>(q, k, v, o, st, B, S, H, Kv, scale, window, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry point (bound with ctypes). q (B, S, H, d), k/v (B, S, Kv, d) and
// o (B, S, H, d) fp32 are addressed through `strides`, 12 int64 element strides
// (batch, seq, head) of q, k, v and o in that order; the last dim is
// contiguous. d is a multiple of 16 up to 128 and H a multiple of Kv; the
// wrapper checks both. Returns cudaGetLastError() right after the
// launch (or the attribute call's error); 0 means the launch was accepted.
extern "C" int mapple_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                          const void* strides, int B, int S, int H, int Kv,
                                          int d, float scale, int window, int causal,
                                          void* stream) {
  return launch<float>(q, k, v, o, static_cast<const int64_t*>(strides), B, S, H, Kv, d, scale,
                       window, causal, stream);
}
