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
// N=64), against 0.100 ms for its 6.7e9 operations. In practice the serial
// time loop sets the pace: each step's y is a dependent sum over N rows,
// and at that shape there are only B*H = 160 (batch, head) pairs for 132
// SMs.
//
// Design: the Pallas kernel keeps the (N, N) state in VMEM across an
// ordered time-chunk grid axis; blocks on this card run in no order and
// nothing carries between them, so the whole time loop runs inside one
// block, with the state in registers. Value columns are independent (S[:, j]
// and y_j need only v_j of v), so a (batch, head) is cut into N/16 blocks of
// 16 columns: 640 blocks of 64 threads at the rwkv6-3b prefill, about five
// on each SM, where one block per (batch, head) would leave 28 of 132 SMs
// with twice the work of the rest. Column j is shared by P = 4 adjacent
// threads, each keeping N/4 rows of S[:, j] (rows in groups of 4: thread p
// holds i = 16g + 4p + e), so the dependent sum for y_j is N/4 long and
// closes with two warp shuffles. Chunks of TC = 16 steps of r, k, w (all N
// rows) and v (the block's columns) are copied into shared memory with
// cp.async, double-buffered: the next chunk's copies are in flight while
// the current chunk is computed, at no cost in registers. r, k, w are read
// as float4 broadcasts. y goes through shared memory and is written back
// per chunk. The inputs are read through their (batch, step, head) element
// strides with the last dim contiguous, so the model layout needs no
// transposed copy; y and the state are written contiguous. Any T >= 1: the
// steps of the ragged last chunk past T are neither copied nor run.
// Operation order per (i, j) as the Pallas kernel: kv = k*v;
// y += (S + u*kv) * r; S = w*S + kv (the sum over i runs in another order).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int P = 4;              // threads sharing one value column
constexpr int NJ = 16;            // value columns per block
constexpr int THREADS = NJ * P;
constexpr int TC = 16;            // time steps per staged chunk

struct Strides {     // element strides of (batch, step, head); the last dim is contiguous
  int64_t b, t, h;
};

template <int N>
struct Stage {       // one chunk of a block's inputs in shared memory
  float r[TC][N], k[TC][N], w[TC][N], v[TC][NJ];
};

// Issue the asynchronous copies of the chunk starting at step t0 (steps
// past T are skipped) and commit them as one batch.
template <int N>
__device__ __forceinline__ void stage(Stage<N>& st, const float* rb, const float* kb,
                                      const float* vb, const float* wb, Strides rs, Strides ks,
                                      Strides vs, Strides ws, int j0, int t0, int T) {
  for (int e = threadIdx.x; e < TC * N; e += THREADS) {
    const int tt = e / N, col = e % N;
    const int64_t t = t0 + tt;
    if (t < T) {
      __pipeline_memcpy_async(&st.r[tt][col], rb + t * rs.t + col, sizeof(float));
      __pipeline_memcpy_async(&st.k[tt][col], kb + t * ks.t + col, sizeof(float));
      __pipeline_memcpy_async(&st.w[tt][col], wb + t * ws.t + col, sizeof(float));
    }
  }
  for (int e = threadIdx.x; e < TC * NJ; e += THREADS) {
    const int tt = e / NJ, col = e % NJ;
    const int64_t t = t0 + tt;
    if (t < T) __pipeline_memcpy_async(&st.v[tt][col], vb + t * vs.t + j0 + col, sizeof(float));
  }
  __pipeline_commit();
}

template <int N>
__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ y, float* __restrict__ state,
            Strides rs, Strides ks, Strides vs, Strides ws, int T, int H) {
  constexpr int NI = N / P;       // rows of S[:, j] per thread
  constexpr int G = NI / 4;       // groups of 4 consecutive rows
  __shared__ __align__(16) Stage<N> buf[2];
  __shared__ float s_y[TC][NJ];

  const int tid = threadIdx.x;
  const int jl = tid / P;         // column within the block
  const int p = tid % P;
  const int j0 = blockIdx.y * NJ;
  const int j = j0 + jl;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const float* rb = r + b * rs.b + h * rs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* wb = w + b * ws.b + h * ws.h;
  const int64_t y_step = static_cast<int64_t>(H) * N;
  float* yb = y + (static_cast<int64_t>(b) * T * H + h) * N + j0;

  float uu[NI], S[NI];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uu[4 * g + e] = u[h * N + 4 * P * g + 4 * p + e];
      S[4 * g + e] = 0.f;
    }
  }

  const int n_chunks = (T + TC - 1) / TC;
  stage<N>(buf[0], rb, kb, vb, wb, rs, ks, vs, ws, j0, 0, T);
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * TC;
    if (c + 1 < n_chunks) {
      // buf[(c+1) & 1] was last read in chunk c-1, before the barrier that
      // closed it.
      stage<N>(buf[(c + 1) & 1], rb, kb, vb, wb, rs, ks, vs, ws, j0, t0 + TC, T);
      __pipeline_wait_prior(1);   // this thread's copies of chunk c have landed
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();              // ... and every thread's
    const Stage<N>& st = buf[c & 1];
    const int tn = min(TC, T - t0);

    for (int tt = 0; tt < tn; ++tt) {
      const float vj = st.v[tt][jl];
      float acc = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int i0 = 4 * P * g + 4 * p;
        const float4 r4 = *reinterpret_cast<const float4*>(&st.r[tt][i0]);
        const float4 k4 = *reinterpret_cast<const float4*>(&st.k[tt][i0]);
        const float4 w4 = *reinterpret_cast<const float4*>(&st.w[tt][i0]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = 4 * g + e;
          const float kv = kk[e] * vj;
          acc = fmaf(fmaf(uu[q], kv, S[q]), rr[e], acc);
          S[q] = fmaf(ww[e], S[q], kv);
        }
      }
#pragma unroll
      for (int off = 1; off < P; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (p == 0) s_y[tt][jl] = acc;
    }
    __syncthreads();              // chunk c is read; s_y is complete

    for (int e = tid; e < tn * NJ; e += THREADS) {
      const int tt = e / NJ, col = e % NJ;
      yb[(t0 + tt) * y_step + col] = s_y[tt][col];
    }
    // s_y is next written after the next chunk's first barrier.
  }

  float* sb = state + static_cast<int64_t>(blockIdx.x) * N * N;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sb[(4 * P * g + 4 * p + e) * N + j] = S[4 * g + e];
  }
}

template <int N>
int launch_n(const void* r, const void* k, const void* v, const void* w, const void* u, void* y,
             void* state, const int64_t* st, int B, int T, int H, cudaStream_t stream) {
  const Strides rs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]}, ws{st[9], st[10], st[11]};
  const dim3 grid(B * H, N / NJ);
  wkv6_kernel<N><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<float*>(state), rs, ks, vs, ws, T, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
