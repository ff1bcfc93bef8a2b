// Batched tiled matrix product for Hopper (sm_90a): C[b] = A[b] @ B[b].
//
// Replaces: src/repro/kernels/matmul.py `matmul_pallas` (body `_matmul_kernel`),
// the TPU kernel behind every rank's block product in the six distributed
// matmul apps (`matmul/common.py` `local_matmul(use_kernel=True)`).
//
// What bounds it on this card: at the apps' block shapes (2048 x 2048 x 2048
// per rank, 4 or 8 ranks) the work is 2*M*N*K operations over (MK+KN+MN)
// elements, several hundred operations per byte: far above the card's
// ridge, so arithmetic bounds it. fp32 inputs must stay full fp32 (the
// tests hold them to 1e-4, which TF32 breaks), so the fp32 bound is the
// CUDA cores' peak (67 TFLOP/s on H100 SXM); bf16 inputs are bounded by the
// tensor cores' bf16 peak, which this kernel does not use yet.
//
// Design (right and simple first):
//   * one 256-thread block per 128 x 128 output tile and batch entry
//     (gridDim.z is the batch: the stacked rank dims, so one launch serves
//     every virtual rank);
//   * K streams through shared memory in 16-deep slices, converted to fp32
//     on the way in (bf16 inputs are widened, then everything is fp32);
//   * each thread keeps an 8 x 8 fp32 micro-tile of C in registers: 64
//     fused multiply-adds per 16 shared-memory loads. Its rows and columns
//     are strided by 16, so a warp's reads of the B slice hit 16
//     consecutive words (no bank conflicts), its reads of the A slice are
//     broadcasts, and its stores of C are coalesced;
//   * every load and store is masked, so any M, N, K works (the TPU kernel
//     asserted even tiling; this kernel's domain is a superset);
//   * C is written in A's dtype after fp32 accumulation, as on the TPU.
// Operands are dense row-major per batch entry: the Python wrapper
// materialises a broadcast (replicated) operand with `.contiguous()`.
// Not yet here: tensor cores (mma.sync / wgmma), TMA and a pipelined ring
// of shared-memory stages; those are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int LANES_M = BM / TM;            // 16 thread rows
constexpr int LANES_N = BN / TN;            // 16 thread columns
constexpr int THREADS = LANES_M * LANES_N;  // 256
constexpr int PAD = 4;                      // skews the transposed A slice's banks

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
              int m, int n, int k) {
  __shared__ float as[BK][BM + PAD];  // A slice, transposed: as[kk][row]
  __shared__ float bs[BK][BN];        // B slice: bs[kk][col]

  const int tid = threadIdx.x;
  const int tx = tid % LANES_N;
  const int ty = tid / LANES_N;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const size_t batch = blockIdx.z;
  a += batch * static_cast<size_t>(m) * k;
  b += batch * static_cast<size_t>(k) * n;
  c += batch * static_cast<size_t>(m) * n;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // A slice (BM x BK): consecutive threads read consecutive k of a row.
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK;
      const int kk = idx % BK;
      const int gr = row0 + r;
      const int gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k) ? to_f32(a[static_cast<size_t>(gr) * k + gk]) : 0.f;
    }
    // B slice (BK x BN): consecutive threads read consecutive columns.
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int kk = idx / BN;
      const int cc = idx % BN;
      const int gk = k0 + kk;
      const int gc = col0 + cc;
      bs[kk][cc] = (gk < k && gc < n) ? to_f32(b[static_cast<size_t>(gk) * n + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float ra[TM];
      float rb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) ra[i] = as[kk][ty + i * LANES_M];
#pragma unroll
      for (int j = 0; j < TN; ++j) rb[j] = bs[kk][tx + j * LANES_N];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty + i * LANES_M;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx + j * LANES_N;
      if (gc < n) store(c + static_cast<size_t>(gr) * n + gc, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int batch, int m, int n, int k,
           void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  matmul_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (bound with ctypes). Each returns cudaGetLastError() right
// after the launch; 0 means the launch was accepted.
extern "C" int mapple_matmul_f32(const void* a, const void* b, void* c, int batch, int m,
                                 int n, int k, void* stream) {
  return launch<float>(a, b, c, batch, m, n, k, stream);
}

extern "C" int mapple_matmul_bf16(const void* a, const void* b, void* c, int batch, int m,
                                  int n, int k, void* stream) {
  return launch<__nv_bfloat16>(a, b, c, batch, m, n, k, stream);
}
