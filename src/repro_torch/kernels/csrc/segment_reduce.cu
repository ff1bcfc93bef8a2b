// Per-row max of contiguous segment sums for Hopper (sm_90a):
//   out[r] = max_j sum_{i<seg} vals[r, j*seg + i],   vals >= 0.
//
// Replaces: src/repro/kernels/segment_reduce.py `segment_rowmax_pallas`
// (body `_segment_rowmax_kernel`), the congestion reduction of the
// simulator's device pricing engine. seg == 1 is the stride-1 level's
// per-row max; seg == stride is an outer level, where the `seg` processors
// of one subtree share a port and their byte loads add before the max.
//
// What bounds it on this card: one add or compare per value read, and each
// value is read once (8 bytes in float64, the pricer's default), far under
// one operation per byte: memory bounds it, at
// (rows * cols + rows) * sizeof(T) / 3.35 TB/s.
//
// Design: the Pallas kernel walks the column axis sequentially with a
// per-row accumulator in VMEM; blocks on this card run in no order, so
// nothing carries between blocks. Instead one block owns one row. Each
// thread takes whole segments j = tid, tid + BLOCK, ..., sums the `seg`
// contiguous values in index order, and keeps a running max that starts at
// 0 (the kernel's contract is vals >= 0, as the Pallas accumulator's zero
// init assumes). Neighbouring threads read neighbouring segments, so a
// warp's loads are contiguous. The block's max is reduced with warp
// shuffles, then across warps through shared memory. Offsets are 64-bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;

template <typename T>
__device__ __forceinline__ T max_of(T a, T b) {
  return b > a ? b : a;
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
segment_rowmax_kernel(const T* __restrict__ vals, T* __restrict__ out, int64_t cols, int seg) {
  const int64_t row = blockIdx.x;
  const T* v = vals + row * cols;
  const int64_t nseg = cols / seg;

  T best = T(0);
  if (seg == 1) {
#pragma unroll 4
    for (int64_t j = threadIdx.x; j < nseg; j += BLOCK) best = max_of(best, v[j]);
  } else {
    for (int64_t j = threadIdx.x; j < nseg; j += BLOCK) {
      const T* p = v + j * seg;
      T s = T(0);
      for (int i = 0; i < seg; ++i) s += p[i];
      best = max_of(best, s);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) best = max_of(best, __shfl_down_sync(0xffffffffu, best, off));

  __shared__ T warp_best[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (warp == 0) {
    best = lane < WARPS ? warp_best[lane] : T(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) best = max_of(best, __shfl_down_sync(0xffffffffu, best, off));
    if (lane == 0) out[row] = best;
  }
}

template <typename T>
int launch(const void* vals, void* out, int64_t rows, int64_t cols, int seg, void* stream) {
  segment_rowmax_kernel<T><<<static_cast<unsigned>(rows), BLOCK, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<T*>(out), cols, seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (bound with ctypes). `vals` is a contiguous (rows, cols)
// array with cols % seg == 0 and 1 <= rows < 2^31 (one block per row); the
// wrapper checks both. Each returns cudaGetLastError() right after the
// launch; 0 means the launch was accepted.
extern "C" int mapple_segment_rowmax_f32(const void* vals, void* out, int64_t rows, int64_t cols,
                                         int seg, void* stream) {
  return launch<float>(vals, out, rows, cols, seg, stream);
}

extern "C" int mapple_segment_rowmax_f64(const void* vals, void* out, int64_t rows, int64_t cols,
                                         int seg, void* stream) {
  return launch<double>(vals, out, rows, cols, seg, stream);
}
