// 5-point Jacobi sweep for Hopper (sm_90a): out = 0.2 * (c + n + s + w + e).
//
// Replaces: src/repro/kernels/stencil.py `stencil_pallas` (body
// `_stencil_kernel`), the TPU kernel for paper app 8's hot loop.
//
// One kernel serves both call sites, batched over the leading dims:
//   * offset = 0, output shape == input shape, neighbours past the edge
//     replicated (clamped): exactly `stencil_pallas` / `ops.stencil_step`;
//   * offset = 1, the input is a halo-padded block (H+2, W+2) and the output
//     its H x W interior: the stencil app's per-rank sweep after the halo
//     exchange (`science/stencil2d.py`), every rank in one launch.
//
// What bounds it on this card: 5 operations per point against 8 bytes per
// point moved (one fp32 read, one fp32 write), under one operation per
// byte: memory bounds it, at (input + output bytes) / 3.35 TB/s.
//
// Design: a 32 x 8 thread block owns a 32-wide, 32-tall output tile (four
// rows per thread). It stages the tile plus a 1-deep halo (34 x 34) in
// shared memory once, with clamped coordinates, so each input value is read
// from device memory about once (34*34 / 32*32 = 1.13 reads per point) and
// the five neighbour reads come from shared memory. Loads and stores run
// along rows, so a warp touches consecutive addresses. The sum is taken in
// the reference's order, c + n + s + w + e, then scaled.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int ROWS = 4;
constexpr int TILE_H = TY * ROWS;  // 32
constexpr int TILE_W = TX;         // 32

__global__ void __launch_bounds__(TX * TY)
stencil_kernel(const float* __restrict__ in, float* __restrict__ out, int h_in, int w_in,
               int h_out, int w_out, int offset) {
  __shared__ float tile[TILE_H + 2][TILE_W + 2];

  const size_t b = blockIdx.z;
  in += b * static_cast<size_t>(h_in) * w_in;
  out += b * static_cast<size_t>(h_out) * w_out;
  const int ox0 = blockIdx.x * TILE_W;
  const int oy0 = blockIdx.y * TILE_H;
  // Input coordinates of tile[0][0]: the centre of output (oy, ox) is input
  // (oy + offset, ox + offset), and the tile carries a 1-deep halo.
  const int iy0 = oy0 + offset - 1;
  const int ix0 = ox0 + offset - 1;

  for (int idx = threadIdx.y * TX + threadIdx.x; idx < (TILE_H + 2) * (TILE_W + 2);
       idx += TX * TY) {
    const int ly = idx / (TILE_W + 2);
    const int lx = idx % (TILE_W + 2);
    const int gy = min(max(iy0 + ly, 0), h_in - 1);
    const int gx = min(max(ix0 + lx, 0), w_in - 1);
    tile[ly][lx] = in[static_cast<size_t>(gy) * w_in + gx];
  }
  __syncthreads();

  const int x = threadIdx.x + 1;
  const int ox = ox0 + threadIdx.x;
  if (ox >= w_out) return;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int y = threadIdx.y + r * TY + 1;
    const int oy = oy0 + y - 1;
    if (oy >= h_out) break;
    const float c = tile[y][x];
    const float n = tile[y - 1][x];
    const float s = tile[y + 1][x];
    const float w = tile[y][x - 1];
    const float e = tile[y][x + 1];
    out[static_cast<size_t>(oy) * w_out + ox] = 0.2f * ((((c + n) + s) + w) + e);
  }
}

}  // namespace

// C entry point (bound with ctypes). Returns cudaGetLastError() right after
// the launch; 0 means the launch was accepted.
extern "C" int mapple_stencil_f32(const void* in, void* out, int batch, int h_in, int w_in,
                                  int h_out, int w_out, int offset, void* stream) {
  const dim3 block(TX, TY);
  const dim3 grid((w_out + TILE_W - 1) / TILE_W, (h_out + TILE_H - 1) / TILE_H, batch);
  stencil_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), h_in, w_in, h_out, w_out,
      offset);
  return static_cast<int>(cudaGetLastError());
}
