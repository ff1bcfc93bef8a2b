// Causal (optionally sliding-window) flash attention for Hopper (sm_90a),
// bf16 inputs, on the tensor cores (mma.sync), fp32 online softmax.
//
// Replaces: src/repro/kernels/flash_attention.py `flash_attention_pallas`
// (body `_flash_kernel`) for bf16 inputs, reached from models/layers.py
// `attention(use_pallas=True)` through kernels/ops.py `flash_attention`:
// the prefill attention of the dense decoder and of Hymba. The fp32 inputs
// stay on flash_attention.cu (CUDA cores, full fp32).
//
//   s = (q . k) * scale, accumulated in fp32 from bf16 operands, masked to
//   -1e30 where k > q (causal) or q - k >= window; running max m and
//   denominator l in fp32 (l sums the fp32 p); p = exp(s - m) rounded to
//   bf16 before the PV product (as the Pallas kernel casts p to v's dtype);
//   out = acc / max(l, 1e-30), cast to bf16.
//
// The mask stays the finite -1e30 of the reference, not -inf: a row whose
// first tile is wholly masked takes m = -1e30 and p = 1 on it, and the
// first valid score wipes that exactly (exp2(-1e30 - m) == 0); with -inf
// the difference -inf - -inf would be NaN. The exponent is taken as exp2
// with scale * log2(e) folded into the scores, which is the same function.
//
// What bounds it on this card: 4*d operations per (query, key) pair that
// the mask lets through (q.k and p.v) against 2 bytes of q, k, v and out
// per row element: at S = 2048 that is hundreds of operations per byte, so
// the bound is the tensor cores' bf16 rate (989 TFLOP/s). The kernel it
// replaces widened bf16 to fp32 and ran both products as scalar FMAs on
// the CUDA cores (at best the 67 TFLOP/s fp32 rate), sent p through shared
// memory behind a third barrier, and loaded K and V without overlap.
//
// Design (FlashAttention-2's forward on mma.sync):
//   * one block of 4 warps per (batch*head, 64-query tile); each warp owns
//     16 query rows, the m of one m16n8k16 product. 16 rows and not 32:
//     at d = 128 the warp already holds 64 fp32 accumulators of O, 32 of S
//     and 32 registers of Q fragments, and 32 rows would double the first
//     and the last past what a thread can hold without spilling; 64-query
//     blocks also give 3200 blocks at the hymba-1.5b prefill, 24 waves of
//     the card, so the causal tail is short;
//     ptxas gives the kernel 167 registers at d = 64 (3 blocks an SM) and
//     238 at d = 128, with no spills; capping d = 64 at 128 registers, for
//     4 blocks an SM, spills;
//   * the Q tile is fragmented once into registers with ldmatrix;
//   * 64-key K/V tiles stream through a 2-stage shared-memory ring filled
//     by 16-byte cp.async: tile t+1 is in flight while tile t is
//     multiplied, with one __syncthreads per tile (it both publishes tile
//     t and frees the stage that t+1 overwrites);
//   * the shared rows are skewed by 16 bytes (row stride d + 8 elements),
//     not XOR-swizzled: an ldmatrix phase reads one 16-byte chunk from 8
//     consecutive rows, and with a row stride of d/8 + 1 chunks, odd for
//     every d in {16, ..., 128}, those 8 chunks fall on 8 distinct
//     16-byte bank groups, so the reads do not conflict in banks. An XOR
//     swizzle needs the row to be a whole number of 8-chunk groups, which
//     d = 16, 32, 48, 80, 96 and 112 are not;
//   * S = Q K^T and O += P V both run mma.sync.m16n8k16 (bf16 in, fp32
//     accumulate); K is read with ldmatrix, V with ldmatrix.trans, each
//     step's fragments loaded one step ahead of its products;
//   * P stays in registers: the fp32 C fragment of S, packed to bf16
//     pairs, is exactly the A fragment of the PV product;
//   * row max and row sum reduce over the 4 lanes of a quad with
//     __shfl_xor_sync (the sum only once, at the end);
//   * masking runs only on tiles that cross the diagonal, the window's
//     left edge or the ragged end of S; tiles wholly above the diagonal,
//     or wholly left of the window, are never loaded;
//   * the ragged tile's missing key rows are zero-filled (cp.async with a
//     source size of 0) and masked, and missing query rows are not stored;
//   * query tiles are launched longest first (causal: the last tile first,
//     grid.y reversed, grid.x over batch*head) so the last wave is short.
// The kernel reads q, k, v and writes out through element strides; the
// wrapper hands it operands whose data pointer is 16-byte aligned and whose
// batch, seq and head strides are multiples of 8 elements (it copies any
// other), as cp.async and ldmatrix need 16-byte aligned rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per tile
constexpr int WARPS = 4;               // 16 query rows each
constexpr int THREADS = 32 * WARPS;
constexpr int NB = BK / 8;             // n8 blocks of S per tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

struct Strides {     // element strides of (batch, seq, head); the last dim is contiguous
  int64_t b, s, h;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (source size 0).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr) : "memory");
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16, the first in the low half (the lower
// column of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__host__ __device__ constexpr int row_stride() { return D + 8; }  // d plus a 16-byte skew

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {  // Q tile + 2 stages of K and V
  return sizeof(bf16) * static_cast<size_t>(BQ + 4 * BK) * row_stride<D>();
}

// Copy rows [row0, row0 + 64) of one head (row stride `ld_g` elements) into
// a shared tile, zero-filling rows at or past S.
template <int D>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* g, int64_t ld_g, int row0,
                                          int S, int tid) {
  constexpr int CH = D / 8;                      // 16-byte chunks per row
  constexpr int LD = row_stride<D>();
#pragma unroll
  for (int i = 0; i < (64 * CH) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / CH;
    const int ch = c % CH;
    const int s = row0 + r;
    const bool ok = s < S;
    const bf16* src = g + static_cast<int64_t>(ok ? s : 0) * ld_g + ch * 8;
    cp_async_16(smem_addr(tile + r * LD + ch * 8), src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, Strides qs, Strides ks,
                  Strides vs, Strides os, int S, int H, int group, float scale_log2,
                  int window, int causal) {
  constexpr int LD = row_stride<D>();
  constexpr int KD = D / 16;                     // k16 steps of Q K^T
  constexpr int ND = D / 8;                      // n8 blocks of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* sK = sQ + BQ * LD;                       // [2][BK][LD]
  bf16* sV = sK + 2 * BK * LD;                   // [2][BK][LD]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;                        // row of the fragment (and row + 8)
  const int tig = lane % 4;                      // column pair of the fragment
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tile_q = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile_q * BQ;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + (h / group) * ks.h;
  const bf16* vb = v + b * vs.b + (h / group) * vs.h;

  const int k_end = causal ? min(S, q0 + BQ) : S;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_first = k_first / BK;
  const int n_tiles = (k_end + BK - 1) / BK - t_first;

  load_tile<D>(sQ, qb, qs.s, q0, S, tid);
  load_tile<D>(sK, kb, ks.s, t_first * BK, S, tid);
  load_tile<D>(sV, vb, vs.s, t_first * BK, S, tid);
  cp_async_commit();

  uint32_t qf[KD][4];                            // A fragments of this warp's 16 rows
  float acc[ND][4];                              // O, C fragments
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};               // rows g and g + 8, in log2 units
  float l[2] = {0.f, 0.f};                       // this thread's part of the row sums

  // Shared byte addresses of this lane's ldmatrix rows. Q (x4): rows
  // warp*16 + {0-7, 8-15, 0-7, 8-15}, dims {0-7, 0-7, 8-15, 8-15} of a k16
  // step. K (x4): keys {0-7, 0-7, 8-15, 8-15}, dims {0-7, 8-15, 0-7, 8-15}
  // of a (k16 step, 16-key pair); V (x4.trans): keys {0-7, 8-15, 0-7, 8-15},
  // dims {0-7, 0-7, 8-15, 8-15} of a (16-key step, 16-dim pair).
  constexpr uint32_t ROW = LD * sizeof(bf16);
  const uint32_t q_lane = smem_addr(sQ) + (warp * 16 + lane % 16) * ROW + (lane / 16) * 16;
  const uint32_t k_lane = smem_addr(sK) + ((lane / 16) * 8 + lane % 8) * ROW +
                          ((lane / 8) % 2) * 16;
  const uint32_t v_lane = smem_addr(sV) + (((lane / 8) % 2) * 8 + lane % 8) * ROW +
                          (lane / 16) * 16;
  constexpr uint32_t STAGE = BK * ROW;           // bytes of one K or V stage
  constexpr int NQK = KD * (NB / 2);             // (k16 step, key pair) steps of Q K^T
  constexpr int NPV = (BK / 16) * (ND / 2);      // (key step, dim pair) steps of P V

  const int row_lo = q0 + warp * 16 + g;         // query position of fragment rows
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();   // tile it is in for every thread; tile it-1's stage is free
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldmatrix_x4(q_lane + kk * 32, qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
    }
    const int k0 = (t_first + it) * BK;
    if (it + 1 < n_tiles) {
      const int nxt = (it + 1) & 1;
      load_tile<D>(sK + nxt * BK * LD, kb, ks.s, k0 + BK, S, tid);
      load_tile<D>(sV + nxt * BK * LD, vb, vs.s, k0 + BK, S, tid);
      cp_async_commit();
    }
    const uint32_t tK = k_lane + (it & 1) * STAGE;
    const uint32_t tV = v_lane + (it & 1) * STAGE;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys; each
    // step's K fragments are loaded one step ahead.
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    uint32_t kf[2][4];
    ldmatrix_x4(tK, kf[0][0], kf[0][1], kf[0][2], kf[0][3]);
#pragma unroll
    for (int i = 0; i < NQK; ++i) {
      const int kk = i / (NB / 2), np = i % (NB / 2);
      if (i + 1 < NQK) {
        const int kn = (i + 1) / (NB / 2), nn = (i + 1) % (NB / 2);
        uint32_t(&f)[4] = kf[(i + 1) & 1];
        ldmatrix_x4(tK + nn * 16 * ROW + kn * 32, f[0], f[1], f[2], f[3]);
      }
      mma_bf16(s[2 * np], qf[kk], kf[i & 1][0], kf[i & 1][1]);
      mma_bf16(s[2 * np + 1], qf[kk], kf[i & 1][2], kf[i & 1][3]);
    }

    // Scale (in log2 units) and mask; only tiles that cross an edge mask.
    const bool need_mask = k0 + BK > S || (causal && k0 + BK - 1 > q0) ||
                           (window > 0 && q0 + BQ - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (need_mask) {
          const int qp = row_lo + (e >= 2 ? 8 : 0);
          const int kp = k0 + j * 8 + tig * 2 + (e & 1);
          bool ok = kp < S;
          if (causal) ok = ok && qp >= kp;
          if (window > 0) ok = ok && qp - kp < window;
          x = ok ? x : NEG_INF;
        }
        s[j][e] = x;
      }

    // Online softmax over the quad's 64 scores of rows g and g + 8.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NB; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float p0 = exp2f(s[j][2 * r] - m_new);
        const float p1 = exp2f(s[j][2 * r + 1] - m_new);
        s[j][2 * r] = p0;
        s[j][2 * r + 1] = p1;
        rs += p0 + p1;
      }
      l[r] = l[r] * alpha + rs;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }

    // P's C fragments, rounded to bf16, are the A fragments of P V.
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt) {
      pa[kt][0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
      pa[kt][1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
      pa[kt][2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      pa[kt][3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
    }

    // O += P V; each step's V fragments are loaded one step ahead.
    uint32_t vf[2][4];
    ldmatrix_x4_trans(tV, vf[0][0], vf[0][1], vf[0][2], vf[0][3]);
#pragma unroll
    for (int i = 0; i < NPV; ++i) {
      const int kt = i / (ND / 2), dp = i % (ND / 2);
      if (i + 1 < NPV) {
        const int kn = (i + 1) / (ND / 2), dn = (i + 1) % (ND / 2);
        uint32_t(&f)[4] = vf[(i + 1) & 1];
        ldmatrix_x4_trans(tV + kn * 16 * ROW + dn * 32, f[0], f[1], f[2], f[3]);
      }
      mma_bf16(acc[2 * dp], pa[kt], vf[i & 1][0], vf[i & 1][1]);
      mma_bf16(acc[2 * dp + 1], pa[kt], vf[i & 1][2], vf[i & 1][3]);
    }
  }

  // Row sums over the quad, then out = acc / max(l, 1e-30) in bf16.
  bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    const int sp = row_lo + 8 * r;
    if (sp >= S) continue;
    bf16* orow = ob + static_cast<int64_t>(sp) * os.s + tig * 2;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_bf16(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
  }
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, const int64_t* st, int B,
             int S, int H, int Kv, float scale, int window, int causal, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_bf16_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), qs, ks, vs, os, S, H, H / Kv, scale * LOG2E, window, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (bound with ctypes). q (B, S, H, d), k/v (B, S, Kv, d) and
// o (B, S, H, d) bf16 are addressed through `strides`, 12 int64 element
// strides (batch, seq, head) of q, k, v and o in that order; the last dim is
// contiguous, every data pointer 16-byte aligned and every stride a multiple
// of 8 elements. d is a multiple of 16 up to 128 and H a multiple of Kv; the
// wrapper checks all of it. Returns cudaGetLastError() right after the
// launch (or the attribute call's error); 0 means the launch was accepted.
extern "C" int mapple_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                           const void* strides, int B, int S, int H, int Kv,
                                           int d, float scale, int window, int causal,
                                           void* stream_ptr) {
  const int64_t* st = static_cast<const int64_t*>(strides);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (d) {
    case 16: return launch_d<16>(q, k, v, o, st, B, S, H, Kv, scale, window, causal, stream);
    case 32: return launch_d<32>(q, k, v, o, st, B, S, H, Kv, scale, window, causal, stream);
    case 48: return launch_d<48>(q, k, v, o, st, B, S, H, Kv, scale, window, causal, stream);
    case 64: return launch_d<64>(q, k, v, o, st, B, S, H, Kv, scale, window, causal, stream);
    case 80: return launch_d<80>(q, k, v, o, st, B, S, H, Kv, scale, window, causal, stream);
    case 96: return launch_d<96>(q, k, v, o, st, B, S, H, Kv, scale, window, causal, stream);
    case 112: return launch_d<112>(q, k, v, o, st, B, S, H, Kv, scale, window, causal, stream);
    case 128: return launch_d<128>(q, k, v, o, st, B, S, H, Kv, scale, window, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
