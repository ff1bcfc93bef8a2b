// Causal (optionally sliding-window) flash attention for Hopper (sm_90a),
// fp32 inputs, fp32 online softmax on the CUDA cores. bf16 inputs take
// flash_attention_bf16.cu (tensor cores).
//
// Replaces: src/repro/kernels/flash_attention.py `flash_attention_pallas`
// (body `_flash_kernel`) for fp32 inputs, reached from models/layers.py
// `attention(use_pallas=True)` through kernels/ops.py `flash_attention`:
// the prefill attention of the dense decoder, of Hymba and of the MoE
// decoder.
//
//   s = (q . k) * scale, masked to -1e30 where k > q (causal) or
//   q - k >= window; running max m and denominator l in fp32;
//   p = exp(s - m); acc = acc * exp(m_prev - m) + p @ v;
//   out = acc / max(l, 1e-30).
//
// The mask stays the finite -1e30 of the reference, not -inf: a row whose
// first tile is wholly masked takes m = -1e30 and p = 1 on it, and the
// first valid score wipes that exactly (exp2(-1e30 - m) == 0); with -inf
// the difference -inf - -inf would be NaN. The exponent is taken as exp2
// (the MUFU's ex2) with scale * log2(e) folded into the scores, which is
// the same function.
//
// What bounds it on this card: 4*d operations per (query, key) pair that
// the mask lets through (q.k and p.v), against 4 bytes of q, k, v and out
// per row element: far above one operation per byte at S = 2048, so the
// bound is the CUDA cores' fp32 rate (67 TFLOP/s). fp32 stays in full fp32
// (TF32 breaks the 1e-4 checks), so the tensor cores are not an option,
// and the kernel's job is the SGEMM's: keep the FMA pipes fed. The kernel
// it replaces read shared memory as 32-bit scalars (one read per two FMAs,
// which caps the FMA pipes near half their rate), padded rows by one float
// (no 16-byte reads), loaded K and V synchronously and transposed between
// two barriers, evaluated the mask on every tile, and launched the short
// causal query tiles first.
//
// Design (the register-blocked SGEMM discipline, twice a tile):
//   * one block of 256 threads (16 x 16) per (batch*head, query tile):
//     128 queries at d <= 64, 64 at d > 64, so that Q, two K/V stages and P
//     fit in shared memory (135 KB at d = 64, 182 KB at d = 128); 64-key
//     tiles;
//   * Q, K and V stay row-major in shared memory, rows padded by 4 floats
//     (a row of d/4 + 1 16-byte chunks, odd for every d here), so that 16
//     lanes reading float4s of 16 consecutive rows touch 16 distinct bank
//     groups;
//   * S = Q K^T: thread (ty, tx) owns queries ty + 16i (8 or 4 of them)
//     and keys tx + 16j (4 of them), and for each 4-deep step of d reads
//     one float4 of each: 12 LDS.128 for 128 FMAs at d = 64 (the two ty of
//     a warp read two addresses of Q, broadcast);
//   * P goes to shared memory transposed (key-major, by the thread's own
//     row index), written and read by one warp only, so a __syncwarp and
//     no block barrier separates them. O += P V: each thread owns its
//     queries' rows and d/16 columns (float4, float2 or scalar vectors of
//     consecutive columns by d), and per key reads its rows of P as
//     float4s and its columns of V: 3 LDS.128 for 32 FMAs at d = 64;
//   * K/V tiles stream through a ring of two stages filled by 16-byte
//     cp.async: tile t+1 lands while tile t is multiplied, with one
//     __syncthreads a tile (it publishes tile t and frees the stage t+1
//     overwrites);
//   * masks on edge tiles only: the diagonal tile, the window's left edge
//     and the ragged end of S compare positions; tiles wholly inside the
//     band skip the comparisons. Tiles wholly above the diagonal, or
//     wholly left of the window, are never loaded;
//   * row max reduces over the 16 tx lanes with __shfl_xor_sync each tile;
//     the row sum stays per thread and reduces once, at the end; the PV
//     loop over a tile's 64 keys is unrolled whole (4% off the hymba-1.5b
//     prefill's time, as is ex2 in place of exp2f);
//   * the heaviest (last) causal query tiles launch first (grid.y reversed,
//     grid.x over batch*head), so the last wave is short;
//   * the ragged tile's missing rows are zero-filled (cp.async with a
//     source size of 0) and masked, and missing queries are not stored.
// GQA without a repeat: query head h reads KV head h / (H / Kv). The kernel
// reads q, k, v and writes out through element strides, so the model
// layout (B, S, heads, d) needs no copy; cp.async needs 16-byte aligned
// rows, so the wrapper hands it operands whose data pointer is 16-byte
// aligned and whose batch, seq and head strides are multiples of 4 (it
// copies any other).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int TX = 16;                 // lanes along keys and output columns
constexpr int TY = 16;                 // lanes along queries
constexpr int THREADS = TX * TY;
constexpr int BK = 64;                 // keys a tile
constexpr int KJ = BK / TX;            // keys a thread: tx + 16j
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {     // element strides of (batch, seq, head); the last dim is contiguous
  int64_t b, s, h;
};

template <int D>
struct Tile {
  static constexpr int BQ = D <= 64 ? 128 : 64;   // queries a block
  static constexpr int RI = BQ / TY;              // queries a thread: ty + 16i
  static constexpr int C = D / TX;                // output columns a thread
  static constexpr int VEC = C % 4 == 0 ? 4 : C % 2 == 0 ? 2 : 1;
  static constexpr int NV = C / VEC;              // column vectors a thread: tx + 16v
  static constexpr int LD = D + 4;                // padded row of Q, K and V
  static constexpr int LDP = BQ + 4;              // padded row of P^T
  static constexpr size_t SMEM =
      sizeof(float) * (static_cast<size_t>(BQ) * LD + 4 * BK * LD + BK * LDP);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (source size 0).
__device__ __forceinline__ void cp_async_16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 2^x on the MUFU: relative error about 2^-22, and a result below 2^-126
// flushes to 0 (such a p or alpha is at least 126 binary orders below the
// row's running max, so dropping it moves no sum). exp2f would add a
// range reduction around the same instruction.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void load_vec(float (&dst)[N], const float* src) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x; dst[1] = x.y;
  } else {
    dst[0] = *src;
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* dst, const float* src) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2], src[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  } else {
    *dst = src[0];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, Strides qs, Strides ks,
                 Strides vs, Strides os, int S, int H, int group, float scale_log2, int window,
                 int causal) {
  using T = Tile<D>;
  constexpr int BQ = T::BQ, RI = T::RI, C = T::C, VEC = T::VEC, LD = T::LD, LDP = T::LDP;
  constexpr int CH = D / 4;                        // 16-byte chunks a row
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                                // [BQ][LD]
  float* sKV = sQ + BQ * LD;                       // [stage][K, V][BK][LD]
  float* sPt = sKV + 4 * BK * LD;                  // [BK][LDP], P^T by local row

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + (h / group) * ks.h;
  const float* vb = v + b * vs.b + (h / group) * vs.h;

  for (int e = tid; e < BQ * CH; e += THREADS) {
    const int r = e / CH, c = e % CH, s = q0 + r;
    cp_async_16(sQ + r * LD + 4 * c, qb + (s < S ? s * qs.s + 4 * c : 0), s < S);
  }
  const auto load_kv = [&](int k0, int stage) {
    float* sK = sKV + stage * 2 * BK * LD;
    float* sV = sK + BK * LD;
    for (int e = tid; e < BK * CH; e += THREADS) {
      const int r = e / CH, c = e % CH, s = k0 + r;
      const bool in = s < S;
      cp_async_16(sK + r * LD + 4 * c, kb + (in ? s * ks.s + 4 * c : 0), in);
      cp_async_16(sV + r * LD + 4 * c, vb + (in ? s * vs.s + 4 * c : 0), in);
    }
    cp_async_commit();
  };

  const int k_end = causal ? min(S, q0 + BQ) : S;
  const int t_first = (window > 0 ? max(0, q0 - window + 1) : 0) / BK;
  const int n_tiles = (k_end + BK - 1) / BK - t_first;
  load_kv(t_first * BK, 0);                        // one group: Q and the first K/V tile

  float acc[RI][C], m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const float* q_rows = sQ + ty * LD;              // + i * TY * LD
  float* p_mine = sPt + ty * RI;                   // this thread's rows of P^T
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = (t_first + t) * BK;
    cp_async_wait_all();
    __syncthreads();                               // tile t is in; tile t-1's stage is free
    if (t + 1 < n_tiles) load_kv(k0 + BK, (t + 1) & 1);
    const float* sK = sKV + (t & 1) * 2 * BK * LD;
    const float* sV = sK + BK * LD;

    // S = Q K^T for queries ty + 16i, keys tx + 16j.
    float sc[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) sc[i][j] = 0.f;
    const float* k_rows = sK + tx * LD;            // + j * TX * LD
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      float4 qv[RI], kv[KJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = *reinterpret_cast<const float4*>(q_rows + i * TY * LD + c);
#pragma unroll
      for (int j = 0; j < KJ; ++j) kv[j] = *reinterpret_cast<const float4*>(k_rows + j * TX * LD + c);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          float s = fmaf(qv[i].x, kv[j].x, sc[i][j]);
          s = fmaf(qv[i].y, kv[j].y, s);
          s = fmaf(qv[i].z, kv[j].z, s);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, s);
        }
    }

    // Scale into the exp2 domain; mask only a tile that crosses the
    // diagonal, the window's left edge or the end of S.
    const bool edge = (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && q0 + BQ - 1 - k0 >= window) || k0 + BK > S;
    if (edge) {
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int qp = q0 + ty + TY * i;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const int kp = k0 + tx + TX * j;
          bool ok = kp < S;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && qp - kp < window;
          sc[i][j] = ok ? sc[i][j] * scale_log2 : NEG_INF;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) sc[i][j] *= scale_log2;
    }

    // Online softmax; P^T to shared memory (this warp's rows only).
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = sc[i][0];
#pragma unroll
      for (int j = 1; j < KJ; ++j) mx = fmaxf(mx, sc[i][j]);
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = ex2(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        sc[i][j] = ex2(sc[i][j] - m_new);
        rs += sc[i][j];
      }
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < KJ; ++j)
#pragma unroll
      for (int i = 0; i < RI; i += 4)
        *reinterpret_cast<float4*>(p_mine + (tx + TX * j) * LDP + i) =
            make_float4(sc[i][j], sc[i + 1][j], sc[i + 2][j], sc[i + 3][j]);
    __syncwarp();

    // O += P V for this thread's rows and columns (tx + 16v) * VEC + e.
    const float* v_cols = sV + tx * VEC;           // + v * TX * VEC
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float p[RI];
#pragma unroll
      for (int i = 0; i < RI; i += 4) {
        const float4 x = *reinterpret_cast<const float4*>(p_mine + kk * LDP + i);
        p[i] = x.x; p[i + 1] = x.y; p[i + 2] = x.z; p[i + 3] = x.w;
      }
      float vv[T::NV][VEC];
#pragma unroll
      for (int vi = 0; vi < T::NV; ++vi) load_vec(vv[vi], v_cols + kk * LD + vi * TX * VEC);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(p[i], vv[c / VEC][c % VEC], acc[i][c]);
    }
  }

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    float denom = l[i];
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) denom += __shfl_xor_sync(0xffffffffu, denom, off);
    denom = fmaxf(denom, 1e-30f);
    const int s = q0 + ty + TY * i;
    if (s >= S) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] /= denom;
#pragma unroll
    for (int vi = 0; vi < T::NV; ++vi)
      store_vec<VEC>(ob + s * os.s + (tx + TX * vi) * VEC, &acc[i][vi * VEC]);
  }
}

template <int D>
int launch_d(const float* q, const float* k, const float* v, float* o, const int64_t* st, int B,
             int S, int H, int Kv, float scale, int window, int causal, cudaStream_t stream) {
  using T = Tile<D>;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (!aligned(q) || !aligned(k) || !aligned(v) || !aligned(o))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 12; ++i)
    if (st[i] % 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]};
  const Strides vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid(B * H, (S + T::BQ - 1) / T::BQ);
  flash_f32_kernel<D><<<grid, THREADS, T::SMEM, stream>>>(q, k, v, o, qs, ks, vs, os, S, H,
                                                          H / Kv, scale * LOG2E, window, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (bound with ctypes). q (B, S, H, d), k/v (B, S, Kv, d) and
// o (B, S, H, d) fp32 are addressed through `strides`, 12 int64 element strides
// (batch, seq, head) of q, k, v and o in that order; the last dim is
// contiguous. d is a multiple of 16 up to 128 and H a multiple of Kv; the
// wrapper checks both, and hands over 16-byte aligned data pointers and
// strides that are multiples of 4 (cudaErrorInvalidValue otherwise).
// Returns cudaGetLastError() right after the launch (or the attribute
// call's error); 0 means the launch was accepted.
extern "C" int mapple_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                          const void* strides, int B, int S, int H, int Kv,
                                          int d, float scale, int window, int causal,
                                          void* stream_ptr) {
  const auto* st = static_cast<const int64_t*>(strides);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (d) {
    case 16: return launch_d<16>(qf, kf, vf, of, st, B, S, H, Kv, scale, window, causal, stream);
    case 32: return launch_d<32>(qf, kf, vf, of, st, B, S, H, Kv, scale, window, causal, stream);
    case 48: return launch_d<48>(qf, kf, vf, of, st, B, S, H, Kv, scale, window, causal, stream);
    case 64: return launch_d<64>(qf, kf, vf, of, st, B, S, H, Kv, scale, window, causal, stream);
    case 80: return launch_d<80>(qf, kf, vf, of, st, B, S, H, Kv, scale, window, causal, stream);
    case 96: return launch_d<96>(qf, kf, vf, of, st, B, S, H, Kv, scale, window, causal, stream);
    case 112: return launch_d<112>(qf, kf, vf, of, st, B, S, H, Kv, scale, window, causal, stream);
    case 128: return launch_d<128>(qf, kf, vf, of, st, B, S, H, Kv, scale, window, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
