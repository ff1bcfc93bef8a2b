// Batched matrix product for Hopper (sm_90a): C[b] = A[b] @ B[b], fp32
// accumulation, output in A's dtype.
//
// Replaces: src/repro/kernels/matmul.py `matmul_pallas` (body `_matmul_kernel`),
// the TPU kernel behind every rank's block product in the six distributed
// matmul apps (`matmul/common.py` `local_matmul(use_kernel=True)`), in
// fp32 (`sgemm_kernel`) and bf16 (`hgemm_kernel`).
//
// What bounds it on this card: at the apps' block shapes (2048 x 2048 x 2048
// per rank, 4 or 8 ranks) the work is 2*M*N*K operations over (MK+KN+MN)
// elements, several hundred operations per byte: far above the card's
// ridge, so arithmetic bounds it. fp32 inputs must stay full fp32 (the
// tests hold them to 1e-4, which TF32 breaks), so the fp32 bound is the
// CUDA cores' FMA rate (67 TFLOP/s on H100 SXM), and the kernel's job is to
// keep the FMA pipes fed: few shared-memory instructions per FMA, global
// latency hidden behind the arithmetic, few barriers. The first kernel here
// read shared memory as 32-bit scalars (16 loads per 64 FMAs), took two
// barriers per 16-deep slice and never overlapped its global loads with the
// FMAs: about 22 TFLOP/s at 4 x 2048^3. bf16 is the tensor cores' type:
// its bound is 989 TFLOP/s, which only `wgmma` reaches. The first bf16
// kernel widened bf16 to fp32 in shared memory and ran the same CUDA-core
// micro-tile, 34 times slower than its bound.
//
// fp32 design (`sgemm_kernel`), the classic register-blocked SGEMM:
//   * one 256-thread block per 128 x 128 output tile and batch entry
//     (gridDim.z is the batch: the stacked rank dims, so one launch serves
//     every virtual rank); __launch_bounds__(256, 2), so two blocks share
//     an SM (at most 128 registers a thread; ptxas uses 127-128 without
//     spilling). One block an SM and 16-deep slices were tried and ran no
//     faster;
//   * warp tiling: 8 warps of 64 x 32 (2 x 4); a warp's 32 lanes are 8 x 4,
//     and lane (tm, tn) owns an 8 x 8 accumulator, rows wm*64 + tm*4 + {0..3}
//     and + 32, columns wn*32 + tn*4 + {0..3} and + 16: 2 x 2 fragments of
//     4 x 4, so that each k step reads its 8 A and 8 B values with four
//     128-bit shared loads (LDS.128) for 64 FMAs;
//   * A is stored k-major (transposed) in shared memory, As[k][row], rows
//     padded to 132 floats; B row-major, Bs[k][col]. Reads do not conflict
//     in banks: a warp's A read covers 8 consecutive float4s of one k row
//     (128 bytes, lanes with one tm broadcast) and its B read 4 (64
//     bytes). Nor do the stores: thread t writes A's row t/2 at k
//     (t%2)*4 + i, so in a warp 16 consecutive rows land on banks
//     (4i + r) % 32 for k < 4 and (16 + 4i + r) % 32 for k >= 4 (132 = 4
//     mod 32), 32 distinct banks; B rows are stored as contiguous float4s;
//   * K streams in 8-deep slices through a ring of two shared stages. For
//     slice t+1, B goes global -> shared with 16-byte cp.async and A is
//     loaded as one float4 a thread into registers (it is transposed on
//     the way into shared memory); both are issued before slice t's 512
//     FMAs a thread and land after them, so global latency hides behind
//     the arithmetic, with one __syncthreads per slice;
//   * a vectorised fast path (float4 loads, cp.async, float4 stores) when
//     K and N are multiples of 4 and A, B and C are 16-byte aligned (every
//     app shape); otherwise the same kernel loads A and stores C element by
//     element and copies B with 4-byte cp.async. Every load and store is
//     masked (a float4 is wholly in or out when K and N are multiples of
//     4), so any M, N, K works: the TPU kernel asserted even tiling, this
//     kernel's domain is a superset.
// Operands are dense row-major per batch entry: the Python wrapper
// materialises a broadcast (replicated) operand with `.contiguous()`.
//
// bf16 design (`hgemm_kernel`), a warp-specialised wgmma pipeline fed by TMA:
//   * one 384-thread block per 128 x 256 output tile and batch entry: two
//     consumer warpgroups, each owning 64 rows x 256 columns as 128 fp32
//     accumulators a thread (one wgmma.m64n256k16 wide), and one producer
//     warpgroup of which one thread starts the loads. setmaxnreg moves
//     registers from the producer (40) to the consumers (232);
//   * K streams in 64-deep stages through a ring of 4 in shared memory (A
//     128 x 64 and B 64 x 256: 48 KB a stage, 192 KB in all), each with a
//     `full` mbarrier (the TMA's bytes landed) and an `empty` one (both
//     consumers are done with it). The producer runs up to 3 stages ahead;
//   * TMA copies each tile: A as one 128 x 64 box, B as four 64 x 64 boxes,
//     from 3-D tensor maps (columns, rows, batch) with the 128-byte swizzle,
//     encoded on the host at each call (cuTensorMapEncodeTiled looked up
//     through the CUDA runtime, so no -lcuda). A box that runs past the
//     array's edge is zero-filled, so ragged M, N and K need no masks;
//   * A is K-major (its rows are K-contiguous), B is row-major (K, N): for
//     wgmma that is the MN-major, transposed B, which bf16 allows
//     (tnspB = 1), so B needs no transposing copy. The shared-memory
//     descriptors: A, stride 1024 bytes per 8 rows, k16 steps 32 bytes into
//     the swizzled row; B, 1024 bytes per 8 k rows and 8192 between 64-column
//     boxes, k16 steps 2048 bytes;
//   * a consumer keeps one wgmma group in flight: it starts stage t's four
//     k16 products, then waits for stage t-1's and frees that stage;
//   * the epilogue rounds the accumulators to bf16 and stores pairs straight
//     from registers, masked at the M and N edges.
// TMA needs 16-byte aligned bases and strides: the wrapper hands this
// kernel dense operands with K and N multiples of 8 and a 16-byte aligned
// data pointer, zero-padding K and N and slicing C for any other shape
// (no app gives one).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// ------------------------------------------------------------- fp32 SGEMM
constexpr int BM = 128;                       // output tile rows
constexpr int BN = 128;                       // output tile columns
constexpr int THREADS = 256;
constexpr int SG_BK = 8;                       // k depth of a slice
constexpr int SG_LDA = BM + 4;                 // As row: 132 floats (bank skew)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (source size 0).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

// 4 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// VEC: K and N are multiples of 4 and A, B, C 16-byte aligned.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
sgemm_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
             int m, int n, int k) {
  __shared__ __align__(16) float As[2][SG_BK][SG_LDA];   // A slice, k-major: As[kk][row]
  __shared__ __align__(16) float Bs[2][SG_BK][BN];       // B slice: Bs[kk][col]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row_t = (warp / 4) * 64 + (lane / 4) * 4;    // + {0..3}, + 32 + {0..3}
  const int col_t = (warp % 4) * 32 + (lane % 4) * 4;    // + {0..3}, + 16 + {0..3}
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const size_t batch = blockIdx.z;
  a += batch * static_cast<size_t>(m) * k;
  b += batch * static_cast<size_t>(k) * n;
  c += batch * static_cast<size_t>(m) * n;

  // This thread's share of a slice: A row a_r, k a_k..a_k+3 (a warp takes
  // 16 rows x 8 k, whole 32-byte sectors); B k row b_k, columns b_c..b_c+3.
  const int a_r = tid / 2;
  const int a_k = (tid % 2) * 4;
  const int b_k = tid / 32;
  const int b_c = (tid % 32) * 4;
  const int gb_c = col0 + b_c;

  float ra[4];                               // A in flight
  auto fetch = [&](int k0) {                 // slice at k0: A -> registers, B -> cp.async
    const int ga_r = row0 + a_r;
    const float* a_row = a + static_cast<size_t>(ga_r < m ? ga_r : 0) * k;
    const int gk = k0 + a_k;
    if constexpr (VEC) {
      const bool ok = ga_r < m && gk < k;
      const float4 v = ok ? *reinterpret_cast<const float4*>(a_row + gk)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      ra[0] = v.x; ra[1] = v.y; ra[2] = v.z; ra[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) ra[i] = (ga_r < m && gk + i < k) ? a_row[gk + i] : 0.f;
    }
    const int gbk = k0 + b_k;
    float* dst = &Bs[(k0 / SG_BK) & 1][b_k][b_c];
    if constexpr (VEC) {
      const bool ok = gbk < k && gb_c < n;
      cp_async_16(dst, b + (ok ? static_cast<size_t>(gbk) * n + gb_c : 0), ok);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = gbk < k && gb_c + i < n;
        cp_async_4(dst + i, b + (ok ? static_cast<size_t>(gbk) * n + gb_c + i : 0), ok);
      }
    }
    cp_async_commit();
  };
  auto stash = [&](int stage) {              // registers -> shared
#pragma unroll
    for (int i = 0; i < 4; ++i) As[stage][a_k + i][a_r] = ra[i];
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (k + SG_BK - 1) / SG_BK;
  fetch(0);
  stash(0);
  cp_async_wait_all();
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < nk;
    if (more) fetch((t + 1) * SG_BK);        // lands while this slice is multiplied
#pragma unroll
    for (int kk = 0; kk < SG_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][row_t]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][row_t + 32]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][col_t]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][col_t + 16]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) stash(cur ^ 1);
    cp_async_wait_all();
    __syncthreads();   // slice t+1 is in; every thread is done with slice t
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + row_t + (i < 4 ? i : 28 + i);
    if (gr >= m) continue;
    float* crow = c + static_cast<size_t>(gr) * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gc = col0 + col_t + 16 * h;
      if constexpr (VEC) {
        if (gc < n) {
          *reinterpret_cast<float4*>(crow + gc) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gc + j < n) crow[gc + j] = acc[i][4 * h + j];
      }
    }
  }
}

int launch_f32(const float* a, const float* b, float* c, int batch, int m, int n, int k,
               cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, batch);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (k % 4 == 0 && n % 4 == 0 && aligned(a) && aligned(b) && aligned(c)) {
    sgemm_kernel<true><<<grid, THREADS, 0, stream>>>(a, b, c, m, n, k);
  } else {
    sgemm_kernel<false><<<grid, THREADS, 0, stream>>>(a, b, c, m, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// -------------------------------------------------------- bf16 wgmma + TMA
constexpr int HG_BM = 128;                         // output rows: two warpgroups of 64
constexpr int HG_BN = 256;                         // output columns: one m64n256k16 wide
constexpr int HG_BK = 64;                          // k depth of a stage: 128 bytes of bf16
constexpr int HG_STAGES = 4;
constexpr int HG_CONSUMERS = 2;
constexpr int HG_THREADS = 128 * (HG_CONSUMERS + 1);
constexpr int HG_BOX_N = 64;                       // B box width: one 128-byte swizzle row
constexpr int A_STAGE_BYTES = HG_BM * HG_BK * 2;   // 16 KB
constexpr int B_BOX_BYTES = HG_BK * HG_BOX_N * 2;  // 8 KB
constexpr int B_STAGE_BYTES = HG_BK * HG_BN * 2;   // 32 KB
constexpr int STAGE_BYTES = A_STAGE_BYTES + B_STAGE_BYTES;
constexpr int SWIZZLE_ALIGN = 1024;                // the 128-byte swizzle repeats every 8 rows
constexpr int HG_SMEM = HG_STAGES * STAGE_BYTES + 2 * HG_STAGES * 8 + SWIZZLE_ALIGN;

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}

// Spin until the barrier's phase of the given parity has completed. A
// barrier that never completes (a fault in the pipeline) traps after about
// ten seconds instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// One TMA box, global -> shared, completing on `bar`'s transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lead >> 4) << 16 | static_cast<uint64_t>(stride >> 4) << 32 |
         1ull << 62;
}

// d += A (64 x 16, K-major) @ B (16 x 256, MN-major), fp32 accumulators.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16\n"
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},\n"
      " %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pins the accumulators to this point of the program: the compiler may not
// move their reads or writes across it (wgmma writes them asynchronously).
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__global__ void __launch_bounds__(HG_THREADS, 1)
hgemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
             __nv_bfloat16* __restrict__ c, int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (SWIZZLE_ALIGN - smem_addr(smem_raw) % SWIZZLE_ALIGN) % SWIZZLE_ALIGN;
  uint8_t* sa = smem;                                   // [stage][128 rows][64 k], swizzled
  uint8_t* sb = smem + HG_STAGES * A_STAGE_BYTES;       // [stage][4 boxes][64 k][64 cols]
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + HG_STAGES * B_STAGE_BYTES);
  uint64_t* empty = full + HG_STAGES;

  const int wg = threadIdx.x / 128;
  const int n0 = blockIdx.x * HG_BN;
  const int m0 = blockIdx.y * HG_BM;
  const int batch = blockIdx.z;
  const int nk = (k + HG_BK - 1) / HG_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < HG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], HG_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == HG_CONSUMERS) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == HG_CONSUMERS * 128) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % HG_STAGES;
        if (t >= HG_STAGES) mbar_wait(&empty[s], (t / HG_STAGES - 1) & 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load(sa + s * A_STAGE_BYTES, &map_a, &full[s], t * HG_BK, m0, batch);
#pragma unroll
        for (int j = 0; j < HG_BN / HG_BOX_N; ++j)
          tma_load(sb + s * B_STAGE_BYTES + j * B_BOX_BYTES, &map_b, &full[s],
                   n0 + j * HG_BOX_N, t * HG_BK, batch);
      }
    }
  } else {
    // Consumers: warpgroup wg multiplies rows wg*64 .. wg*64+63 of the tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    fence_acc(acc);
    for (int t = 0; t < nk; ++t) {
      const int s = t % HG_STAGES;
      mbar_wait(&full[s], (t / HG_STAGES) & 1);
      const uint8_t* a_tile = sa + s * A_STAGE_BYTES + wg * 64 * 128;
      const uint8_t* b_tile = sb + s * B_STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HG_BK / 16; ++kk)
        wgmma_m64n256k16(acc, smem_desc(a_tile + kk * 32, 16, 1024),
                         smem_desc(b_tile + kk * 16 * 128, B_BOX_BYTES, 1024));
      wgmma_commit();
      wgmma_wait<1>();                                  // stage t-1's products are done
      fence_acc(acc);
      if (t > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(t - 1) % HG_STAGES]);
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // Accumulator i of thread (warp w, lane l): row 16w + l/4 (+8 for i%4 >= 2),
    // column 8*(i/4) + 2*(l%4) + i%2.
    const int wt = threadIdx.x % 128;
    const int row = m0 + wg * 64 + (wt / 32) * 16 + (wt % 32) / 4;
    const int col = n0 + 2 * (wt % 4);
    __nv_bfloat16* cb = c + static_cast<size_t>(batch) * m * n;
#pragma unroll
    for (int i = 0; i < HG_BN / 8; ++i) {
      const int cc = col + 8 * i;
      if (cc >= n) continue;                            // n is even: the pair is in or out
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r < m)
          *reinterpret_cast<__nv_bfloat162*>(cb + static_cast<size_t>(r) * n + cc) =
              __floats2bfloat162_rn(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the CUDA runtime
// (null if it has none).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A 3-D map of `batch` dense row-major (rows, cols) bf16 matrices, read in
// boxes of box_rows x box_cols with the 128-byte swizzle.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int batch, int rows,
              int cols, int box_rows, int box_cols) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows) * cols * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_bf16(const void* a, const void* b, void* c, int batch, int m, int n, int k,
                cudaStream_t stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (k % 8 || n % 8 || !aligned(a) || !aligned(b) || !aligned(c))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_a, map_b;
  if (!make_map(encode, &map_a, a, batch, m, k, HG_BM, HG_BK) ||
      !make_map(encode, &map_b, b, batch, k, n, HG_BK, HG_BOX_N))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      hgemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, HG_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + HG_BN - 1) / HG_BN, (m + HG_BM - 1) / HG_BM, batch);
  hgemm_kernel<<<grid, HG_THREADS, HG_SMEM, stream>>>(map_a, map_b,
                                                     static_cast<__nv_bfloat16*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (bound with ctypes). Each returns cudaGetLastError() right
// after the launch; 0 means the launch was accepted.
extern "C" int mapple_matmul_f32(const void* a, const void* b, void* c, int batch, int m,
                                 int n, int k, void* stream) {
  return launch_f32(static_cast<const float*>(a), static_cast<const float*>(b),
                    static_cast<float*>(c), batch, m, n, k, static_cast<cudaStream_t>(stream));
}

// bf16: K and N multiples of 8 and 16-byte aligned operands (the wrapper
// pads and copies any other); cudaErrorInvalidValue otherwise.
extern "C" int mapple_matmul_bf16(const void* a, const void* b, void* c, int batch, int m,
                                  int n, int k, void* stream) {
  return launch_bf16(a, b, c, batch, m, n, k, static_cast<cudaStream_t>(stream));
}
