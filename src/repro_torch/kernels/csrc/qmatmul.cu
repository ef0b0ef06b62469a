// bf16 FMAC matmul: (M,K) bf16 @ (K,N) bf16 -> (M,N) bf16, f32 accumulation,
// one output rounding (nearest, or stochastic from caller bits).
//
// Replaces the Pallas kernel repro/kernels/qmatmul.py:22 (qmatmul_kernel) and
// its wrapper :46 (qmatmul): the paper's Table-1 compute unit. The TPU kernel
// carries an f32 VMEM tile (acc_ref) across the sequential k axis of its grid
// and adds one K tile's f32 dot into it per step (qmatmul.py:26-31). Hopper's
// blocks run in no order, so here a block owns whole 128x128 output tiles and
// loops over K itself, its f32 accumulators in registers the whole time.
//
// Two paths, chosen from the shape's N and K and the operands' alignment only
// (never from M; repro_qmatmul_path below, mirrored by kernels/qmatmul.py::plan):
//
// * "wgmma" (K and N multiples of 8; x, y and bits 16-byte aligned): a
//   persistent grid of one block per SM walking 128x128 output tiles (16 row
//   tiles per column sweep, so the operands a wave reads stay in the L2).
//   Each block is 3 warpgroups. One producer thread issues TMA loads (x as
//   128-row x 64 boxes, K-major; y as 128-deep x 64-wide boxes, N-major;
//   both 128-byte swizzled, out-of-range rows and columns zero-filled) into
//   a 3-stage ring of 128-deep K stages (64 KB each) guarded by full/empty
//   mbarriers, and under SR prefetches each tile's bits into the L2. Two
//   consumer warpgroups, each owning 64 rows of the tile, run
//   wgmma.m64n128k16 from shared memory (B transposed in its descriptor).
//   The epilogue rounds the tile into shared memory (128-byte swizzled, no
//   bank conflicts) and writes it with TMA stores, which clip the ragged
//   edge and drain while the next tile's loop runs; the producer runs ahead
//   into the next tile's loads meanwhile. The tensor maps are built on the
//   host per call (cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint, so the library needs no -lcuda) and passed as
//   __grid_constant__ parameters.
// * "mma.sync" (every other shape): the first Hopper body of this kernel,
//   mma.sync m16n8k16 fed by ldmatrix from a 4-stage cp.async ring, one
//   128x128 tile per block, with scalar load paths for an x or y that
//   cannot be read 16 bytes at a time.
//
// Accumulation mirrors the TPU kernel's `acc += dot(x_tile, y_tile)`. The
// tensor cores do not add like IEEE f32: they align a group's exact products
// to the largest exponent and truncate, so a long chain of MMAs drifts toward
// zero by up to an f32 ulp of the running sum per instruction. Each K stage's
// dot is therefore summed by a short chain from zero and promoted into the
// running f32 accumulator with one round-to-nearest add (__fadd_rn): every 128
// of K on the wgmma path (8 chained k16 instructions, as DeepGEMM promotes),
// every 32 on the mma.sync path; both stay within the reference's K tile of
// 512. The long sum over K is a chain of correctly rounded f32 adds like the
// plain version's. No choice depends on M and nothing splits K, so row i of
// the product is the same bits for every M.
//
// Epilogue: __float2bfloat16_rn, or repro::sr() from bf16_update.cuh with the
// caller's bits (loaded 8 bytes per thread, a warp covering whole 32-byte
// sectors); a non-finite value takes the nearest cast, and raw + 0xFFFF on the
// largest finite values carries into inf, as in the reference.
//
// What bounds it on an H100: operations at the training shapes (2MNK against
// 989 TFLOP/s dense bf16; (4096,2048)@(2048,11008) is 184.7 GFLOP, 0.187 ms),
// bytes at the 8-row serving shape (y's 45 MB against 3.35 TB/s, 0.013 ms).
// At 8 rows the 128-wide N tiles of N = 11008 give 86 tiles, 86 of the 132
// SMs: a narrower tile or a split of K chosen for few rows would make a row's
// bits depend on M, which the row-independence rule forbids. The consumer
// warpgroup whose 64 rows all lie past M skips its MMAs.
//
// The f32-result entry (repro_qmatmul_f32; nearest only, no bits) runs the
// same paths with the same K chain and writes the f32 accumulators instead
// of rounding them, so rounding its result to bf16 gives repro_qmatmul's
// output bit for bit, and its rows too are independent of M. It is the
// row-parallel partial product of tensor parallelism (dist/axes.py): the
// model group's f32 partials are summed and rounded once, as the
// reference's all-reduce of f32 partials does. The wgmma path writes the
// f32 tile straight from the accumulator registers (8 bytes a store, a
// warp's store covering whole 32-byte sectors): staging it would take 64 KB
// of shared memory, which the 3-stage ring leaves no room for. Bytes bound
// it at the serving shapes as they bound the bf16 entry, plus the f32
// output's 4 bytes per element.
//
// Plain C entry points, loaded with ctypes: launch on the caller's stream,
// allocate nothing, return the CUDA error.
#include <cuda.h>

#include "bf16_update.cuh"

namespace edge {


constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;                     // 8 warps: 2 along M x 4 along N
constexpr int kWM = 64, kWN = 32;                 // one warp's output tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;      // m16n8 tiles per warp: 4 x 4
constexpr int kStages = 4;
constexpr int kAPitch = kBK + 8;                  // bf16 per A row in shared memory (80 B)
constexpr int kBPitch = kBN + 8;                  // bf16 per B row (272 B)
constexpr int kAStage = kBM * kAPitch;
constexpr int kBStage = kBK * kBPitch;
constexpr int kSmemBytes = kStages * (kAStage + kBStage) * 2;   // 75,776

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// d += a @ b for one m16n8k16 tile, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One K tile of x (rows m0.., columns k0..) into an A stage: 128 rows x 32.
template <bool VEC>
__device__ __forceinline__ void load_a(__nv_bfloat16* sa, const __nv_bfloat16* x,
                                       long long M, long long K, long long m0,
                                       long long k0) {
  const int t = threadIdx.x;
  if (VEC) {                                       // 512 chunks of 8, 2 per thread
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = t + i * kThreads, row = c >> 2, col = (c & 3) * 8;
      const long long gm = m0 + row, gk = k0 + col;
      const bool ok = gm < M && gk < K;
      cp_async16(sa + row * kAPitch + col, ok ? x + gm * K + gk : x, ok);
    }
  } else {                                         // 4096 elements, 16 per thread
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const int e = t + i * kThreads, row = e >> 5, col = e & 31;
      const long long gm = m0 + row, gk = k0 + col;
      sa[row * kAPitch + col] =
          gm < M && gk < K ? x[gm * K + gk] : __ushort_as_bfloat16(0);
    }
  }
}

// One K tile of y (rows k0.., columns n0..) into a B stage: 32 rows x 128.
template <bool VEC>
__device__ __forceinline__ void load_b(__nv_bfloat16* sb, const __nv_bfloat16* y,
                                       long long N, long long K, long long k0,
                                       long long n0) {
  const int t = threadIdx.x;
  if (VEC) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = t + i * kThreads, row = c >> 4, col = (c & 15) * 8;
      const long long gk = k0 + row, gn = n0 + col;
      const bool ok = gk < K && gn < N;
      cp_async16(sb + row * kBPitch + col, ok ? y + gk * N + gn : y, ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const int e = t + i * kThreads, row = e >> 7, col = e & 127;
      const long long gk = k0 + row, gn = n0 + col;
      sb[row * kBPitch + col] =
          gk < K && gn < N ? y[gk * N + gn] : __ushort_as_bfloat16(0);
    }
  }
}

template <bool A_VEC, bool B_VEC, bool SR, bool F32>
__global__ void __launch_bounds__(kThreads)
qmatmul_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
               const uint32_t* __restrict__ bits, void* __restrict__ out,
               long long M, long long N, long long K) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const sb = sa + kStages * kAStage;

  const long long m0 = static_cast<long long>(blockIdx.y) * kBM;
  const long long n0 = static_cast<long long>(blockIdx.x) * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * kWM, wn = (warp & 3) * kWN;
  const int n_k = static_cast<int>((K + kBK - 1) / kBK);

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  auto load = [&](int kt) {
    const int s = kt % kStages;
    load_a<A_VEC>(sa + s * kAStage, x, M, K, m0, static_cast<long long>(kt) * kBK);
    load_b<B_VEC>(sb + s * kBStage, y, N, K, static_cast<long long>(kt) * kBK, n0);
  };

#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < n_k) load(kt);
    cp_async_commit();
  }

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();                  // tile kt has landed (this thread)
    __syncthreads();                               // ... for every thread; slot kt-1 is free
    if (kt + kStages - 1 < n_k) load(kt + kStages - 1);
    cp_async_commit();

    const __nv_bfloat16* const ta = sa + (kt % kStages) * kAStage;
    const __nv_bfloat16* const tb = sb + (kt % kStages) * kBStage;
    uint32_t a[2][kMT][4], b[2][kNT][2];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldmatrix_x4(a[ks][i], ta + (wm + i * 16 + (lane & 15)) * kAPitch + ks * 16 +
                                  (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, tb + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kBPitch +
                                 wn + j * 8 + (lane >> 4) * 8);
        b[ks][j][0] = r[0];
        b[ks][j][1] = r[1];
        b[ks][j + 1][0] = r[2];
        b[ks][j + 1][1] = r[3];
      }
    }
    // the tile's dot from zero, then one rounded f32 add into the accumulator
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(d, a[0][i], b[0][j]);
        mma_bf16(d, a[1][i], b[1][j]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = __fadd_rn(acc[i][j][r], d[r]);
      }
  }

  // epilogue: accumulator element r of tile (i, j) sits at row lane/4 (+8 for
  // r >= 2), column 2*(lane%4) + r%2
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long row = m0 + wm + i * 16 + (lane >> 2) + (r >> 1) * 8;
        const long long col = n0 + wn + j * 8 + (lane & 3) * 2 + (r & 1);
        if (row < M && col < N) {
          const long long o = row * N + col;
          if constexpr (F32)
            static_cast<float*>(out)[o] = acc[i][j][r];
          else
            static_cast<__nv_bfloat16*>(out)[o] =
                SR ? repro::sr(acc[i][j][r], bits[o]) : repro::bf(acc[i][j][r]);
        }
      }
}

template <bool A_VEC, bool B_VEC, bool SR, bool F32>
int launch(const void* x, const void* y, const void* bits, void* out, long long M,
           long long N, long long K, cudaStream_t stream) {
  auto* kernel = qmatmul_kernel<A_VEC, B_VEC, SR, F32>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid(static_cast<unsigned>((N + kBN - 1) / kBN),
                  static_cast<unsigned>((M + kBM - 1) / kBM));
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y),
      static_cast<const uint32_t*>(bits), out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// the output: f32 accumulators (f32), else bf16 rounded nearest or with bits
template <bool A_VEC, bool B_VEC>
int launch_rounding(const void* x, const void* y, const void* bits, void* out, long long M,
                    long long N, long long K, bool f32, cudaStream_t stream) {
  if (f32) return launch<A_VEC, B_VEC, false, true>(x, y, nullptr, out, M, N, K, stream);
  return bits ? launch<A_VEC, B_VEC, true, false>(x, y, bits, out, M, N, K, stream)
              : launch<A_VEC, B_VEC, false, false>(x, y, bits, out, M, N, K, stream);
}

}  // namespace edge

namespace wg {

constexpr int kBM = 128, kBN = 128;
constexpr int kStageK = 128;                  // K per stage = per promotion
constexpr int kBoxK = 64;                     // one 128-byte swizzle row of bf16
constexpr int kStages = 3;
constexpr int kThreads = 384;                 // consumer warpgroups 0-1, producer 2
constexpr int kBoxBytes = 128 * 128;          // a 128 x 64 bf16 box: 16 KB
constexpr int kStageBytes = 4 * kBoxBytes;    // x: two K halves; y: two N halves
constexpr int kOutBoxBytes = 64 * 128;         // a 64 x 64 bf16 output box: 8 KB
constexpr int kSmemBytes =                     // + 1 KB to align the ring, the barriers
    1024 + kStages * kStageBytes + 4 * kOutBoxBytes + 2 * kStages * 8;
constexpr int kGroupM = 16;                   // row tiles walked per column sweep

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// two u32 from global memory, issued where it stands: a read-only load
// (__ldg) may be hoisted above the K loop, where its registers would spill
__device__ __forceinline__ uint2 load_pair(const uint32_t* p) {
  uint2 v;
  asm volatile("ld.global.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}

// barrier `id` over the 128 threads of one warpgroup
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// waits for the phase of parity `parity` to complete; a wait of ~2^34 cycles
// (seconds, where a stage takes microseconds) means a broken ring, and traps
// rather than hang the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// one 2-D TMA box (c0 innermost) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// one 2-D TMA box at (c0, c1) of the map's tensor into the L2
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map, int c0, int c1) {
  asm volatile("cp.async.bulk.prefetch.tensor.2d.L2.global.tile [%0, {%1, %2}];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1) : "memory");
}

// one 2-D TMA box from shared memory to (c0, c1) of the map's tensor; the
// parts outside the tensor are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// d (+)= A @ B for a 64x128x16 slab: A K-major, B N-major (transposed)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = A @ B for a 64x128x16 slab, the first of a chain: d is written only,
// so its registers are dead between chains (the SR epilogue reuses them)
__device__ __forceinline__ void wgmma_m64n128k16_first(float (&d)[64], uint64_t da,
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// keeps the compiler from moving reads or writes of d across a wgmma fence
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// tile t -> (row tile, column tile): kGroupM row tiles, column by column
__device__ __forceinline__ void tile_coords(int t, int num_m, int num_n, int& tm, int& tn) {
  const int per_group = kGroupM * num_n;
  const int first = (t / per_group) * kGroupM;
  const int rows = min(num_m - first, kGroupM);
  const int r = t % per_group;
  tm = first + r % rows;
  tn = r / rows;
}

template <bool SR, bool F32>
__global__ void __launch_bounds__(kThreads, 1)
qmatmul_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap y_map,
                     const __grid_constant__ CUtensorMap out_map,
                     const __grid_constant__ CUtensorMap bits_map,
                     const uint32_t* __restrict__ bits, float* __restrict__ out32, int M,
                     int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;   // swizzle atoms: 1 KB
  const uint32_t full = base + kStages * kStageBytes + 4 * kOutBoxBytes;
  const uint32_t empty = full + kStages * 8;
  const int num_m = (M + kBM - 1) / kBM, num_n = (N + kBN - 1) / kBN;
  const int n_tiles = num_m * num_n;
  const int n_k = (K + kStageK - 1) / kStageK;
  const int group = threadIdx.x / 128;     // warpgroup

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);        // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (group == 2) {                       // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int tm, tn;
        tile_coords(t, num_m, num_n, tm, tn);
        if constexpr (SR) {           // the tile's bits into the L2 for its epilogue
#pragma unroll
          for (int c = 0; c < kBN; c += 32) tma_prefetch(&bits_map, tn * kBN + c, tm * kBM);
        }
        for (int kt = 0; kt < n_k; ++kt) {
          mbar_wait(empty + 8 * s, phase ^ 1);
          const uint32_t bar = full + 8 * s, st = base + s * kStageBytes;
          mbar_expect_tx(bar, kStageBytes);
          const int k0 = kt * kStageK;
          tma_load(st, &x_map, bar, k0, tm * kBM);
          tma_load(st + kBoxBytes, &x_map, bar, k0 + kBoxK, tm * kBM);
          tma_load(st + 2 * kBoxBytes, &y_map, bar, tn * kBN, k0);
          tma_load(st + 3 * kBoxBytes, &y_map, bar, tn * kBN + 64, k0);
          if (++s == kStages) { s = 0; phase ^= 1; }
        }
      }
    }
  } else {                                // consumers: rows 64 * group .. + 63 of a tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const uint32_t staged = base + kStages * kStageBytes + group * 2 * kOutBoxBytes;
    int s = 0;
    uint32_t phase = 0;
    float d[64], acc[64];
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int tm, tn;
      tile_coords(t, num_m, num_n, tm, tn);
      const int row0 = tm * kBM + group * 64;
      const bool live = row0 < M;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      for (int kt = 0; kt < n_k; ++kt) {
        mbar_wait(full + 8 * s, phase);
        if (live) {
          const uint32_t st = base + s * kStageBytes;
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < kStageK / 16; ++kk) {
            const uint64_t da = desc(st + (kk / 4) * kBoxBytes + group * 64 * 128 + (kk % 4) * 32,
                                     16, 1024);
            const uint64_t db = desc(st + 2 * kBoxBytes + kk * 16 * 128, kBoxBytes, 1024);
            if (kk == 0)
              wgmma_m64n128k16_first(d, da, db);
            else
              wgmma_m64n128k16(d, da, db, 1);
          }
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          fence_operands(d);
        }
        if (lane == 0) mbar_arrive(empty + 8 * s);
        if (live) {
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
        }
        if (++s == kStages) { s = 0; phase ^= 1; }
      }
      if (!live) continue;
      if constexpr (F32) {
        // the f32 tile from the registers: accumulator elements 4j + 2 half
        // and + 1 are adjacent columns of one row (N is a multiple of 8 on
        // this path, so the pair lies wholly inside or outside the matrix)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row0 + 16 * warp + lane / 4 + 8 * half;
          if (row >= M) continue;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = tn * kBN + 8 * j + 2 * (lane % 4);
            if (col < N)
              *reinterpret_cast<float2*>(out32 + static_cast<long long>(row) * N + col) =
                  make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
          }
        }
        continue;
      }
      // epilogue: the rounded tile through shared memory (two 64x64 boxes
      // per warpgroup, 128-byte swizzled, so the writes meet no bank
      // conflict) to one TMA store per box, which clips rows past M and
      // columns past N; the store drains while the next tile's loop runs.
      // Accumulator element 4j + r sits at row 16 warp + lane/4 (+8 for
      // r >= 2) of the warpgroup's 64, column 8j + 2 (lane % 4) + r % 2.
      const bool leader = threadIdx.x % 128 == 0;
      if (leader) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      named_sync(1 + group);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * warp + lane / 4 + 8 * half;
        // SR bits of this row's 32 outputs (in the L2 since the tile began:
        // the producer prefetched them), 8 bytes a load, a warp's load
        // covering whole 32-byte sectors, all issued before the first is used
        uint2 b[SR ? 16 : 1];
        if constexpr (SR) {
          const int row = row0 + r;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = tn * kBN + 8 * j + 2 * (lane % 4);
            const long long o = static_cast<long long>(row) * N + col;
            b[j] = row < M && col < N ? load_pair(bits + o) : make_uint2(0, 0);
          }
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
          __nv_bfloat162 pair;
          if constexpr (SR) {
            pair.x = repro::sr(v0, b[j].x);
            pair.y = repro::sr(v1, b[j].y);
          } else {
            pair.x = repro::bf(v0);
            pair.y = repro::bf(v1);
          }
          const uint32_t at = staged + (j / 8) * kOutBoxBytes + r * 128 +
                              (((j % 8) ^ (r % 8)) << 4) + 4 * (lane % 4);
          asm volatile("st.shared.b32 [%0], %1;\n"
                       :: "r"(at), "r"(*reinterpret_cast<uint32_t*>(&pair)) : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(1 + group);
      if (leader) {
        tma_store(&out_map, staged, tn * kBN, row0);
        tma_store(&out_map, staged + kOutBoxBytes, tn * kBN + 64, row0);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a row-major (rows, cols) matrix of 2-byte (bf16) or 4-byte (u32) elements
// moved in boxes 128 bytes wide and box_rows tall; bf16 boxes are 128-byte
// swizzled (the wgmma layout), u32 boxes (bits, prefetched only) are not
bool make_map(CUtensorMap* map, const void* ptr, long long rows, long long cols,
              cuuint32_t box_rows, int elem_bytes) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes), box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const bool bf16 = elem_bytes == 2;
  EncodeTiled encode = encoder();
  return encode &&
         encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT32, 2,
                const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool SR, bool F32>
int launch(const void* x, const void* y, const void* bits, void* out, long long M,
           long long N, long long K, cudaStream_t stream) {
  auto* kernel = qmatmul_wgmma_kernel<SR, F32>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap x_map, y_map, out_map = {}, bits_map = {};
  if (!make_map(&x_map, x, M, K, 128, 2) || !make_map(&y_map, y, K, N, 128, 2) ||
      (!F32 && !make_map(&out_map, out, M, N, 64, 2)) ||
      (SR && !make_map(&bits_map, bits, M, N, 128, 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      x_map, y_map, out_map, bits_map, static_cast<const uint32_t*>(bits),
      F32 ? static_cast<float*>(out) : nullptr, static_cast<int>(M), static_cast<int>(N),
      static_cast<int>(K));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

namespace {

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// 1: the wgmma/TMA path; 0: the mma.sync path. N, K and alignment only.
int choose_path(const void* x, const void* y, const void* bits, long long N, long long K) {
  return K > 0 && K % 8 == 0 && N % 8 == 0 && aligned(x, 16) && aligned(y, 16) &&
         (bits == nullptr || aligned(bits, 16));
}

}  // namespace

// The path repro_qmatmul takes for these operands: 1 wgmma, 0 mma.sync.
extern "C" int repro_qmatmul_path(const void* x, const void* y, const void* bits,
                                  long long M, long long N, long long K) {
  (void)M;
  return choose_path(x, y, bits, N, K);
}

namespace {

// the mma.sync path on any operands (16-byte loads where alignment allows)
int run_sync(const void* x, const void* y, const void* bits, void* out, long long M,
             long long N, long long K, bool f32, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if ((M + edge::kBM - 1) / edge::kBM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool a_vec = K % 8 == 0 && aligned(x, 16);
  const bool b_vec = N % 8 == 0 && aligned(y, 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using namespace edge;
  if (a_vec)
    return b_vec ? launch_rounding<true, true>(x, y, bits, out, M, N, K, f32, s)
                 : launch_rounding<true, false>(x, y, bits, out, M, N, K, f32, s);
  return b_vec ? launch_rounding<false, true>(x, y, bits, out, M, N, K, f32, s)
               : launch_rounding<false, false>(x, y, bits, out, M, N, K, f32, s);
}

// the path choose_path picks; f32: the accumulators, else the rounded bf16
int run(const void* x, const void* y, const void* bits, void* out, long long M, long long N,
        long long K, bool f32, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if ((M + edge::kBM - 1) / edge::kBM > 65535 || N >= (1LL << 31) || K >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!choose_path(x, y, bits, N, K)) return run_sync(x, y, bits, out, M, N, K, f32, stream);
  if (!aligned(out, 16)) return static_cast<int>(cudaErrorInvalidValue);  // allocated aligned
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) return wg::launch<false, true>(x, y, nullptr, out, M, N, K, s);
  return bits ? wg::launch<true, false>(x, y, bits, out, M, N, K, s)
              : wg::launch<false, false>(x, y, bits, out, M, N, K, s);
}

}  // namespace

// The mma.sync path on any operands, to time it beside the wgmma path on
// the same inputs.
extern "C" int repro_qmatmul_sync(const void* x, const void* y, const void* bits, void* out,
                                  long long M, long long N, long long K, void* stream) {
  return run_sync(x, y, bits, out, M, N, K, false, stream);
}

// x (M,K) and y (K,N) bf16 row-major, bits (M,N) u32 or null (nearest),
// out (M,N) bf16. Any M, N, K >= 0; M up to 65535 * 128 rows, and M, N, K
// below 2^31.
extern "C" int repro_qmatmul(const void* x, const void* y, const void* bits, void* out,
                             long long M, long long N, long long K, void* stream) {
  return run(x, y, bits, out, M, N, K, false, stream);
}

// The f32-result entry: out (M,N) f32, the accumulators repro_qmatmul
// rounds (nearest; no bits). The same limits.
extern "C" int repro_qmatmul_f32(const void* x, const void* y, void* out, long long M,
                                 long long N, long long K, void* stream) {
  return run(x, y, nullptr, out, M, N, K, true, stream);
}

// The f32-result entry on the mma.sync path, beside repro_qmatmul_sync.
extern "C" int repro_qmatmul_f32_sync(const void* x, const void* y, void* out, long long M,
                                      long long N, long long K, void* stream) {
  return run_sync(x, y, nullptr, out, M, N, K, true, stream);
}
