// bf16 FMAC matmul: (M,K) bf16 @ (K,N) bf16 -> (M,N) bf16, f32 accumulation,
// one output rounding (nearest, or stochastic from caller bits).
//
// Replaces the Pallas kernel repro/kernels/qmatmul.py:22 (qmatmul_kernel) and
// its wrapper :46 (qmatmul): the paper's Table-1 compute unit. The TPU kernel
// carries an f32 VMEM tile (acc_ref) across the sequential k axis of its grid
// and adds one K tile's f32 dot into it per step (qmatmul.py:26-31). Hopper's
// blocks run in no order, so here one block owns a 128x128 output tile and
// loops over K itself, its f32 accumulators in registers the whole time.
//
// The products run on the tensor cores: mma.sync m16n8k16 bf16 x bf16 -> f32,
// fed by ldmatrix (A, row-major) and ldmatrix.trans (B: y is (K,N) row-major,
// the MMA wants it column-major) from a 4-stage cp.async ring of 128x32 A and
// 32x128 B tiles (rows padded by 16 bytes, so ldmatrix meets no bank
// conflict). 8 warps, 2 along M x 4 along N, each own a 64x32 sub-tile.
//
// Accumulation mirrors the TPU kernel's `acc += dot(x_tile, y_tile)`: each
// 32-deep K tile is summed by two chained MMAs from zero, then added to the
// running accumulator with one round-to-nearest f32 add (__fadd_rn). The
// tensor cores do not add like IEEE f32: they align a group's exact products
// to the largest exponent and truncate, so a long MMA chain drifts toward zero
// by up to an f32 ulp of the running sum per instruction. Promoting each tile
// bounds that truncation by the tile's own partial sum, and the long sum over
// K is a chain of correctly rounded f32 adds like the plain version's.
//
// Edges: every shape is taken. Out-of-range rows, columns and K are
// zero-filled (cp.async with src-size 0, or a guarded scalar load), so padded
// K adds nothing; stores are masked. The 16-byte cp.async path needs K
// (for x) or N (for y) a multiple of 8 and a 16-byte-aligned base; otherwise
// that operand takes a scalar load path. Epilogue: __float2bfloat16_rn, or
// repro::sr() from bf16_update.cuh (a non-finite value takes the nearest cast;
// raw + 0xFFFF on the largest finite values carries into inf, as in the
// reference).
//
// What bounds it on an H100: operations at the training shapes (2MNK against
// 989 TFLOP/s dense bf16; (4096,2048)@(2048,11008) is 184.7 GFLOP, 0.187 ms),
// bytes at the 8-row serving shape (y's 45 MB against 3.35 TB/s, 0.013 ms;
// 120 of a tile's 128 rows are then empty and cost MMAs, not bytes). mma.sync
// reaches only part of the tensor cores' rate. Left for later: wgmma from
// shared memory with TMA loads and mbarriers, a persistent grid with an
// overlapped epilogue, split-K for the few-row shapes, and SR bits drawn in
// the kernel (Philox) instead of read (4 bytes per output).
//
// Plain C entry point, loaded with ctypes: launches on the caller's stream,
// allocates nothing, returns the CUDA error.
#include "bf16_update.cuh"

namespace {

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

template <bool A_VEC, bool B_VEC, bool SR>
__global__ void __launch_bounds__(kThreads)
qmatmul_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
               const uint32_t* __restrict__ bits, __nv_bfloat16* __restrict__ out,
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
          out[o] = SR ? repro::sr(acc[i][j][r], bits[o]) : repro::bf(acc[i][j][r]);
        }
      }
}

template <bool A_VEC, bool B_VEC, bool SR>
int launch(const void* x, const void* y, const void* bits, void* out, long long M,
           long long N, long long K, cudaStream_t stream) {
  auto* kernel = qmatmul_kernel<A_VEC, B_VEC, SR>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (configured != cudaSuccess) return static_cast<int>(configured);
  const dim3 grid(static_cast<unsigned>((N + kBN - 1) / kBN),
                  static_cast<unsigned>((M + kBM - 1) / kBM));
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y),
      static_cast<const uint32_t*>(bits), static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <bool A_VEC, bool B_VEC>
int launch_rounding(const void* x, const void* y, const void* bits, void* out, long long M,
                    long long N, long long K, cudaStream_t stream) {
  return bits ? launch<A_VEC, B_VEC, true>(x, y, bits, out, M, N, K, stream)
              : launch<A_VEC, B_VEC, false>(x, y, bits, out, M, N, K, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x (M,K) and y (K,N) bf16 row-major, bits (M,N) u32 or null (nearest),
// out (M,N) bf16. Any M, N, K >= 0; M up to 65535 * 128 rows.
extern "C" int repro_qmatmul(const void* x, const void* y, const void* bits, void* out,
                             long long M, long long N, long long K, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if ((M + kBM - 1) / kBM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool a_vec = K % 8 == 0 && aligned16(x);
  const bool b_vec = N % 8 == 0 && aligned16(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_vec)
    return b_vec ? launch_rounding<true, true>(x, y, bits, out, M, N, K, s)
                 : launch_rounding<true, false>(x, y, bits, out, M, N, K, s);
  return b_vec ? launch_rounding<false, true>(x, y, bits, out, M, N, K, s)
               : launch_rounding<false, false>(x, y, bits, out, M, N, K, s);
}
