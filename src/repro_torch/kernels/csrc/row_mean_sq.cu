// Mean of squares of each row of a (rows, D) matrix, in an order that
// depends on D only: the f32 reduction of RMSNorm in the serve step.
//
// It replaces no TPU kernel: the reference takes jnp.mean(jnp.square(x))
// over d_model (repro/core/qarith.py, rmsnorm) and leaves the reduction to
// XLA. On the card torch.mean picks its block shape, and so the order in
// which it sums a row, from the number of rows, so a row's variance, and
// every bit after it, could depend on how many rows a step carries. Here
// one warp owns one row: lane l sums x[l]^2, x[l+32]^2, ... in ascending
// order with round-to-nearest f32 adds, then the 32 lane sums meet in a
// butterfly (xor 16, 8, 4, 2, 1), and the row sum is divided by D. Nothing
// of that depends on the number of rows, and row_mean_sq.py::row_mean_sq_ref
// sums in the same order, bit for bit.
//
// What bounds it on an H100: bytes (x read once, 4 bytes a row written) at
// 2 flops an element; at the serve step's 8 to 256 rows of 2048 it is a few
// microseconds of launch and latency. Every product and add is spelled with
// __fmul_rn / __fadd_rn, so nvcc contracts nothing into an FMA.
//
// Plain C entry point, loaded with ctypes: launches on the caller's stream,
// allocates nothing, returns the launch's CUDA error.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                  // rows per block

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
row_mean_sq_kernel(const T* __restrict__ x, float* __restrict__ out, long long rows, int D) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;                 // the whole warp: one row per warp
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float v = to_f32(xr[d]);
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, s));
  if (lane == 0) out[row] = __fdiv_rn(acc, static_cast<float>(D));
}

}  // namespace

// dtype: 0 = bf16 x, 1 = f32 x. x (rows, D) row-major; out (rows,) f32.
extern "C" int repro_row_mean_sq(const void* x, float* out, long long rows, int D,
                                 int dtype, void* stream) {
  if (rows <= 0) return 0;
  if (D < 1 || (dtype != 0 && dtype != 1) || (rows + kWarps - 1) / kWarps > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    row_mean_sq_kernel<__nv_bfloat16><<<blocks, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), out, rows, D);
  else
    row_mean_sq_kernel<float><<<blocks, kWarps * 32, 0, s>>>(static_cast<const float*>(x),
                                                            out, rows, D);
  return static_cast<int>(cudaGetLastError());
}
