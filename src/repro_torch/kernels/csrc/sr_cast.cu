// Stochastic-rounding cast f32 -> bf16 from explicit random bits.
//
// Replaces the Pallas kernel repro/kernels/sr_cast.py:26 (sr_cast_kernel) and
// its wrapper :46 (sr_cast): out = truncate16(bits(x) + (r & 0xFFFF)) with r
// the caller's u32 bits (carried in an int32 tensor), the nearest cast for a
// non-finite x. It is the optimizer's SR write (UpdateOps.q_sr onto bf16).
//
// What bounds it on an H100: bytes. Each element reads 4 bytes of x and 4 of
// bits and writes 2, with a handful of integer ops: 10 bytes per element
// against 3.35 TB/s. The design is the plainest one that streams: one element
// per thread per iteration of a grid-stride loop over the flat tensor of any
// length (the tail needs no padding, unlike the TPU wrapper's (rows, 128)
// copy), neighbouring threads on neighbouring addresses. Drawing the bits
// inside the kernel (Philox) would drop 4 of the 10 bytes; that is later work.
//
// Plain C entry point, loaded with ctypes: launches on the caller's stream,
// allocates nothing, returns cudaGetLastError().
#include "bf16_update.cuh"

namespace {

__global__ void __launch_bounds__(repro::kThreads)
sr_cast_kernel(const float* __restrict__ x, const uint32_t* __restrict__ bits,
               __nv_bfloat16* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride)
    out[i] = repro::sr(x[i], bits[i]);
}

}  // namespace

extern "C" int repro_sr_cast(const void* x, const void* bits, void* out, long long n,
                             void* stream) {
  if (n <= 0) return 0;
  sr_cast_kernel<<<repro::blocks_for(n), repro::kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(bits),
      static_cast<__nv_bfloat16*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
