// The stochastic-rounding bits of one parameter leaf, drawn with
// Philox4x32-10 (philox.cuh) into an int32 tensor carrying u32.
//
// It replaces no TPU kernel: the reference draws its SR bits with
// jax.random.bits from a key split per leaf (repro/optim/base.py), and the
// TPU draws them inside its kernels from its own generator. This fill is what
// LeafNoise.bits launches for the non-fused optimizers (bits -> sr_cast) and
// fused SGD; fused AdamW draws the same words inside its own kernel.
//
// What bounds it on an H100: bytes, 4 per element written, against ~25
// integer instructions per element of generator (10 rounds of two 32x32
// products and three xors per four words), far under the issue rate. Each
// thread makes one block of four words and writes it as one 16-byte store
// (4-byte stores for the ragged end, or when the output is not 16-byte
// aligned), grid-stride over the blocks.
//
// Plain C entry point, loaded with ctypes: launches on the caller's stream,
// allocates nothing, returns the launch's CUDA error.
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
philox_bits_kernel(uint32_t* __restrict__ out, long long n, uint2 key, bool vec) {
  const long long blocks = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < blocks; j += stride) {
    const uint4 b = repro::philox_block(key, j);
    if (vec && 4 * j + 3 < n) {
      reinterpret_cast<uint4*>(out)[j] = b;
    } else {
      for (int k = 0; k < 4 && 4 * j + k < n; ++k) out[4 * j + k] = repro::word(b, k);
    }
  }
}

}  // namespace

extern "C" int repro_philox_bits(void* out, long long n, unsigned int key_lo,
                                 unsigned int key_hi, void* stream) {
  if (n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = ((n + 3) / 4 + kThreads - 1) / kThreads;
  const long long cap = 8LL * sms;                // 8 blocks of 256 threads per SM
  const int grid = static_cast<int>(need < cap ? need : cap);
  const bool vec = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  philox_bits_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), n, make_uint2(key_lo, key_hi), vec);
  return static_cast<int>(cudaGetLastError());
}
