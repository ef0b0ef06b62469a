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
// A second entry fills a shard of a leaf (FSDP: a rank's slice of one dim)
// with the leaf stream's words at the shard's global positions: element k of
// the shard lies in run k / run_len (one outer row), at global index
// row * row_stride + first + k % run_len. Each thread makes four consecutive
// elements with one division: when they lie in one run and start a block of
// the stream (every group of a dim-0 shard, and of any shard whose runs and
// start are multiples of 4), one block and one 16-byte store, as the fill's;
// otherwise element by element, drawing a block only when the element's block
// changes, with 4-byte stores.
//
// Plain C entry points, loaded with ctypes: launch on the caller's stream,
// allocate nothing, return the launch's CUDA error.
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

__global__ void __launch_bounds__(kThreads)
philox_slice_kernel(uint32_t* __restrict__ out, long long n, long long run_len,
                    long long row_stride, long long first, uint2 key, bool vec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       4 * q < n; q += stride) {
    const long long k0 = 4 * q;
    long long row = k0 / run_len;
    long long r = k0 - row * run_len;
    const long long g0 = row * row_stride + first + r;
    if (vec && k0 + 3 < n && r + 3 < run_len && (g0 & 3) == 0) {
      reinterpret_cast<uint4*>(out)[q] = repro::philox_block(key, g0 >> 2);
      continue;
    }
    long long have = -1;
    uint4 b = make_uint4(0u, 0u, 0u, 0u);
    for (int t = 0; t < 4 && k0 + t < n; ++t, ++r) {
      if (r == run_len) {
        ++row;
        r = 0;
      }
      const long long g = row * row_stride + first + r;
      if ((g >> 2) != have) {
        have = g >> 2;
        b = repro::philox_block(key, have);
      }
      out[k0 + t] = repro::word(b, static_cast<int>(g & 3));
    }
  }
}

int grid_for(long long n, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = ((n + 3) / 4 + kThreads - 1) / kThreads;
  const long long cap = 8LL * sms;                // 8 blocks of 256 threads per SM
  *grid = static_cast<int>(need < cap ? need : cap);
  return 0;
}

}  // namespace

extern "C" int repro_philox_bits_slice(void* out, long long n, long long run_len,
                                       long long row_stride, long long first,
                                       unsigned int key_lo, unsigned int key_hi,
                                       void* stream) {
  if (n <= 0) return 0;
  if (run_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  const int rc = grid_for(n, &grid);
  if (rc != 0) return rc;
  const bool vec = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  philox_slice_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), n, run_len, row_stride, first, make_uint2(key_lo, key_hi),
      vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_philox_bits(void* out, long long n, unsigned int key_lo,
                                 unsigned int key_hi, void* stream) {
  if (n <= 0) return 0;
  int grid = 0;
  const int rc = grid_for(n, &grid);
  if (rc != 0) return rc;
  const bool vec = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  philox_bits_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), n, make_uint2(key_lo, key_hi), vec);
  return static_cast<int>(cudaGetLastError());
}
