// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11): the counter-based generator that draws the stochastic-rounding
// bits of the port's optimizers. Shared by philox.cu (the fill kernel that
// LeafNoise.bits launches) and fused_adamw.cu (which draws its bits in the
// kernel, so they never pass through device memory).
//
// The stream of a leaf: key = (seed & 0xffffffff, seed >> 32) for its 64-bit
// seed; element i takes word i % 4 of the block j = i / 4, whose counter is
// (j & 0xffffffff, j >> 32, 0, 0). The same element gets the same word
// whoever draws it, so the fill kernel, the fused kernel and the plain
// version kernels/philox.py::philox_bits_ref agree bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;   // round multipliers
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;   // key bumps (Weyl)
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      key.x += kW0;
      key.y += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    const uint32_t hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
  }
  return ctr;
}

// The four words of block j.
__device__ __forceinline__ uint4 philox_block(uint2 key, long long j) {
  const unsigned long long u = static_cast<unsigned long long>(j);
  return philox4x32_10(make_uint4(static_cast<uint32_t>(u), static_cast<uint32_t>(u >> 32),
                                  0u, 0u), key);
}

__device__ __forceinline__ uint32_t word(const uint4& b, int k) {
  return k == 0 ? b.x : k == 1 ? b.y : k == 2 ? b.z : b.w;
}

// The word of element i (one generator call for one element).
__device__ __forceinline__ uint32_t philox_word(uint2 key, long long i) {
  return word(philox_block(key, i >> 2), static_cast<int>(i & 3));
}

// The words of elements i0 .. i0+7: two generator calls when i0 is a
// multiple of 4, three otherwise.
__device__ __forceinline__ void philox_words8(uint2 key, long long i0, uint32_t (&out)[8]) {
  const long long j = i0 >> 2;
  const int r = static_cast<int>(i0 & 3);
  const uint4 a = philox_block(key, j), b = philox_block(key, j + 1);
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  if (r == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k] = w[k];
    return;
  }
  const uint4 c = philox_block(key, j + 2);
  const uint32_t w12[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
#pragma unroll
  for (int k = 0; k < 8; ++k)        // indices known at compile time in each arm
    out[k] = r == 1 ? w12[k + 1] : r == 2 ? w12[k + 2] : w12[k + 3];
}

}  // namespace repro
