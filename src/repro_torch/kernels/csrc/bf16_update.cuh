// Shared by sr_cast.cu, fused_adamw.cu and fused_sgd.cu: the bf16 roundings
// of the paper's 16-bit-FPU update (Algorithms 2-5), written so that each f32
// operation rounds exactly once.
//
// nvcc contracts a*b + c into one FMA by default, which skips the rounding of
// the product and lands an f32 ulp away from the reference's separate
// multiply and add. Every arithmetic step is therefore spelled with the
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn), which nvcc never contracts; with them a kernel equals its
// plain PyTorch version bit for bit. Never build these with --use_fast_math.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 32;   // 132 SMs, grid-stride beyond

__device__ __forceinline__ float f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// f32 -> bf16, round to nearest even (NaN stays NaN)
__device__ __forceinline__ __nv_bfloat16 bf(float x) { return __float2bfloat16_rn(x); }

// one FPU output rounded to bf16 and read back into the f32 accumulator
__device__ __forceinline__ float q(float x) { return f32(bf(x)); }

// f32 -> bf16 with stochastic rounding from explicit bits: add the low 16
// bits of `bits` to the raw f32 bits and truncate the low 16 (a finite value
// just below max may carry into inf, as in the reference); a non-finite
// input takes the nearest cast (repro/kernels/sr_cast.py:26-33).
__device__ __forceinline__ __nv_bfloat16 sr(float x, uint32_t bits) {
  if (!isfinite(x)) return bf(x);
  const uint32_t r = (__float_as_uint(x) + (bits & 0xFFFFu)) & 0xFFFF0000u;
  return __ushort_as_bfloat16(static_cast<unsigned short>(r >> 16));
}

// The weight update shared by AdamW and SGD, given the rounded update u:
// w <- w - u (Alg. 2/4), or with Kahan compensation c (Alg. 3/5):
//   y = bf(bf(-u) - c); s = round(w + y); c = bf(bf(s - w) - y).
// The rounding of w - u (or of w + y) is stochastic under SR, from `bits`.
// On values: w_out (and c_out under KAHAN) from w, u and c as f32.
template <bool SR, bool KAHAN>
__device__ __forceinline__ void weight_step(float wf, float u, float cf, uint32_t bits,
                                            __nv_bfloat16& w_out, __nv_bfloat16& c_out) {
  if (!KAHAN) {
    const float step = __fsub_rn(wf, u);
    w_out = SR ? sr(step, bits) : bf(step);
    return;
  }
  const float y = q(__fsub_rn(q(-u), cf));
  const float s_val = __fadd_rn(wf, y);
  const __nv_bfloat16 s = SR ? sr(s_val, bits) : bf(s_val);
  w_out = s;
  c_out = bf(__fsub_rn(q(__fsub_rn(f32(s), wf)), y));
}

// weight_step on element i of w (and c), its bits read from bits[i].
template <bool SR, bool KAHAN>
__device__ __forceinline__ void update_weight(__nv_bfloat16* w, __nv_bfloat16* c,
                                              const uint32_t* bits, long long i,
                                              float wf, float u) {
  __nv_bfloat16 c_out;
  weight_step<SR, KAHAN>(wf, u, KAHAN ? f32(c[i]) : 0.f, SR ? bits[i] : 0u, w[i], c_out);
  if (KAHAN) c[i] = c_out;
}

inline int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace repro
