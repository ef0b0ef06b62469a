// Fused AdamW update with nearest or stochastic weight rounding and optional
// Kahan compensation (the paper's Algorithms 4 and 5), in place.
//
// Replaces the Pallas kernel repro/kernels/fused_adamw.py:36
// (fused_adamw_kernel) and its wrapper :90 (fused_adamw). Per element, in the
// reference's op order, every FPU output rounded once to bf16:
//   m = bf(b1*m + (1-b1)*g)          v = bf(b2*v + ((1-b2)*g)*g)
//   m_hat = bf(m / (1-c1))           v_hat = bf(sqrt(v / (1-c2)))
//   u = bf(lr*m_hat / (v_hat+eps) + (lr*wd)*w)
// then w <- w - u (nearest or SR), or the Kahan update of bf16_update.cuh.
// The scalars arrive as f32; 1-b1, 1-b2 and lr*wd are formed here in f32, as
// the TPU kernel does.
//
// What bounds it on an H100: bytes, at a handful of flops per element. It
// reads w, m, v, g (and c) as bf16 and the SR bits as u32, and writes w, m,
// v (and c) back into the same buffers: 22 bytes per element for SR+Kahan
// (14 nearest without Kahan) against 3.35 TB/s. Each element is read and
// then written by the same thread, so updating in place is safe and the
// optimizer never holds a second copy of its state (18.5 GB for full-width
// qwen2.5-3b). One element per thread per step of a grid-stride loop covers
// a flat tensor of any length; the tail needs no padding.
//
// Plain C entry point, loaded with ctypes: launches on the caller's stream,
// allocates nothing, returns cudaGetLastError().
#include "bf16_update.cuh"

namespace {

struct Scalars {
  float lr, b1, b2, eps, wd, om_c1, om_c2;
};

template <bool SR, bool KAHAN>
__global__ void __launch_bounds__(repro::kThreads)
fused_adamw_kernel(__nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ m,
                   __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
                   __nv_bfloat16* __restrict__ c, const uint32_t* __restrict__ bits,
                   long long n, Scalars s) {
  using repro::f32;
  using repro::q;
  const float om_b1 = __fsub_rn(1.0f, s.b1);
  const float om_b2 = __fsub_rn(1.0f, s.b2);
  const float lr_wd = __fmul_rn(s.lr, s.wd);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float wf = f32(w[i]);
    const float gf = f32(g[i]);
    const float m2 = q(__fadd_rn(__fmul_rn(s.b1, f32(m[i])), __fmul_rn(om_b1, gf)));
    const float v2 = q(__fadd_rn(__fmul_rn(s.b2, f32(v[i])),
                                 __fmul_rn(__fmul_rn(om_b2, gf), gf)));
    const float m_hat = q(__fdiv_rn(m2, s.om_c1));
    const float v_hat = q(__fsqrt_rn(__fdiv_rn(v2, s.om_c2)));
    const float u = q(__fadd_rn(__fdiv_rn(__fmul_rn(s.lr, m_hat), __fadd_rn(v_hat, s.eps)),
                                __fmul_rn(lr_wd, wf)));
    m[i] = repro::bf(m2);
    v[i] = repro::bf(v2);
    repro::update_weight<SR, KAHAN>(w, c, bits, i, wf, u);
  }
}

template <bool SR, bool KAHAN>
int launch(void* w, void* m, void* v, const void* g, void* c, const void* bits,
           long long n, Scalars s, cudaStream_t stream) {
  fused_adamw_kernel<SR, KAHAN><<<repro::blocks_for(n), repro::kThreads, 0, stream>>>(
      static_cast<__nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(m),
      static_cast<__nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(g),
      static_cast<__nv_bfloat16*>(c), static_cast<const uint32_t*>(bits), n, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_fused_adamw(void* w, void* m, void* v, const void* g, void* c,
                                 const void* bits, long long n, float lr, float b1,
                                 float b2, float eps, float wd, float om_c1,
                                 float om_c2, int stochastic, int kahan, void* stream) {
  if (n <= 0) return 0;
  if ((stochastic && bits == nullptr) || (kahan && c == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Scalars s{lr, b1, b2, eps, wd, om_c1, om_c2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stochastic)
    return kahan ? launch<true, true>(w, m, v, g, c, bits, n, s, st)
                 : launch<true, false>(w, m, v, g, c, bits, n, s, st);
  return kahan ? launch<false, true>(w, m, v, g, c, bits, n, s, st)
               : launch<false, false>(w, m, v, g, c, bits, n, s, st);
}
