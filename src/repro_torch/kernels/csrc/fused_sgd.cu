// Fused SGD-momentum update with nearest or stochastic weight rounding and
// optional Kahan compensation (the paper's Algorithms 2 and 3), in place.
//
// Replaces the Pallas kernel repro/kernels/fused_sgd.py:18 (fused_sgd_kernel)
// and its wrapper :47 (fused_sgd). Per element, in the reference's op order,
// every FPU output rounded once to bf16:
//   g = bf(g + wd*w)      m = bf(mu*m + g)      u = bf(lr*m)
// then w <- w - u (nearest or SR), or the Kahan update of bf16_update.cuh.
//
// What bounds it on an H100: bytes. It reads w, m, g (and c) as bf16 and the
// SR bits as u32 and writes w, m (and c) back into the same buffers: 18 bytes
// per element for SR+Kahan against 3.35 TB/s. Same design as fused_adamw.cu:
// one element per thread per step of a grid-stride loop, read then written by
// the same thread, so the update is in place.
//
// Plain C entry point, loaded with ctypes: launches on the caller's stream,
// allocates nothing, returns cudaGetLastError().
#include "bf16_update.cuh"

namespace {

template <bool SR, bool KAHAN>
__global__ void __launch_bounds__(repro::kThreads)
fused_sgd_kernel(__nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ m,
                 const __nv_bfloat16* __restrict__ g, __nv_bfloat16* __restrict__ c,
                 const uint32_t* __restrict__ bits, long long n, float lr, float mu,
                 float wd) {
  using repro::f32;
  using repro::q;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float wf = f32(w[i]);
    const float gf = q(__fadd_rn(f32(g[i]), __fmul_rn(wd, wf)));
    const float m2 = q(__fadd_rn(__fmul_rn(mu, f32(m[i])), gf));
    const float u = q(__fmul_rn(lr, m2));
    m[i] = repro::bf(m2);
    repro::update_weight<SR, KAHAN>(w, c, bits, i, wf, u);
  }
}

template <bool SR, bool KAHAN>
int launch(void* w, void* m, const void* g, void* c, const void* bits, long long n,
           float lr, float mu, float wd, cudaStream_t stream) {
  fused_sgd_kernel<SR, KAHAN><<<repro::blocks_for(n), repro::kThreads, 0, stream>>>(
      static_cast<__nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(m),
      static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(c),
      static_cast<const uint32_t*>(bits), n, lr, mu, wd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_fused_sgd(void* w, void* m, const void* g, void* c, const void* bits,
                               long long n, float lr, float momentum, float wd,
                               int stochastic, int kahan, void* stream) {
  if (n <= 0) return 0;
  if ((stochastic && bits == nullptr) || (kahan && c == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stochastic)
    return kahan ? launch<true, true>(w, m, g, c, bits, n, lr, momentum, wd, st)
                 : launch<true, false>(w, m, g, c, bits, n, lr, momentum, wd, st);
  return kahan ? launch<false, true>(w, m, g, c, bits, n, lr, momentum, wd, st)
               : launch<false, false>(w, m, g, c, bits, n, lr, momentum, wd, st);
}
