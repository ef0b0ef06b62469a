// Fused AdamW update with nearest or stochastic weight rounding and optional
// Kahan compensation (the paper's Algorithms 4 and 5), in place.
//
// Replaces the Pallas kernel repro/kernels/fused_adamw.py:36
// (fused_adamw_kernel) and its wrapper :90 (fused_adamw). Per element, in the
// reference's op order, every FPU output rounded once to bf16:
//   m = bf(b1*m + (1-b1)*g)          v = bf(b2*v + ((1-b2)*g)*g)
//   m_hat = bf(m / (1-c1))           v_hat = bf(sqrt(v / (1-c2)))
//   u = bf(lr*m_hat / (v_hat+eps) + (lr*wd)*w)
// then w <- w - u (nearest or SR), or the Kahan update (bf16_update.cuh's
// weight_step).
// The scalars arrive as f32; 1-b1, 1-b2 and lr*wd are formed here in f32, as
// the TPU kernel does.
//
// The SR bits come one of two ways. Seeded (the optimizers' StepKey): the
// kernel draws them itself with Philox4x32-10 (philox.cuh), element i taking
// word i % 4 of block i / 4 of the leaf's stream, so they never pass
// through device memory. Given (GivenKey, the op layer): an int32 tensor
// carrying u32, read once.
//
// What bounds it on an H100: bytes. Seeded SR + Kahan it reads w, m, v, g, c
// (bf16) and writes w, m, v, c: 18 bytes per element against 3.35 TB/s
// (1.67 ms at the 311 M-element embedding of qwen2.5-3b), where the bits of
// a separate fill added 8 (4 written, 4 read back). Its issue cost is close
// behind: three IEEE divisions and a __fsqrt_rn per element and a quarter
// of a Philox call (chip_smoke.py times the loads alone and loads + stores
// beside the update to say which bound holds). So each thread takes 8
// elements per step, one 16-byte load per tensor, all issued before the
// arithmetic (the given bits: two 16-byte loads), two Philox calls per 8
// elements, and 16-byte stores; the grid is as many blocks as fill every SM
// at the kernel's occupancy, looping over the vectors. The elements before
// the first 16-byte boundary and after the last whole vector are taken one
// at a time by the same kernel (the scalar head and tail), as is everything
// when the tensors do not share one alignment. Each element is read and
// then written by the same thread, so updating in place is safe and the
// optimizer never holds a second copy of its state.
//
// A probe variant of the same kernel (seeded, SR + Kahan) does only the
// loads, or the loads and stores of the same values, for chip_smoke.py.
//
// Plain C entry points, loaded with ctypes: launch on the caller's stream,
// allocate nothing, return the launch's CUDA error.
#include <initializer_list>

#include "bf16_update.cuh"
#include "philox.cuh"

namespace {

enum Variant { kUpdate = 0, kLoads = 1, kLoadsStores = 2 };

struct Scalars {
  float lr, b1, b2, eps, wd, om_c1, om_c2;
};

struct Args {
  __nv_bfloat16 *w, *m, *v;
  const __nv_bfloat16* g;
  __nv_bfloat16* c;
  const uint32_t* bits;   // given bits, or null when seeded
  uint32_t* sink;         // probe loads: written only if they xor to one value
  long long n, head, n_vec;   // elements; scalar head; 8-element vectors after it
  uint2 key;              // Philox key when seeded
  Scalars s;
};

// The update of one element in f32: new m, v and the rounded step u.
struct Step {
  float m2, v2, u;
};

__device__ __forceinline__ Step adamw_step(const Scalars& s, float om_b1, float om_b2,
                                           float lr_wd, float wf, float gf, float mf,
                                           float vf) {
  using repro::q;
  Step r;
  r.m2 = q(__fadd_rn(__fmul_rn(s.b1, mf), __fmul_rn(om_b1, gf)));
  r.v2 = q(__fadd_rn(__fmul_rn(s.b2, vf), __fmul_rn(__fmul_rn(om_b2, gf), gf)));
  const float m_hat = q(__fdiv_rn(r.m2, s.om_c1));
  const float v_hat = q(__fsqrt_rn(__fdiv_rn(r.v2, s.om_c2)));
  r.u = q(__fadd_rn(__fdiv_rn(__fmul_rn(s.lr, m_hat), __fadd_rn(v_hat, s.eps)),
                    __fmul_rn(lr_wd, wf)));
  return r;
}

template <bool SR, bool KAHAN, bool SEEDED>
__device__ __forceinline__ void update_one(const Args& a, long long i, float om_b1,
                                           float om_b2, float lr_wd) {
  using repro::f32;
  const float wf = f32(a.w[i]);
  const Step st = adamw_step(a.s, om_b1, om_b2, lr_wd, wf, f32(a.g[i]), f32(a.m[i]),
                             f32(a.v[i]));
  uint32_t bits = 0;
  if (SR) bits = SEEDED ? repro::philox_word(a.key, i) : a.bits[i];
  __nv_bfloat16 w2, c2;
  repro::weight_step<SR, KAHAN>(wf, st.u, KAHAN ? f32(a.c[i]) : 0.f, bits, w2, c2);
  a.m[i] = repro::bf(st.m2);
  a.v[i] = repro::bf(st.v2);
  a.w[i] = w2;
  if (KAHAN) a.c[i] = c2;
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&x)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {          // bf16 -> f32 is a 16-bit shift
    x[2 * k] = __uint_as_float(w[k] << 16);
    x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const __nv_bfloat16 (&x)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = static_cast<uint32_t>(__bfloat16_as_ushort(x[2 * k])) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(x[2 * k + 1])) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool SR, bool KAHAN, bool SEEDED, int VARIANT>
__global__ void __launch_bounds__(repro::kThreads)
fused_adamw_kernel(Args a) {
  const float om_b1 = __fsub_rn(1.0f, a.s.b1);
  const float om_b2 = __fsub_rn(1.0f, a.s.b2);
  const float lr_wd = __fmul_rn(a.s.lr, a.s.wd);
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tail = a.head + 8 * a.n_vec;

  if (VARIANT == kUpdate) {
    // scalar head and tail (all elements when the tensors share no alignment)
    for (long long i = tid; i < a.head; i += stride)
      update_one<SR, KAHAN, SEEDED>(a, i, om_b1, om_b2, lr_wd);
    for (long long i = tail + tid; i < a.n; i += stride)
      update_one<SR, KAHAN, SEEDED>(a, i, om_b1, om_b2, lr_wd);
  }

  uint32_t probe = 0;
  for (long long t = tid; t < a.n_vec; t += stride) {
    const long long i0 = a.head + 8 * t;
    // every load of the step first
    const uint4 w_raw = __ldcs(reinterpret_cast<const uint4*>(a.w + i0));
    const uint4 m_raw = __ldcs(reinterpret_cast<const uint4*>(a.m + i0));
    const uint4 v_raw = __ldcs(reinterpret_cast<const uint4*>(a.v + i0));
    const uint4 g_raw = __ldcs(reinterpret_cast<const uint4*>(a.g + i0));
    uint4 c_raw = make_uint4(0, 0, 0, 0);
    if (KAHAN) c_raw = __ldcs(reinterpret_cast<const uint4*>(a.c + i0));
    uint32_t bits[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (SR && !SEEDED) {
      const uint4 b0 = __ldcs(reinterpret_cast<const uint4*>(a.bits + i0));
      const uint4 b1 = __ldcs(reinterpret_cast<const uint4*>(a.bits + i0) + 1);
      bits[0] = b0.x; bits[1] = b0.y; bits[2] = b0.z; bits[3] = b0.w;
      bits[4] = b1.x; bits[5] = b1.y; bits[6] = b1.z; bits[7] = b1.w;
    }
    if (VARIANT == kLoads) {
      probe ^= w_raw.x ^ w_raw.y ^ w_raw.z ^ w_raw.w ^ m_raw.x ^ m_raw.y ^ m_raw.z ^ m_raw.w ^
               v_raw.x ^ v_raw.y ^ v_raw.z ^ v_raw.w ^ g_raw.x ^ g_raw.y ^ g_raw.z ^ g_raw.w ^
               c_raw.x ^ c_raw.y ^ c_raw.z ^ c_raw.w;
      continue;
    }
    if (VARIANT == kLoadsStores) {       // the same values back: nothing changes
      __stcs(reinterpret_cast<uint4*>(a.w + i0), w_raw);
      __stcs(reinterpret_cast<uint4*>(a.m + i0), m_raw);
      __stcs(reinterpret_cast<uint4*>(a.v + i0), v_raw);
      if (KAHAN) __stcs(reinterpret_cast<uint4*>(a.c + i0), c_raw);
      continue;
    }
    if (SR && SEEDED) repro::philox_words8(a.key, i0, bits);
    float wf[8], mf[8], vf[8], gf[8], cf[8];
    unpack(w_raw, wf);
    unpack(m_raw, mf);
    unpack(v_raw, vf);
    unpack(g_raw, gf);
    unpack(c_raw, cf);
    __nv_bfloat16 w2[8], m2[8], v2[8], c2[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const Step st = adamw_step(a.s, om_b1, om_b2, lr_wd, wf[k], gf[k], mf[k], vf[k]);
      m2[k] = repro::bf(st.m2);
      v2[k] = repro::bf(st.v2);
      repro::weight_step<SR, KAHAN>(wf[k], st.u, cf[k], bits[k], w2[k], c2[k]);
    }
    __stcs(reinterpret_cast<uint4*>(a.w + i0), pack(w2));
    __stcs(reinterpret_cast<uint4*>(a.m + i0), pack(m2));
    __stcs(reinterpret_cast<uint4*>(a.v + i0), pack(v2));
    if (KAHAN) __stcs(reinterpret_cast<uint4*>(a.c + i0), pack(c2));
  }
  if (VARIANT == kLoads && probe == 0x5bd1e995u) a.sink[0] = probe;   // keeps the loads
}

template <bool SR, bool KAHAN, bool SEEDED, int VARIANT>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = fused_adamw_kernel<SR, KAHAN, SEEDED, VARIANT>;
  static int grid = 0;                   // one per instantiation: every SM full
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, repro::kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  // no more blocks than the work needs (a small leaf)
  const long long work = a.n_vec + a.head + (a.n - a.head - 8 * a.n_vec);
  const long long need = (work + repro::kThreads - 1) / repro::kThreads;
  const int blocks = static_cast<int>(need < grid ? need : grid);
  kernel<<<blocks, repro::kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int VARIANT>
int dispatch(const Args& a, bool sr, bool kahan, bool seeded, cudaStream_t st) {
  if (VARIANT != kUpdate) return launch<true, true, true, VARIANT>(a, st);
  if (sr && seeded)
    return kahan ? launch<true, true, true, kUpdate>(a, st)
                 : launch<true, false, true, kUpdate>(a, st);
  if (sr)
    return kahan ? launch<true, true, false, kUpdate>(a, st)
                 : launch<true, false, false, kUpdate>(a, st);
  return kahan ? launch<false, true, false, kUpdate>(a, st)
               : launch<false, false, false, kUpdate>(a, st);
}

// The scalar head and the 8-element vectors: vectors need every tensor at
// the same offset from a 16-byte boundary (the bits, 4 bytes an element, at
// the offset that puts the head's end on one too).
void split(Args& a) {
  const uintptr_t w = reinterpret_cast<uintptr_t>(a.w);
  const long long head = static_cast<long long>(((16 - w % 16) % 16) / 2);
  bool vec = w % 2 == 0;
  for (const void* p : {static_cast<const void*>(a.m), static_cast<const void*>(a.v),
                        static_cast<const void*>(a.g), static_cast<const void*>(a.c)})
    if (p != nullptr) vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == w % 16;
  if (a.bits != nullptr) vec = vec && (reinterpret_cast<uintptr_t>(a.bits + head) % 16 == 0);
  if (!vec || head >= a.n) {
    a.head = a.n;
    a.n_vec = 0;
    return;
  }
  a.head = head;
  a.n_vec = (a.n - head) / 8;
}

int run(int variant, void* w, void* m, void* v, const void* g, void* c, const void* bits,
        void* sink, long long n, unsigned int key_lo, unsigned int key_hi, float lr,
        float b1, float b2, float eps, float wd, float om_c1, float om_c2, int stochastic,
        int kahan, int seeded, void* stream) {
  if (n <= 0) return 0;
  if ((stochastic && !seeded && bits == nullptr) || (kahan && c == nullptr) ||
      (variant != kUpdate && (sink == nullptr || c == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.w = static_cast<__nv_bfloat16*>(w);
  a.m = static_cast<__nv_bfloat16*>(m);
  a.v = static_cast<__nv_bfloat16*>(v);
  a.g = static_cast<const __nv_bfloat16*>(g);
  a.c = kahan ? static_cast<__nv_bfloat16*>(c) : nullptr;
  a.bits = stochastic && !seeded ? static_cast<const uint32_t*>(bits) : nullptr;
  a.sink = static_cast<uint32_t*>(sink);
  a.n = n;
  a.key = make_uint2(key_lo, key_hi);
  a.s = Scalars{lr, b1, b2, eps, wd, om_c1, om_c2};
  split(a);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kUpdate: return dispatch<kUpdate>(a, stochastic, kahan, seeded, st);
    case kLoads: return dispatch<kLoads>(a, true, true, true, st);
    case kLoadsStores: return dispatch<kLoadsStores>(a, true, true, true, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One AdamW step in place. seeded: SR bits from Philox keyed (key_lo, key_hi),
// bits ignored; otherwise SR bits from `bits` (int32 carrying u32).
extern "C" int repro_fused_adamw(void* w, void* m, void* v, const void* g, void* c,
                                 const void* bits, long long n, unsigned int key_lo,
                                 unsigned int key_hi, float lr, float b1, float b2,
                                 float eps, float wd, float om_c1, float om_c2,
                                 int stochastic, int kahan, int seeded, void* stream) {
  return run(kUpdate, w, m, v, g, c, bits, nullptr, n, key_lo, key_hi, lr, b1, b2, eps, wd,
             om_c1, om_c2, stochastic, kahan, seeded, stream);
}

// The probe variants of the seeded SR + Kahan kernel: variant 1 loads w, m,
// v, g, c only (a word reaches `sink` only if their xor is one value);
// variant 2 loads them and stores w, m, v, c back unchanged.
extern "C" int repro_fused_adamw_probe(int variant, void* w, void* m, void* v, const void* g,
                                       void* c, void* sink, long long n, void* stream) {
  if (variant != kLoads && variant != kLoadsStores)
    return static_cast<int>(cudaErrorInvalidValue);
  return run(variant, w, m, v, g, c, nullptr, sink, n, 0, 0, 0.f, 0.f, 0.f, 0.f, 0.f, 1.f,
             1.f, 1, 1, 1, stream);
}
