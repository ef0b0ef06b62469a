// Fused single-token GQA decode attention over the KV pool: the contiguous
// slotted pool and the paged pool share one kernel body.
//
// Replaces the Pallas kernels repro/kernels/decode_attention.py:42
// (decode_attention_kernel, wrapper :71 fused_decode_attention) and :102
// (paged_decode_attention_kernel, wrapper :148 fused_paged_decode_attention).
// It computes the same function, not the same blocks: per decode lane b and
// kv-head h, for the G = Hq/Hkv query heads of the group, over the lane's
// Sc keys,
//   s = (q . k) / sqrt(D)          f32 scores
//   s = softcap * tanh(s/softcap)  when softcap != 0
//   s = NEG_INF where not (0 <= k_pos <= q_pos [and q_pos - k_pos < window])
//   p = exp(s - max) / sum         full-row softmax, f32
//   p = bf16(p)                    when round_p (p.astype(p_dtype))
//   out = sum_k p * v              f32 accumulate, unrounded f32 output
// A parked lane (q_pos < 0) writes zeros and reads no K/V.
//
// The two layouts differ only in where key `key` of lane b lives, its row
// in a (rows, Hkv, D) view of K/V and a (rows,) view of the positions:
//   contiguous  k/v (B, Sc, Hkv, D), k_pos (B, Sc):      row = b*Sc + key
//   paged       k/v pages (R, P, Hkv, D), pos (R, P), block table
//               (B, n_blocks), Sc = n_blocks*P:          row = table[b][key/P]*P + key%P
// The body is templated on that map (RowMap below), so the paged kernel does
// the contiguous kernel's float operations in the same order: on a gathered
// view pages[table] of equal length the two agree bit for bit. Null blocks
// point at a row whose positions are all -1, so they mask like empty cells.
//
// What bounds it on an H100: the bytes of K, V and positions it reads (a
// decode step does 4*D flops per (query head, key) against 4*D bytes of K
// and V per (kv head, key), far below the ~295 flop/byte ridge), so the
// design reads each byte once:
//   * one block per (lane, kv-head) holds all G query rows of its group in
//     shared memory, so each K/V row is read once for its G query heads (the
//     grouped form of the TPU kernel);
//   * step 0 resolves every key's row once (one table read per key when
//     paged), reads its position and stages one word per key in shared
//     memory: the row if the key is visible, ~row if it is masked. A masked
//     key reads neither its K row (its score is NEG_INF whatever K holds) nor
//     its V row (its p is exactly 0), so empty cells and null blocks cost no
//     traffic, and the paged kernel needs no more shared memory than the
//     contiguous one;
//   * the (G, Sc) f32 score rows stay in shared memory, never in device
//     memory. This caps Sc: 4*((G+1)*Sc + 2*kThreads*G) bytes must fit the
//     227 KB a block may use (Sc <= 4636 at G = 8); the wrappers raise
//     beyond it.
// Each thread keeps several K/V loads in flight (vector loads, keys unrolled)
// to cover device-memory latency. One block per (lane, kv-head) still puts
// only B*Hkv blocks on the 132 SMs (16 at the main path's shapes), and each
// block does G*D f32 FMAs per key on CUDA cores, so long caches are bound by
// those 16 SMs, not by HBM; splitting the key axis over more blocks
// (split-KV) and streaming whole pages with TMA are the next steps.
//
// Plain C entry points, loaded with ctypes: launch on the caller's stream,
// allocate nothing, return cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;               // mirrored in decode_attention.py
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;                // query heads per kv head
constexpr int kKeyLanes = 8;                // lanes sharing one key's dot product
constexpr int kUnroll = 8;                  // V rows in flight per PV thread
constexpr int kMaxSmem = 232448;            // 227 KB opt-in limit (sm_90)
constexpr float kNegInf = -1e30f;           // repro/models/layers.py:134

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

// 4 consecutive elements (8 bytes of bf16, 16 of f32) as f32
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// 2 consecutive elements as f32
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Key `key` of lane b -> its row in the (rows, Hkv, D) K/V view and the
// (rows,) position view.
struct ContiguousRows {            // k/v (B, Sc, Hkv, D), k_pos (B, Sc)
  int Sc;
  __device__ __forceinline__ int operator()(int b, int key) const { return b * Sc + key; }
};
struct PagedRows {                 // pages (R, P, Hkv, D), pos (R, P), table (B, n_blocks)
  const int* __restrict__ table;
  int n_blocks, P;
  __device__ __forceinline__ int operator()(int b, int key) const {
    return table[(long long)b * n_blocks + key / P] * P + key % P;
  }
};

// grid (B, Hkv), kThreads threads; Sc keys per lane. Dynamic shared memory,
// 4-byte words: q rows [G][D] | partial PV sums of the key splits
// [2*kThreads/D - 1][G][D] | scores/probabilities [G][Sc] | per key its row,
// or ~row when masked [Sc] (the first three start on 8-byte boundaries for
// their vector accesses).
template <typename T, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ k_pos,
                        const int* __restrict__ q_pos, float* __restrict__ out,
                        Rows rows, int Sc, int Hkv, int G, int D, float scale,
                        int window, float softcap, int round_p) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = (long long)b * Hkv * G + (long long)h * G;  // first q head
  float* out_rows = out + row0 * D;                                  // [G][D]
  const int qp = q_pos[b];
  if (qp < 0) {  // parked lane: zeros, no K/V traffic
    for (int i = tid; i < G * D; i += kThreads) out_rows[i] = 0.f;
    return;
  }

  float* qs = smem;
  float* red = qs + G * D;
  float* s = red + (2 * kThreads - D) * G;
  int* key_row = reinterpret_cast<int*>(s + (long long)G * Sc);

  const long long key_stride = (long long)Hkv * D;
  const T* k_head = k + (long long)h * D;       // row r of head h: k_head + r*key_stride
  const T* v_head = v + (long long)h * D;

  // 0. stage q rows (f32), and per key its row, complemented when masked
  const T* q_rows = q + row0 * D;
  for (int i = tid; i < G * D; i += kThreads) qs[i] = to_f32(q_rows[i]);
  int any_ok = 0;
  for (int key = tid; key < Sc; key += kThreads) {
    const int r = rows(b, key);
    const int kp = k_pos[r];
    const int m = kp >= 0 && kp <= qp && (window < 0 || qp - kp < window);
    key_row[key] = m ? r : ~r;
    any_ok |= m;
  }
  // a row with no valid key softmaxes to uniform p: then every V row counts
  const bool read_all = !__syncthreads_or(any_ok);

  // 1. scores: kKeyLanes lanes per key, each a D/kKeyLanes slice of the dot
  //    product, reduced with 3 shuffles; two keys per lane in flight
  {
    const int sub = lane % kKeyLanes;
    const int chunk = D / kKeyLanes;             // multiple of 4
    const int keys_per_warp = 32 / kKeyLanes;
    const int step = kWarps * keys_per_warp;
    for (int base = warp * keys_per_warp; base < Sc; base += 2 * step) {
      const int key0 = base + lane / kKeyLanes, key1 = key0 + step;
      const int r0 = key0 < Sc ? key_row[key0] : -1;
      const int r1 = key1 < Sc ? key_row[key1] : -1;
      const bool ok0 = r0 >= 0, ok1 = r1 >= 0;
      float p0[kMaxGroup], p1[kMaxGroup];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) p0[g] = p1[g] = 0.f;
      const T* k0 = k_head + (ok0 ? r0 : 0) * key_stride + sub * chunk;
      const T* k1 = k_head + (ok1 ? r1 : 0) * key_stride + sub * chunk;
#pragma unroll 4
      for (int j = 0; j < chunk; j += 4) {
        const float4 a = ok0 ? load4(k0 + j) : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 c = ok1 ? load4(k1 + j) : make_float4(0.f, 0.f, 0.f, 0.f);
        const int d = sub * chunk + j;
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < G) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + g * D + d);
            p0[g] = fmaf(qv.x, a.x, p0[g]); p0[g] = fmaf(qv.y, a.y, p0[g]);
            p0[g] = fmaf(qv.z, a.z, p0[g]); p0[g] = fmaf(qv.w, a.w, p0[g]);
            p1[g] = fmaf(qv.x, c.x, p1[g]); p1[g] = fmaf(qv.y, c.y, p1[g]);
            p1[g] = fmaf(qv.z, c.z, p1[g]); p1[g] = fmaf(qv.w, c.w, p1[g]);
          }
        }
      }
#pragma unroll
      for (int o = kKeyLanes / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          p0[g] += __shfl_xor_sync(0xffffffffu, p0[g], o);
          p1[g] += __shfl_xor_sync(0xffffffffu, p1[g], o);
        }
      }
      // lane `sub` of the key's group writes row g = sub
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g == sub && g < G) {
          if (key0 < Sc) {
            float sc = p0[g] * scale;
            if (softcap != 0.f) sc = softcap * tanhf(sc / softcap);
            s[g * Sc + key0] = ok0 ? sc : kNegInf;
          }
          if (key1 < Sc) {
            float sc = p1[g] * scale;
            if (softcap != 0.f) sc = softcap * tanhf(sc / softcap);
            s[g * Sc + key1] = ok1 ? sc : kNegInf;
          }
        }
      }
    }
  }
  __syncthreads();

  // 2. softmax over the full row: one warp per query row
  for (int g = warp; g < G; g += kWarps) {
    float* row = s + (long long)g * Sc;
    float m = -CUDART_INF_F;
    for (int i = lane; i < Sc; i += 32) m = fmaxf(m, row[i]);
    m = warp_max(m);
    float sum = 0.f;
    for (int i = lane; i < Sc; i += 32) {
      const float e = expf(row[i] - m);
      row[i] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int i = lane; i < Sc; i += 32) {
      float p = row[i] / sum;
      if (round_p) p = __bfloat162float(__float2bfloat16_rn(p));
      row[i] = p;
    }
  }
  __syncthreads();

  // 3. PV: thread (ks, dv) sums keys ks, ks+KS, ... (ascending) for columns
  //    2*dv, 2*dv+1 of all G rows; kUnroll V rows in flight per thread
  const int DV = D / 2, KS = kThreads / DV;
  const int dv = tid % DV, ks = tid / DV;
  float2 acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = make_float2(0.f, 0.f);
  for (int key0 = ks; key0 < Sc; key0 += kUnroll * KS) {
    float2 vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int key = key0 + u * KS;
      const int e = key < Sc ? key_row[key] : -1;
      const bool need = key < Sc && (read_all || e >= 0);
      const long long r = e >= 0 ? e : ~e;
      vv[u] = need ? load2(v_head + r * key_stride + 2 * dv) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int key = key0 + u * KS;
      if (key < Sc) {
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < G) {
            const float p = s[g * Sc + key];   // 0 exactly where the row masks
            acc[g].x = fmaf(p, vv[u].x, acc[g].x);
            acc[g].y = fmaf(p, vv[u].y, acc[g].y);
          }
        }
      }
    }
  }
  if (ks > 0) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < G)
        *reinterpret_cast<float2*>(red + ((long long)(ks - 1) * G + g) * D + 2 * dv) = acc[g];
  }
  __syncthreads();
  if (ks == 0) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) {
        float2 r = acc[g];
        for (int j = 1; j < KS; ++j) {
          const float2 o = *reinterpret_cast<const float2*>(
              red + ((long long)(j - 1) * G + g) * D + 2 * dv);
          r.x += o.x;
          r.y += o.y;
        }
        *reinterpret_cast<float2*>(out_rows + g * D + 2 * dv) = r;
      }
    }
  }
}

size_t smem_bytes(int G, int D, int Sc) {
  return 4 * ((size_t)G * D + Sc + (size_t)G * Sc + (size_t)(2 * kThreads - D) * G);
}

template <typename T, typename Rows>
int launch(const void* q, const void* k, const void* v, const int* k_pos,
           const int* q_pos, float* out, Rows rows, int B, int Sc, int Hkv, int G,
           int D, float scale, int window, float softcap, int round_p,
           cudaStream_t stream) {
  static bool smem_opt_in = false;   // one per instantiation
  if (!smem_opt_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    smem_opt_in = true;
  }
  const dim3 grid(B, Hkv);
  decode_attention_kernel<T, Rows><<<grid, kThreads, smem_bytes(G, D, Sc), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      k_pos, q_pos, out, rows, Sc, Hkv, G, D, scale, window, softcap, round_p);
  return (int)cudaGetLastError();
}

bool bad_shape(int G, int D, int Sc) {
  return G < 1 || G > kMaxGroup || D < 32 || D % 32 != 0 || (2 * kThreads) % D != 0 ||
         Sc < 1 || smem_bytes(G, D, Sc) > (size_t)kMaxSmem;
}

template <typename Rows>
int dispatch(const void* q, const void* k, const void* v, const int* k_pos,
             const int* q_pos, float* out, Rows rows, int B, int Sc, int Hkv, int G,
             int D, float scale, int window, float softcap, int round_p, int dtype,
             void* stream) {
  if (bad_shape(G, D, Sc)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<__nv_bfloat16>(q, k, v, k_pos, q_pos, out, rows, B, Sc, Hkv, G, D,
                                 scale, window, softcap, round_p, s);
  if (dtype == 1)
    return launch<float>(q, k, v, k_pos, q_pos, out, rows, B, Sc, Hkv, G, D, scale,
                         window, softcap, round_p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = bf16 q/k/v, 1 = f32. window < 0: none. softcap == 0: none.
// q, k, v must be 16-byte aligned; D a multiple of 32 dividing 2*kThreads.
// Contiguous pool: k/v (B, Sc, Hkv, D), k_pos (B, Sc).
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const int* k_pos, const int* q_pos, float* out,
                                      int B, int Sc, int Hkv, int G, int D,
                                      float scale, int window, float softcap,
                                      int round_p, int dtype, void* stream) {
  return dispatch(q, k, v, k_pos, q_pos, out, ContiguousRows{Sc}, B, Sc, Hkv, G, D,
                  scale, window, softcap, round_p, dtype, stream);
}

// Paged pool: k/v pages (R, P, Hkv, D), pos_pages (R, P), block_table
// (B, n_blocks) of rows in [0, R); each lane attends over n_blocks*P keys.
extern "C" int repro_paged_decode_attention(const void* q, const void* k_pages,
                                            const void* v_pages, const int* pos_pages,
                                            const int* block_table, const int* q_pos,
                                            float* out, int B, int n_blocks, int P,
                                            int Hkv, int G, int D, float scale,
                                            int window, float softcap, int round_p,
                                            int dtype, void* stream) {
  if (n_blocks < 1 || P < 1 || n_blocks > (1 << 30) / P) return (int)cudaErrorInvalidValue;
  return dispatch(q, k_pages, v_pages, pos_pages, q_pos, out,
                  PagedRows{block_table, n_blocks, P}, B, n_blocks * P, Hkv, G, D, scale,
                  window, softcap, round_p, dtype, stream);
}
