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
//   mapped      as contiguous, lane b reading cache row
//               lane_rows[b]:                        row = lane_rows[b]*Sc + key
// The body is templated on that map (ContiguousRows, MappedRows, PagedRows
// below). The mapped form runs each query row of a prefill chunk as a lane
// of its own over its lane's cache: a row's arithmetic is then the same as
// the single-token step's at its position (its visible range is the same).
// Nothing of the launch plan or of the float operations depends on the map,
// so on a gathered view pages[table] of equal length the paged kernel equals
// the contiguous kernel bit for bit. Null blocks point at a row whose
// positions are all -1, so they mask like empty cells.
//
// What bounds it on an H100. By bytes, the K and V rows it must read: a
// key costs 4*D bytes of K and V per kv-head against 4*G*D flops, far below
// the ~295 flop/byte ridge of the tensor cores. But this kernel does its
// flops on CUDA cores (2*G*D FMAs a key, 1024 at G = 8, D = 128, beside
// the shuffles that sum a key's products across lanes), and measured on
// the card those, not the bytes, set its pace (PERF.md). At the serving
// shapes (8 lanes x 2 kv-heads) one block per (lane, kv-head) would leave
// 116 of 132 SMs idle and hold the whole score row in one SM, so each
// (lane, kv-head) runs on a thread-block cluster of kCluster = 8 blocks
// (128 blocks) that meet through distributed shared memory:
//   0. range: each block scans 1/8 of the lane's positions (through the
//      block table when paged) for the first and last visible key; the
//      cluster reduces them to the lane's [first, last]. View index is not
//      position (the contiguous pool is a ring, cell pos % Sc), so the range
//      is found, not assumed. Each block takes an even share of it, so keys
//      outside it cost no loop trips. A lane with no visible key softmaxes
//      to uniform p over all Sc keys, so then the range is [0, Sc-1] and
//      every V row is read.
//   1. scores: a key's row is split over D/8 lanes; each thread stages its
//      16 bytes (bf16) of each of its keys through its own ring of steps in
//      shared memory by cp.async, src-size 0 for masked keys (no bytes read;
//      their score is NEG_INF whatever K holds), kStages-1 steps ahead, so
//      the key loops need no block barrier. The G query rows sit in
//      registers, 4 rows x 16 elements a lane, so each K row is read once for
//      its whole group. Block max, then the cluster max over ranks in order.
//   2. e = exp(s - max) in place and the block sum; the cluster sum, taken
//      over ranks 0..7 in order, so every block holds the same row sum.
//   3. p = e / sum, rounded to bf16 when round_p, and only then times V.
//      The usual flash-decoding merge rescales unnormalised partial PV sums
//      afterwards and so never rounds the normalised p: that is another
//      function, which is why each block knows the row's global max and sum
//      before its PV. V rows stream through the same rings (the first steps
//      are requested before the cluster reductions); masked keys read no V
//      (their p is exactly 0) and are skipped. Each thread accumulates 8 rows
//      x 8 columns over its keys in ascending order; the warps' partials add
//      in warp order, each block pushes column slice r to rank r through
//      DSMEM, and rank r adds the 8 slices in rank order and writes out.
// Every sum is taken in a fixed order, so repeated calls are bitwise equal.
// The block holds only its share of the score row, ceil(Sc/8) keys, so a
// view of 32768 keys fits (smem_bytes below; the wrapper mirrors it).
//
// A block holds at most kRows = 8 query rows. A group of G > 8 query heads
// (up to kMaxGroup = 16: recurrentgemma's 10 on one kv head) is split into
// n_sub = ceil(G / 8) even parts of ceil(G / n_sub) rows, each run by its
// own cluster over the same K/V rows (the second read mostly hits L2). A
// row's arithmetic does not depend on which slot of its block it sits in or
// on how many rows share the block: its scores reduce over the same lane
// tree, its max, sum and PV over the same threads in the same order, and the
// visible range and its split depend on the positions only. So a query
// head gets the same bits whatever G is.
//
// Plain C entry points, loaded with ctypes: launch on the caller's stream,
// allocate nothing, return the launch's CUDA error. A refused cluster launch
// is returned, never retried another way.
#include <climits>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;               // mirrored in decode_attention.py
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;                 // blocks per (lane, kv-head); portable max
constexpr int kScan = 8;                    // positions in flight per thread
constexpr int kRows = 8;                    // query rows of a block, at most: the layouts' rows
constexpr int kMaxGroup = 16;               // query heads per kv head, at most (mirrored)
// range (+pad), max and sum exchanges, warp partials, row max/sum
constexpr int kStatWords = 4 + 2 * kCluster * kRows + kWarps * kRows + kRows;
constexpr int kRingBytes = 65536;           // K or V bytes in flight per block
constexpr int kMaxSmem = 232448;            // 227 KB opt-in limit (sm_90)
constexpr float kNegInf = -1e30f;           // repro/models/layers.py:134

constexpr int kPair = 2;                    // keys a thread takes per step
// A key's row is split over D/8 lanes of 8 elements each, so the block
// takes kPair*kWarps*32/(D/8) keys per step, kPair per thread.
__host__ __device__ constexpr int step_keys(int D) { return kPair * kWarps * 32 / (D / 8); }
// steps in a thread's ring: kRingBytes over the block, kPair*8 elements a step
__host__ __device__ constexpr int stages(int elem_bytes) {
  return kRingBytes / (kThreads * kPair * 8 * elem_bytes);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled and nothing read
// when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// 8 consecutive elements of shared memory (16 bytes of bf16, 32 of f32) as f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {          // bf16 -> f32 is a 16-bit shift
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 c = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

// One step of a recursive-halving reduction across lanes: of NV values a
// lane keeps the half picked by bit X of its lane index and adds the
// partner's (lane ^ X) copy of that half, leaving NV/2 values.
template <int NV, int X, int N>
__device__ __forceinline__ void split(float (&a)[N], int lane) {
  const bool upper = lane & X;
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) {
    const float send = upper ? a[i] : a[i + NV / 2];
    const float keep = upper ? a[i + NV / 2] : a[i];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, X);
  }
}

// The 4 row partials of a key, spread over the Lg lanes that share its row
// group, to row sums: for Lg >= 4 lane l ends with row 2[l&Lg/2] + [l&Lg/4]
// of the group in a[0] (lanes differing only in lower bits hold the same
// sum); for Lg = 2 with rows 2[l&1] + {0, 1} in a[0], a[1]. Every row's sum
// is the same tree over the lanes.
template <int Lg>
__device__ __forceinline__ void reduce_rows(float (&a)[4], int lane) {
  if constexpr (Lg >= 4) {
    split<4, Lg / 2>(a, lane);
    split<2, Lg / 4>(a, lane);
#pragma unroll
    for (int x = Lg / 8; x >= 1; x >>= 1) a[0] += __shfl_xor_sync(0xffffffffu, a[0], x);
  } else {
    split<4, 1>(a, lane);
  }
}

// Key `key` of lane b -> its row in the (rows, Hkv, D) K/V view and the
// (rows,) position view.
struct ContiguousRows {            // k/v (B, Sc, Hkv, D), k_pos (B, Sc)
  int Sc;
  __device__ __forceinline__ int operator()(int b, int key) const { return b * Sc + key; }
};
struct MappedRows {                // k/v (N, Sc, Hkv, D), k_pos (N, Sc), lane b -> row lane_rows[b]
  const int* __restrict__ lane_rows;
  int Sc;
  __device__ __forceinline__ int operator()(int b, int key) const {
    return lane_rows[b] * Sc + key;
  }
};
struct PagedRows {                 // pages (R, P, Hkv, D), pos (R, P), table (B, n_blocks)
  const int* __restrict__ table;
  int n_blocks, P;
  __device__ __forceinline__ int operator()(int b, int key) const {
    return table[(long long)b * n_blocks + key / P] * P + key % P;
  }
};

// Keys of the score row one block holds: ceil(Sc / kCluster), rounded up to 4.
__host__ __device__ __forceinline__ int share_cap(int Sc) {
  return ((Sc + kCluster - 1) / kCluster + 3) / 4 * 4;
}

// The ring, reused after the PV loop for the warps' partial outputs.
__host__ __device__ constexpr int ring_bytes(int D) {
  return kRingBytes > kWarps * kRows * D * 4 ? kRingBytes : kWarps * kRows * D * 4;
}

// The parts a group of G query heads is split into, and the rows of a part.
__host__ __device__ __forceinline__ int n_parts(int G) { return (G + kRows - 1) / kRows; }
__host__ __device__ __forceinline__ int part_rows(int G) {
  return (G + n_parts(G) - 1) / n_parts(G);
}

// Dynamic shared memory of one block: the ring, then 4-byte words q rows
// [Gb][D] | PV sums of the cluster's blocks for this rank's columns
// [kCluster][Gb][D/kCluster] | stats | scores key-major [cap][kRows] | per
// key its row, or ~row when masked [cap]; Gb = part_rows(G) <= kRows.
size_t smem_bytes(int G, int D, int Sc) {
  return (size_t)ring_bytes(D) +
         4 * (2 * (size_t)part_rows(G) * D + kStatWords + (size_t)(kRows + 1) * share_cap(Sc));
}

// grid (kCluster*B, Hkv*n_parts(G)), clusters of kCluster blocks along x,
// kThreads threads: cluster rank r of lane b = blockIdx.x / kCluster, kv-head
// h = blockIdx.y / n_parts(G), and the part of its group blockIdx.y %
// n_parts(G): query heads [part*Gb, part*Gb + G) of the group below.
template <typename T, int D, typename Rows>
__global__ void __launch_bounds__(kThreads, 2)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ k_pos,
                        const int* __restrict__ q_pos, float* __restrict__ out,
                        Rows rows, int Sc, int Hkv, int G_all, float scale,
                        int window, float softcap, int round_p) {
  constexpr int L = D / 8;                       // lanes per key
  constexpr int kSlots = 32 / L;                 // keys per warp at once
  constexpr int kStep = step_keys(D);            // keys per step of the block
  constexpr int kStages = stages(sizeof(T));     // steps in a thread's ring
  constexpr int kEpc = 16 / (int)sizeof(T);      // elements per 16-byte copy
  constexpr int kCols = D / kCluster;            // output columns of a rank
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster, h = blockIdx.y / n_parts(G_all);
  const int g0 = (blockIdx.y % n_parts(G_all)) * part_rows(G_all);   // first row of the part
  const int G = min(part_rows(G_all), G_all - g0);                  // this block's rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = (long long)b * Hkv * G_all + (long long)h * G_all + g0;  // first q head
  float* out_rows = out + row0 * D;                                  // [G][D]
  const int qp = q_pos[b];
  if (qp < 0) {  // parked lane: zeros, no K/V traffic; the whole cluster leaves
    for (int i = tid; i < G * kCols; i += kThreads)
      out_rows[(i / kCols) * D + rank * kCols + i % kCols] = 0.f;
    return;
  }

  const int cap = share_cap(Sc);
  T* ring = reinterpret_cast<T*>(smem_raw);      // [kStages][kPair][kThreads][8]
  float* partial = reinterpret_cast<float*>(smem_raw);   // [kWarps][kRows][D] after PV
  float* qs = reinterpret_cast<float*>(smem_raw + ring_bytes(D));
  float* pv_in = qs + G * D;                     // [kCluster][G][kCols], pushed to
  int* range = reinterpret_cast<int*>(pv_in + G * D);  // [2] (+2 pad), read by the cluster
  float* max_in = reinterpret_cast<float*>(range + 4);  // [kCluster][kRows], pushed to
  float* sum_in = max_in + kCluster * kRows;            // [kCluster][kRows], pushed to
  float* red = sum_in + kCluster * kRows;               // [kWarps][kRows]
  float* row_stat = red + kWarps * kRows;               // [kRows] global max, then sum
  float* s = row_stat + kRows;                          // [cap][kRows]
  int* key_row = reinterpret_cast<int*>(s + (size_t)cap * kRows);   // [cap]

  const long long key_stride = (long long)Hkv * D;
  const T* k_head = k + (long long)h * D;        // row r of head h: k_head + r*key_stride
  const T* v_head = v + (long long)h * D;
  auto visible = [&](int kp) {
    return kp >= 0 && kp <= qp && (window < 0 || qp - kp < window);
  };

  // 0. q rows as f32; this block's 1/kCluster of the positions -> the
  //    first and last visible key; the cluster's -> the lane's range
  const T* q_rows = q + row0 * D;
  for (int i = tid; i < G * D; i += kThreads) qs[i] = to_f32(q_rows[i]);
  {
    const int part = (Sc + kCluster - 1) / kCluster;
    const int end = min(Sc, (rank + 1) * part);
    int first = INT_MAX, last = -1;
    for (int base = rank * part + tid; base < end; base += kScan * kThreads) {
      int kp[kScan];                             // kScan loads in flight, then tests
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        const int key = base + u * kThreads;
        kp[u] = key < end ? k_pos[rows(b, key)] : -1;
      }
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        const int key = base + u * kThreads;
        if (key < end && visible(kp[u])) {
          first = min(first, key);
          last = max(last, key);
        }
      }
    }
    first = __reduce_min_sync(0xffffffffu, first);
    last = __reduce_max_sync(0xffffffffu, last);
    int* warp_first = reinterpret_cast<int*>(red);
    int* warp_last = warp_first + kWarps;
    if (lane == 0) {
      warp_first[warp] = first;
      warp_last[warp] = last;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w) {
        first = min(first, warp_first[w]);
        last = max(last, warp_last[w]);
      }
      range[0] = first;
      range[1] = last;
    }
  }
  cluster.sync();                                // also: every block has started
  int first = INT_MAX, last = -1;
#pragma unroll
  for (int r = 0; r < kCluster; ++r) {
    const int* other = cluster.map_shared_rank(range, r);
    first = min(first, other[0]);
    last = max(last, other[1]);
  }
  // a row with no visible key softmaxes to uniform p: then every V row counts
  const bool read_all = last < 0;
  if (read_all) {
    first = 0;
    last = Sc - 1;
  }
  const int per = (last - first + kCluster) / kCluster;      // ceil(n / kCluster)
  const int lo = first + rank * per;
  const int n = max(0, min(lo + per, last + 1) - lo);        // this block's keys
  const int n_steps = (n + kStep - 1) / kStep;

  // per key of the share its row, complemented when masked
  for (int base = tid; base < n; base += kScan * kThreads) {
    int r[kScan], kp[kScan];
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int i = base + u * kThreads;
      r[u] = i < n ? rows(b, lo + i) : 0;
      kp[u] = i < n ? k_pos[r[u]] : -1;
    }
#pragma unroll
    for (int u = 0; u < kScan; ++u)
      if (base + u * kThreads < n) key_row[base + u * kThreads] = visible(kp[u]) ? r[u] : ~r[u];
  }
  __syncthreads();

  // A thread's keys at step j are j*kStep + slot + u*kStep/kPair (u <
  // kPair), and it reads elements d0 .. d0+8 of their rows: the lanes of a
  // key read the row's bytes side by side. It stages them itself through
  // its own ring of kStages steps in shared memory (16-byte cp.async,
  // src-size 0 for masked or out-of-range keys: nothing is read), so the
  // loops need no block barrier and every warp keeps kStages-1 steps of
  // loads in flight.
  const int slot = warp * kSlots + lane / L, d0 = 8 * (lane % L);
  auto key_of = [&](int j, int u) { return j * kStep + u * (kStep / kPair) + slot; };
  auto stage = [&](int j, int u) {
    return ring + (((size_t)(j % kStages) * kPair + u) * kThreads + tid) * 8;
  };
  auto prefetch = [&](int j, bool is_v) {        // step j's keys, if j < n_steps
    if (j < n_steps) {
#pragma unroll
      for (int u = 0; u < kPair; ++u) {
        const int i = key_of(j, u);
        const int e = i < n ? key_row[i] : -1;
        const bool need = i < n && (e >= 0 || (is_v && read_all));
        const T* src = (is_v ? v_head : k_head) + (long long)(e >= 0 ? e : ~e) * key_stride + d0;
#pragma unroll
        for (int c = 0; c < 8 / kEpc; ++c) cp_async16(stage(j, u) + c * kEpc, src + c * kEpc, need);
      }
    }
    cp_async_commit();
  };

  // 1. scores. Of a key's L lanes, lane p takes rows 4*rg .. 4*rg+3 (rg =
  //    p / Lg) and elements 16*dl .. 16*dl+16 (dl = p % Lg), which lanes
  //    2*dl and 2*dl+1 staged: q of those rows and elements in registers,
  //    16 products per row and key, then reduce_rows over the Lg lanes.
  for (int j = 0; j < kStages - 1; ++j) prefetch(j, false);
  {
    constexpr int Lg = L / 2;
    const int p = lane % L, rg = p / Lg, dl = p % Lg;
    int g_put;                                    // the row this lane writes, or -1
    if constexpr (Lg >= 4)
      g_put = (dl & (Lg / 4 - 1)) ? -1 : 4 * rg + 2 * ((dl & (Lg / 2)) != 0) + ((dl & (Lg / 4)) != 0);
    else
      g_put = 4 * rg + 2 * (dl & 1);
    float qr[4][16];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < 16; ++e)
        qr[r][e] = 4 * rg + r < G ? qs[(4 * rg + r) * D + 16 * dl + e] : 0.f;
    const int from = tid - p + 2 * dl;            // the lane that staged my first 8
    for (int j = 0; j < n_steps; ++j) {
      prefetch(j + kStages - 1, false);           // into the slots step j-1 used
      cp_async_wait<kStages - 1>();               // step j has landed (this thread)
      __syncwarp();                               // ... and the key's other lanes
#pragma unroll
      for (int u = 0; u < kPair; ++u) {
        const T* src = ring + (((size_t)(j % kStages) * kPair + u) * kThreads + from) * 8;
        float x[16];
        load8(src, *reinterpret_cast<float(*)[8]>(x));
        load8(src + 8, *reinterpret_cast<float(*)[8]>(x + 8));
        float a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float lo = 0.f, hi = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            lo = fmaf(qr[r][e], x[e], lo);
            hi = fmaf(qr[r][e + 8], x[e + 8], hi);
          }
          a[r] = lo + hi;
        }
        reduce_rows<Lg>(a, lane);
        const int i = key_of(j, u);
        if (i < n && g_put >= 0) {
          const bool masked = key_row[i] < 0;
#pragma unroll
          for (int v2 = 0; v2 < (Lg >= 4 ? 1 : 2); ++v2) {
            const int g = g_put + v2;
            if (g < G) {
              float sc = a[v2] * scale;
              if (softcap != 0.f) sc = softcap * tanhf(sc / softcap);
              s[i * kRows + g] = masked ? kNegInf : sc;
            }
          }
        }
      }
      __syncwarp();                               // slots read before refilled
    }
  }
  cp_async_wait<0>();
  __syncthreads();                                // scores written

  // V starts to stream while the cluster reduces max and sum
  for (int j = 0; j < kStages - 1; ++j) prefetch(j, true);

  // Row statistics. Thread t sweeps elements t, t + kThreads, ... of the
  // key-major score array, all of row g = t % 8; lanes of one row combine
  // by shuffles, warps in order; each block pushes its value to every
  // block, which combines the cluster's in rank order.
  const int g_me = tid % kRows;
  const int n_el = n * kRows;
  {
    float m = -CUDART_INF_F;
    for (int e = tid; e < n_el; e += kThreads) m = fmaxf(m, s[e]);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
    if (lane < kRows) red[warp * kRows + lane] = m;
    __syncthreads();
    if (tid < kCluster * kRows) {                // thread: (destination rank, row)
      const int g = tid % kRows;
      float mm = red[g];
      for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, red[w * kRows + g]);
      cluster.map_shared_rank(max_in, tid / kRows)[rank * kRows + g] = mm;
    }
  }
  cluster.sync();
  if (tid < G) {
    float m = max_in[tid];
    for (int r = 1; r < kCluster; ++r) m = fmaxf(m, max_in[r * kRows + tid]);
    row_stat[tid] = m;
  }
  __syncthreads();

  // 2. e = exp(s - max) in place, and the row sums
  {
    const float m = g_me < G ? row_stat[g_me] : 0.f;
    float sum = 0.f;
    if (g_me < G) {
      for (int e = tid; e < n_el; e += kThreads) {
        const float x = expf(s[e] - m);
        s[e] = x;
        sum += x;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 8);
    sum += __shfl_xor_sync(0xffffffffu, sum, 16);
    if (lane < kRows) red[warp * kRows + lane] = sum;
    __syncthreads();
    if (tid < kCluster * kRows) {
      const int g = tid % kRows;
      float ss = red[g];
      for (int w = 1; w < kWarps; ++w) ss += red[w * kRows + g];
      cluster.map_shared_rank(sum_in, tid / kRows)[rank * kRows + g] = ss;
    }
  }
  cluster.sync();
  if (tid < G) {
    float sum = sum_in[tid];
    for (int r = 1; r < kCluster; ++r) sum += sum_in[r * kRows + tid];
    row_stat[tid] = sum;
  }
  __syncthreads();

  // 3. p = e / sum with the row's global sum, rounded when round_p
  if (g_me < G) {
    const float sum = row_stat[g_me];
    for (int e = tid; e < n_el; e += kThreads) {
      float p = s[e] / sum;
      if (round_p) p = __bfloat162float(__float2bfloat16_rn(p));
      s[e] = p;
    }
  }

  __syncthreads();                                // every p written

  //    PV: a thread holds out[g][d0 .. d0+8) of all 8 rows for its keys;
  //    keys whose V row was not read (p exactly 0) are skipped
  float acc[kRows][8];
#pragma unroll
  for (int g = 0; g < kRows; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  for (int j = 0; j < n_steps; ++j) {
    prefetch(j + kStages - 1, true);
    cp_async_wait<kStages - 1>();
#pragma unroll
    for (int u = 0; u < kPair; ++u) {
      const int i = key_of(j, u);
      if (i < n && (read_all || key_row[i] >= 0)) {
        float x[8];
        load8(stage(j, u), x);
        const float4 pa = *reinterpret_cast<const float4*>(s + i * kRows);
        const float4 pb = *reinterpret_cast<const float4*>(s + i * kRows + 4);
        const float p[kRows] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int g = 0; g < kRows; ++g)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p[g], x[e], acc[g][e]);
      }
    }
  }
  // the key slots of a warp, then the warps in order, then each column
  // slice pushed to the rank that writes it
#pragma unroll
  for (int x = L; x < 32; x <<= 1)
#pragma unroll
    for (int g = 0; g < kRows; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], x);
  cp_async_wait<0>();
  __syncthreads();                                // ring free
  if (lane < L) {
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      float4* dst = reinterpret_cast<float4*>(partial + (warp * kRows + g) * D + d0);
      dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
  }
  __syncthreads();
  for (int o = tid; o < G * D; o += kThreads) {
    float sum = partial[o];
    for (int w = 1; w < kWarps; ++w) sum += partial[w * kRows * D + o];
    const int g = o / D, d = o % D;
    cluster.map_shared_rank(pv_in, d / kCols)[(rank * G + g) * kCols + d % kCols] = sum;
  }
  cluster.sync();
  // rank r: columns [r*kCols, (r+1)*kCols) of every row, partials in rank order
  for (int i = tid; i < G * kCols; i += kThreads) {
    float o = pv_in[i];
    for (int r = 1; r < kCluster; ++r) o += pv_in[r * G * kCols + i];
    out_rows[(i / kCols) * D + rank * kCols + i % kCols] = o;
  }
}

bool bad_shape(int G, int D, int Sc) {
  return G < 1 || G > kMaxGroup || (D != 32 && D != 64 && D != 128 && D != 256) || Sc < 1 ||
         smem_bytes(G, D, Sc) > (size_t)kMaxSmem;
}

template <typename T, int D, typename Rows>
int launch(const void* q, const void* k, const void* v, const int* k_pos,
           const int* q_pos, float* out, Rows rows, int B, int Sc, int Hkv, int G,
           float scale, int window, float softcap, int round_p, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, D, Rows>;
  static bool smem_opt_in = false;   // one per instantiation
  if (!smem_opt_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    smem_opt_in = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster * B, Hkv * n_parts(G));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem_bytes(G, D, Sc);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), k_pos, q_pos, out, rows, Sc, Hkv, G, scale, window,
      softcap, round_p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, typename Rows>
int launch_d(const void* q, const void* k, const void* v, const int* k_pos,
             const int* q_pos, float* out, Rows rows, int B, int Sc, int Hkv, int G,
             int D, float scale, int window, float softcap, int round_p,
             cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, k_pos, q_pos, out, rows, B, Sc, Hkv, G, scale,
                                  window, softcap, round_p, s);
    case 64: return launch<T, 64>(q, k, v, k_pos, q_pos, out, rows, B, Sc, Hkv, G, scale,
                                  window, softcap, round_p, s);
    case 128: return launch<T, 128>(q, k, v, k_pos, q_pos, out, rows, B, Sc, Hkv, G, scale,
                                    window, softcap, round_p, s);
    default: return launch<T, 256>(q, k, v, k_pos, q_pos, out, rows, B, Sc, Hkv, G, scale,
                                   window, softcap, round_p, s);
  }
}

template <typename Rows>
int dispatch(const void* q, const void* k, const void* v, const int* k_pos,
             const int* q_pos, float* out, Rows rows, int B, int Sc, int Hkv, int G,
             int D, float scale, int window, float softcap, int round_p, int dtype,
             void* stream) {
  if (B < 1 || Hkv < 1 || (dtype != 0 && dtype != 1) || bad_shape(G, D, Sc))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<__nv_bfloat16>(q, k, v, k_pos, q_pos, out, rows, B, Sc, Hkv, G, D,
                                   scale, window, softcap, round_p, s);
  return launch_d<float>(q, k, v, k_pos, q_pos, out, rows, B, Sc, Hkv, G, D, scale,
                         window, softcap, round_p, s);
}

}  // namespace

// dtype: 0 = bf16 q/k/v, 1 = f32. window < 0: none. softcap == 0: none.
// q, k, v must be 16-byte aligned; D one of 32, 64, 128, 256.
// Contiguous pool: k/v (N, Sc, Hkv, D), k_pos (N, Sc). Without lane_rows
// (null) lane b reads cache row b (N = B); with it, lane b reads cache row
// lane_rows[b] (int32, B entries in [0, N)), so the query rows of a prefill
// chunk run as lanes of their own over their lane's cache, in place.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const int* k_pos, const int* q_pos,
                                      const int* lane_rows, float* out,
                                      int B, int Sc, int Hkv, int G, int D,
                                      float scale, int window, float softcap,
                                      int round_p, int dtype, void* stream) {
  if (lane_rows != nullptr)
    return dispatch(q, k, v, k_pos, q_pos, out, MappedRows{lane_rows, Sc}, B, Sc, Hkv, G,
                    D, scale, window, softcap, round_p, dtype, stream);
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
