// Heads-packed multi-head attention with few queries over many keys (1 <= Lq
// <= 16, Lq < Lk, no mask), forward: the cross route of fused_mha
// (csrc/fused_mha.cu, entry vtc_fused_mha_cross).
//
// Not a port of a Pallas kernel: the JAX package runs this attention, the
// joint TimeSformer's CLS row (1 query over 1 + T·N keys,
// vtc_tpu/models/timesformer_joint.py:97), through XLA (_attn, :31-35).
// Contract, that of fused_mha_plain: q scaled by Dh^-0.5 in q's type, QK^T
// in fp32, softmax in fp32 with the row's final max m and sum l, P = e / l
// normalised before it is rounded to q's type, P·V in fp32, output rounded
// to q's type once.
//
// Bound on the H100: bytes. At the joint tower's shape (ViT-B/32, 8
// frames, batch 16: q and o [16, 1, 768], k and v [16, 393, 768] column
// views of one qkv tensor, row stride 3E) the call moves 19.4 MB, 5.78 µs
// at 3.35 TB/s; its work, 4·B·H·Lq·Lk·Dh = 19.3 MFLOP, is nothing beside
// that. So the design is about reading K and V off the card's memory once,
// all of a CTA's share requested before anything waits, and about a short
// tail once the last byte has landed:
//
// - Grid: one thread-block cluster per (sequence, head), its C CTAs
//   splitting the Lk keys into contiguous ranges of `keys` (the last
//   shorter, none empty). A CTA reads Dh contiguous elements a key row (128
//   bytes in bf16 at Dh = 64: one whole line) of its head, so a CTA's shared
//   memory and the plan (below) depend on (Lq, Lk, Dh, dtype) alone, not on
//   the heads: a cluster per sequence over all heads would need E-wide rows
//   (1536 bytes in bf16 at E = 768, 4 KB at E = 2048) in every CTA. C is
//   the smallest at which a CTA's shared memory is at most kTargetBytes =
//   40 KB, else 8 where a CTA of 8 fits an SM. The joint tower's bf16 (1,
//   393) gets C = 2 of 197 keys: 384 CTAs of 4 warps, 2.9 an SM on 132 SMs,
//   all resident at once (three CTAs an SM: the registers are budgeted for
//   them, kMinBlocks). Whole heads, one CTA each, leave 60 of the SMs with
//   two CTAs and the others with one, and the SMs with two set the pace:
//   capped at one CTA (max_cluster 1, V then in shared memory) the plan
//   took 0.0156 ms against C = 2's 0.0138 to 0.0140 in the same call
//   (chip_smoke.py phase 36). The two-pass kernel ran 192 blocks with
//   about 16 KB each in flight.
// - Loads: K's rows into shared memory with 16-byte cp.async (element loads
//   where a base, a stride or Dh·esize is not a 16-byte multiple: vec_in in
//   fused_mha.cu), each row's 16-byte chunks swizzled by the row (chunk c of
//   row r at c ^ (r & 7)), so that rows need no padding and 8 threads
//   reading one chunk of 8 rows hit 32 banks. V goes straight into registers
//   where it fits (v_in_registers: bf16 at Dh <= 64, at most kRegKeys = 56
//   keys a warp: each lane holds its column pair of each of its warp's
//   keys), else into shared memory as K, in a second cp.async group. In
//   shared memory P·V reads every byte of V once more through the SM's 128
//   bytes a clock, after the last byte has landed; from registers it is
//   FMAs.
// - Scores: each thread takes keys of its CTA and runs each query row's
//   dot product over Dh in four interleaved chains of fp32 FMAs on the CUDA
//   cores (round to nearest; the work is far below the bytes, and no mma
//   chain drifts from the plain version's sums), keeping S in shared memory
//   and its own running max and sum of exponentials of the row.
// - Softmax across the cluster: each warp's (max, sum) by shuffles, each
//   CTA's (m_c, l_c) from its warps in order, sent into every CTA's inbox
//   through distributed shared memory (the first cluster barrier arrived at
//   the start and waited on just before, so every CTA is running), one
//   cluster barrier, then every CTA combines the C pairs in rank order: m =
//   max m_c, l = Σ_c l_c · exp(m_c − m), the rescaled l of the two-pass
//   kernel, the same numbers in every CTA. P = exp(S − m) / l, expf and an
//   IEEE division as PyTorch's softmax, normalised before it is rounded to
//   q's type: no online softmax that rescales an output built from
//   unnormalised P (long_attention.cuh's first lesson).
// - Output: each warp's P·V over its keys (whole 8-row swizzle periods) in
//   fp32 FMAs, lanes on column pairs, into partial rows where K was; the
//   CTA's partial of each output, its warps' in order; with a cluster each
//   CTA sends each slice of the Lq·Dh outputs to the CTA that owns it, one
//   more cluster barrier, and the owner sums the C partials in rank order.
//   The output is rounded to q's type once. No atomics: two launches give
//   the same bits.
//
// Lk beyond what 8 CTAs of 227 KB hold (plan: cluster 0) is left to the
// long route's two-pass kernel; the wrapper routes by the same plan, which
// it asks of the library (vtc_fused_mha_cross_plan).
//
// Time at the headline (chip_smoke.py phase 36; PERF.md §6): 0.0135 to
// 0.0151 ms from call to call against the two-pass kernel's 0.057, 0.38 to
// 0.43 of the bound, SDPA 0.0112 to 0.0116. What is left is the tail after
// the data: a CTA's K lands near the end of the call's memory time, and the
// exchange of the row statistics through a cluster barrier, P and P·V
// follow it.
//
// Registers (ptxas -v, sm_90a; chip_smoke.py logs them in its build phase
// and phase 36): <bf16, V in registers> 150, <bf16> 80, <fp32> 96, no
// spills.

#pragma once

#include <cooperative_groups.h>
#include <stddef.h>

#include "short_attention.cuh"

namespace ca {

namespace cg = cooperative_groups;
using sa::bf16;

constexpr int kMaxQueries = 16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 3;  // CTAs an SM the registers are budgeted for
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr size_t kSmemMax = 232448;  // an SM's shared memory a block can use
// the shared memory a CTA aims at (see the plan)
constexpr size_t kTargetBytes = 40 * 1024;

// V held in registers, not shared memory (bf16 at Dh <= 64: a lane's
// column pair of each of its warp's keys, at most kRegKeys of them)
constexpr int kRegKeys = 56;
template <typename T> __host__ __device__ inline bool v_in_registers(int keys, int dh) {
  return sizeof(T) == 2 && dh <= 64 && (keys + kWarps - 1) / kWarps <= kRegKeys;
}

// bytes of a K or V row in shared memory: Dh rounded up to whole 128-byte
// lines, whose 16-byte chunks are swizzled by the row (chunk c of row r at
// c ^ (r & 7)), so that 8 threads reading one chunk of 8 rows hit 32 banks
template <typename T> __host__ __device__ inline int row_bytes(int dh) {
  return (dh * (int)sizeof(T) + 127) / 128 * 128;
}

// the bytes of K's rows, which the warps' partial outputs take over once
// the scores are computed
template <typename T>
__host__ __device__ inline size_t union_bytes(int lq, int keys, int dh) {
  const size_t k = (size_t)keys * row_bytes<T>(dh);
  const size_t w = sizeof(float) * kWarps * lq * (row_bytes<T>(dh) / sizeof(T));
  return k > w ? k : w;
}

// shared memory of a CTA with `keys` keys in a cluster of `cluster`: K's rows
// (later the warps' partial outputs), V's rows unless V is in registers; in
// fp32 q scaled, S then P (rows padded to 4), the warps' row statistics, m
// and l, the inbox of the cluster's row statistics and, with a cluster, the
// inbox of this CTA's slice of the outputs
template <typename T>
__host__ __device__ inline size_t smem_bytes(int lq, int keys, int dh, int cluster) {
  const int cols = row_bytes<T>(dh) / (int)sizeof(T), pk = (keys + 3) / 4 * 4;
  const int slice = (lq * dh + cluster - 1) / cluster;
  return union_bytes<T>(lq, keys, dh) +
         (v_in_registers<T>(keys, dh) ? 0 : (size_t)keys * row_bytes<T>(dh)) +
         sizeof(float) * ((size_t)lq * cols + (size_t)lq * pk + 2 * kWarps * lq + 2 * lq +
                          2 * cluster * lq + (cluster > 1 ? cluster * slice : 0));
}

// The launch at (Lq, Lk, Dh): cluster size, keys a CTA, threads a CTA,
// shared memory a CTA; cluster 0 where max_cluster CTAs cannot hold the
// keys. The caller has checked 1 <= Lq <= kMaxQueries, Lq < Lk, 1 <= Dh <=
// 128, 1 <= max_cluster <= kMaxCluster (below kMaxCluster only to time a
// smaller cluster: chip_smoke.py phase 36 times max_cluster 1).
// tests/test_torch_cross.py keeps the same formula in Python for its twin.
struct Plan {
  int cluster, keys, threads, smem;
};

template <typename T>
inline Plan plan(int lq, int lk, int dh, int max_cluster) {
  for (int c = 1; c <= max_cluster; ++c) {
    const int n = (lk + c - 1) / c, ctas = (lk + n - 1) / n;  // none of them empty
    const size_t s = smem_bytes<T>(lq, n, dh, ctas);
    if (s <= kTargetBytes || (c == max_cluster && s <= kSmemMax))
      return {ctas, n, kThreads, (int)s};
  }
  return {0, 0, 0, 0};
}

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<bf16>(bf16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> __device__ __forceinline__ float rounded(float x) {
  return to_float<T>(from_float<T>(x));
}

// the byte offset of element d of row r in rows of rb bytes
template <typename T> __device__ __forceinline__ int swizzled(int r, int rb, int d) {
  const int b = d * (int)sizeof(T);
  return r * rb + ((((b >> 4) ^ (r & 7))) << 4) + (b & 15);
}

// rows x dh of src (row stride sl) -> the swizzled rows of dst, columns past
// dh zero: 16-byte cp.async (vec) or element loads
template <typename T>
__device__ __forceinline__ void stage_rows(unsigned char* dst, int rb, const T* src,
                                           long long sl, int rows, int dh, bool vec) {
  if (vec) {
    constexpr int per = 16 / (int)sizeof(T);
    const int cpr = rb >> 4;
    for (int i = threadIdx.x; i < rows * cpr; i += kThreads) {
      const int r = i / cpr, c = i - r * cpr;
      const bool real = c * per < dh;  // vec: dh·esize is a 16-byte multiple
      sa::cp_async16(dst + r * rb + ((c ^ (r & 7)) << 4), real ? src + r * sl + c * per : src,
                     real);
    }
  } else {
    const int cols = rb / (int)sizeof(T);
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, d = i - r * cols;
      *reinterpret_cast<T*>(dst + swizzled<T>(r, rb, d)) =
          d < dh ? src[r * sl + d] : sa::zero<T>();
    }
  }
}

// a += q[0:16 bytes of T] · k[same]: element i of the chunk into a[i % 4],
// one fp32 FMA an element (four chains, so that a key's products overlap)
__device__ __forceinline__ void dot16(const float* q, const bf16* k, float (&a)[4]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(k);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  const float4 qa = *reinterpret_cast<const float4*>(q);
  const float4 qb = *reinterpret_cast<const float4*>(q + 4);
  const float qs[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    a[(2 * i) & 3] = fmaf(qs[2 * i], f.x, a[(2 * i) & 3]);
    a[(2 * i + 1) & 3] = fmaf(qs[2 * i + 1], f.y, a[(2 * i + 1) & 3]);
  }
}

__device__ __forceinline__ void dot16(const float* q, const float* k, float (&a)[4]) {
  const float4 kv = *reinterpret_cast<const float4*>(k);
  const float4 qv = *reinterpret_cast<const float4*>(q);
  a[0] = fmaf(qv.x, kv.x, a[0]);
  a[1] = fmaf(qv.y, kv.y, a[1]);
  a[2] = fmaf(qv.z, kv.z, a[2]);
  a[3] = fmaf(qv.w, kv.w, a[3]);
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// the first half of a cluster barrier, with no ordering of memory, and the
// second
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// l · exp(m − mx), 0 for a sum over no key (m = -inf)
__device__ __forceinline__ float rescaled(float l, float m, float mx) {
  return m == -INFINITY ? 0.f : l * expf(m - mx);
}

// the max and the sum of exponentials rescaled to it over the warp, each
// lane holding one pair (a lane with no key: (-inf, 0))
__device__ __forceinline__ void warp_merge(float& m, float& l) {
  float mx = m;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  l = rescaled(l, m, mx);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  m = mx;
}

// One CTA: keys [rank·keys, min(Lk, (rank + 1)·keys)) of the (sequence,
// head) h, all Lq query rows; the cluster's C CTAs together hold all Lk keys.
// VR: V in registers (v_in_registers), else in shared memory.
template <typename T, bool VR>
__device__ __forceinline__ void attend_cross(const sa::HeadPtrs<T>& h, int lq, int lk, int dh,
                                             int keys, float q_scale, bool vec_in) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  // the barrier every CTA passes before another writes into its shared memory
  if (csize > 1) cluster_arrive();
  const int rb = row_bytes<T>(dh), cols = rb / (int)sizeof(T), pk = (keys + 3) / 4 * 4;
  const int k0 = rank * keys, n = min(keys, lk - k0);  // n >= 1 by the plan
  unsigned char* const Ks = smem_raw;
  float* const Ws = reinterpret_cast<float*>(Ks);  // [warp][lq][cols] once S is done
  unsigned char* const Vs = Ks + union_bytes<T>(lq, keys, dh);
  float* const Qs = reinterpret_cast<float*>(Vs + (VR ? 0 : keys * rb));  // [lq][cols]
  float* const Ss = Qs + lq * cols;                                       // [lq][pk]
  float* const wml = Ss + lq * pk;                 // [warp][lq][m, l]
  float* const ml = wml + 2 * kWarps * lq;         // [lq][m, l]
  float* const stats = ml + 2 * lq;                // [rank][lq][m_c, l_c]
  float* const inbox = stats + 2 * csize * lq;     // [rank][slice]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // each warp's keys for P·V: whole 8-row swizzle periods
  const int nwk = ((n + kWarps - 1) / kWarps + 7) / 8 * 8;
  const int j0 = min(n, warp * nwk), j1 = min(n, j0 + nwk);

  // every load of the CTA's share is issued before anything waits: K into
  // shared memory, V into shared memory (a second group that lands while
  // the scores run) or into registers
  stage_rows(Ks, rb, h.k + (long long)k0 * h.k_sl, h.k_sl, n, dh, vec_in);
  sa::cp_async_commit();
  uint32_t vreg[VR ? kRegKeys : 1];
  if constexpr (VR) {
    // bf16 pairs (2·lane, 2·lane + 1) of rows j0.. of V; one 4-byte load
    // where the pair is whole and 4-byte aligned
    const int c = 2 * lane;
    const bf16* vb = h.v + (long long)(k0 + j0) * h.v_sl + c;
    const bool pair = c + 1 < dh;
    const bool word =
        pair && ((reinterpret_cast<uintptr_t>(h.v) | (uintptr_t)(h.v_sl * 2)) & 3) == 0;
#pragma unroll
    for (int u = 0; u < kRegKeys; ++u) {
      uint32_t x = 0;
      if (c < dh && j0 + u < j1) {
        const bf16* e = vb + (long long)u * h.v_sl;
        if (word) {
          x = *reinterpret_cast<const uint32_t*>(e);
        } else {
          x = __bfloat16_as_ushort(e[0]);
          if (pair) x |= (uint32_t)__bfloat16_as_ushort(e[1]) << 16;
        }
      }
      vreg[u] = x;
    }
  } else {
    stage_rows(Vs, rb, h.v + (long long)k0 * h.v_sl, h.v_sl, n, dh, vec_in);
    sa::cp_async_commit();
  }
  // q · scale rounded to T, held in fp32; columns past Dh zero
  for (int i = threadIdx.x; i < lq * cols; i += kThreads) {
    const int r = i / cols, d = i - r * cols;
    Qs[i] = d < dh ? rounded<T>(to_float<T>(h.q[r * h.q_sl + d]) * q_scale) : 0.f;
  }
  if constexpr (VR) sa::cp_async_wait<0>(); else sa::cp_async_wait<1>();  // K
  __syncthreads();

  // S = q·kᵀ, a thread a key, and with it each thread's running max and sum
  // of exponentials of each row, merged over the warp
  constexpr int per = 16 / (int)sizeof(T);
  const int chunks = (dh + per - 1) / per;
  for (int r = 0; r < lq; ++r) {
    const float* qr = Qs + r * cols;
    float m = -INFINITY, l = 0.f;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const unsigned char* kr = Ks + j * rb;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int c = 0; c < chunks; ++c)
        dot16(qr + c * per, reinterpret_cast<const T*>(kr + ((c ^ (j & 7)) << 4)), a);
      const float s = (a[0] + a[1]) + (a[2] + a[3]);
      Ss[r * pk + j] = s;
      if (s > m) {
        l = rescaled(l, m, s) + 1.f;
        m = s;
      } else {
        l += expf(s - m);
      }
    }
    warp_merge(m, l);
    if (lane == 0) {
      wml[2 * (warp * lq + r)] = m;
      wml[2 * (warp * lq + r) + 1] = l;
    }
  }
  __syncthreads();
  // each row's (m, l) over the CTA's keys, its warps' in order; with a
  // cluster sent to every CTA (rank order in each inbox), then merged there
  // in rank order: the same numbers in every CTA
  if (csize > 1) cluster_wait();
  if (threadIdx.x < lq) {
    const int r = threadIdx.x;
    float m = -INFINITY, l = 0.f;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wml[2 * (w * lq + r)]);
    for (int w = 0; w < kWarps; ++w) l += rescaled(wml[2 * (w * lq + r) + 1], wml[2 * (w * lq + r)], m);
    if (csize == 1) {
      ml[2 * r] = m;
      ml[2 * r + 1] = l;
    } else {
      for (int c = 0; c < csize; ++c) {
        float* to = cluster.map_shared_rank(stats, c) + 2 * (rank * lq + r);
        to[0] = m;
        to[1] = l;
      }
    }
  }
  if (csize > 1) {
    cluster.sync();
    if (threadIdx.x < lq) {
      const int r = threadIdx.x;
      float m = -INFINITY, l = 0.f;
      for (int c = 0; c < csize; ++c) m = fmaxf(m, stats[2 * (c * lq + r)]);
      for (int c = 0; c < csize; ++c)
        l += rescaled(stats[2 * (c * lq + r) + 1], stats[2 * (c * lq + r)], m);
      ml[2 * r] = m;
      ml[2 * r + 1] = l;
    }
  }
  __syncthreads();
  // P = exp(S − m) / l, rounded to T, in place; the rows' padding zero
  for (int i = threadIdx.x; i < lq * pk; i += kThreads) {
    const int r = i / pk, j = i - r * pk;
    Ss[i] = j < n ? rounded<T>(expf(Ss[i] - ml[2 * r]) / ml[2 * r + 1]) : 0.f;
  }
  if constexpr (!VR) sa::cp_async_wait<0>();  // V
  __syncthreads();

  // each warp's P·V over its keys, lanes on column pairs
  if constexpr (VR) {
    for (int r = 0; r < lq; ++r) {
      const float* p = Ss + r * pk + j0;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int u = 0; u < kRegKeys; u += 4) {
        // rows past j1: V zero, and P finite (a later warp's) or zero
        const float4 p4 = j0 + u < j1 ? *reinterpret_cast<const float4*>(p + u)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
        const float ps[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&vreg[u + t]));
          a0 = fmaf(ps[t], v.x, a0);
          a1 = fmaf(ps[t], v.y, a1);
        }
      }
      if (2 * lane < dh)
        *reinterpret_cast<float2*>(Ws + (warp * lq + r) * cols + 2 * lane) = make_float2(a0, a1);
    }
  } else {
    // at most two column pairs a lane at Dh <= 128; a row's swizzled offsets
    // of the lane's columns are fixed for each row mod 8
    int off[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) off[i][u] = swizzled<T>(u, rb, 2 * lane + 64 * i) - u * rb;
    const bool col[2] = {2 * lane < dh, 2 * lane + 64 < dh};
    for (int r = 0; r < lq; ++r) {
      const float* p = Ss + r * pk;
      float a[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
      int j = j0;
      for (; j + 8 <= j1; j += 8) {
        const unsigned char* vr = Vs + j * rb;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float pj = p[j + u];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (col[i]) {
              const float2 v = load2(reinterpret_cast<const T*>(vr + u * rb + off[i][u]));
              a[i][0] = fmaf(pj, v.x, a[i][0]);
              a[i][1] = fmaf(pj, v.y, a[i][1]);
            }
          }
        }
      }
      for (; j < j1; ++j) {  // the last rows
        const float pj = p[j];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (col[i]) {
            const float2 v =
                load2(reinterpret_cast<const T*>(Vs + swizzled<T>(j, rb, 2 * lane + 64 * i)));
            a[i][0] = fmaf(pj, v.x, a[i][0]);
            a[i][1] = fmaf(pj, v.y, a[i][1]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (col[i])
          *reinterpret_cast<float2*>(Ws + (warp * lq + r) * cols + 2 * lane + 64 * i) =
              make_float2(a[i][0], a[i][1]);
    }
  }
  __syncthreads();

  // the CTA's partial of each output, its warps' in order; one CTA writes it,
  // a cluster sends each CTA its slice and sums the slices in rank order
  const int total = lq * dh, slice = (total + csize - 1) / csize;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += Ws[(w * lq + r) * cols + d];
    if (csize == 1) {
      h.o[r * h.o_sl + d] = from_float<T>(acc);
    } else {
      const int owner = i / slice;
      *(cluster.map_shared_rank(inbox, owner) + rank * slice + (i - owner * slice)) = acc;
    }
  }
  if (csize == 1) return;
  cluster.sync();  // every slice in its owner's inbox
  for (int i = rank * slice + threadIdx.x; i < min(total, (rank + 1) * slice); i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    float acc = 0.f;
    for (int c = 0; c < csize; ++c) acc += inbox[c * slice + (i - rank * slice)];
    h.o[r * h.o_sl + d] = from_float<T>(acc);
  }
}

}  // namespace ca
