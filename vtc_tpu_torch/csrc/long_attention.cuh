// Heads-packed multi-head attention past the short tile (L > 128), forward:
// the long route of fused_mha (csrc/fused_mha.cu, entry vtc_fused_mha_long).
//
// Not a port of a Pallas kernel: the JAX package runs these lengths (the
// ViT-B/16 tower at L = 197, ViT-L/14 at 257) through XLA attention,
// vtc_tpu/models/layers.py:269-290 (MultiHeadAttention; its Pallas
// fused_mha refuses L > 128). Contract, that of fused_mha_plain (the short
// tile's): q scaled by Dh^-0.5 in q's type, QK^T in fp32, optional causal
// mask, softmax in fp32, the normalised P rounded to q's type, P@V with an
// fp32 accumulator, output rounded to q's type.
//
// Bounds on the H100, ViT-B/16 at batch 64 (L = 197, Dh = 64, 768 heads),
// and what the one-pass kernel below does about each:
// - bytes, 23.1 µs (q, k, v read once and o written once, 4·B·L·E bf16
//   elements): each head's K and V come from memory once for all its query
//   rows, q once, o once;
// - tensor work, 7.7 µs (4·B·H·L²·Dh flops at the dense bf16 peak): S is
//   computed once (mma.sync), and keys are padded to 16, not to 64;
// - the exponentials, ≈ 8 µs on the SFUs (B·H·L² = 29.8 M, one ex2 each):
//   one expf a score.
// None of these sets its pace: the CUDA cores' work per score does. expf
// is 9 instructions (its range reduction keeps PyTorch's bits), the
// contract's normalisation and the rounding rule below add more, and 29.8 M
// scores at ≈ 19 instructions are ≈ 20 µs of issue on 132 SMs before any
// stall.
//
// Two kernels: bf16 takes the first up to L = 272 and the second past it, a
// choice by L alone; fp32, the parity path, always takes the second
// (long_plan in fused_mha.cu, which ops.attention.long_plan reads).
//
// One pass (bf16, L <= kOnePassMaxL = 272: the ViT-B/16 and ViT-L/14
// towers). One block per (sequence, head) stages the head's K and V once,
// whole, in shared memory (cp.async; V in a second group that lands while
// the first scores run), so each byte of K and V is read from memory once
// for all the head's query rows. A pair of warps takes each 16-row query
// tile (197 rows run as 208): each warp holds S for half the keys in
// registers (13 key tiles of 8 a warp at L <= 208, 17 up to 272), so S is
// computed once, in fp32, and kept on chip until the row's max m and sum l
// are final; the pair trades the two halves' max and sum through shared
// memory. Then P = exp(S − m) · (1/l), one expf a score and one reciprocal
// a row, is rounded to bf16 and packed in place (half S's registers) before
// P·V needs its accumulators, and O = P·V over each warp's keys is added,
// warp 0's plus warp 1's, in fp32. Every loop runs its whole compile-time count, with no branch inside
// (below): no barrier but the pair's, 3 a tile, after the block's first two.
//
// The rounding, against the contract's P normalised before it is rounded
// (an online softmax that rescales O after rounding the unnormalised P
// misses the plain version by a bf16 ulp at a visible share of outputs): an
// mma's fp32 accumulation does not round to nearest as cuBLAS's FMAs do, so
// a long chain of mmas into one accumulator drifts from the plain version's
// sums, which over L keys flips the bf16 rounding of a growing share of
// outputs (chip_smoke.py phase 26 reads the share on 8 inputs at each L,
// beside the CPU's plain version's). Each 32-key step of P·V starts from a
// zeroed accumulator and is added to O on the CUDA cores, rounded to
// nearest. S chains a key tile's Dh/16 k = 16 products (4 at Dh <= 64, 8
// at Dh = 128) in one accumulator from zero, and P is e · (1/l), from one
// reciprocal a row. Each was timed and held to the share beside the
// two-pass kernel's rule (each k = 8 product of S from zero, added in fp32;
// P = e / l) and, at Dh = 128, beside two chains of 4 added in fp32
// (vtc_tpu_torch/scripts/bench_long_variants.py; PERF.md §6): it held every
// reading at the better time, and the two chains spilled at 17 key tiles.
// Registers: 159-168 at Dh <= 64 (12 warps an SM), 182-219 at Dh = 128, no
// spills (ptxas -v, logged by chip_smoke.py's build phase).
//
// Two passes (fp32, the parity path, and bf16 past L = 272, where S would
// not fit in registers): one block per (sequence, head, 64-row query tile), 4
// warps of 16 query rows. The block stages its Q tile once, then streams K
// (and V) in tiles of 64 keys through two shared buffers with cp.async
// (sa::stage), each tile in steps of 32 keys so that a warp's S is 16
// registers a lane and 4 blocks fit an SM in bf16:
//
// - pass 1: S = Q·Kᵀ (mma.sync.m16n8k8 for bf16, CUDA-core FMAs for fp32,
//   as the short tile), each row's running max m and its sum l of
//   exponentials rescaled to it, in fp32;
// - pass 2: S again, P = exp(S − m) / l with the final m and l (expf and an
//   IEEE division, as PyTorch's softmax), P rounded to q's type, and O +=
//   P·V in fp32, each k = 8 product of S from zero, added in fp32.
//
// Causal: the two-pass kernel skips key tiles past a query tile's diagonal
// and masks per element; the one-pass kernel masks per element the tiles
// that hold a masked key.
//
// Fewer queries than keys (Lq < Lk, no mask: the joint TimeSformer's CLS row,
// 1 query over 1 + T·N keys, models/timesformer_joint.py): the two-pass
// kernel with its query rows to Lq and its keys to Lk (entry
// vtc_fused_mha_long in fused_mha.cu, at Lq < Lk). At Lq = 1 a block's 4 warps run one
// real row and three of zeros, which are not stored: a simple kernel, whose
// work is 2 launches a block of the joint tower.

#pragma once

#include <type_traits>

#include "short_attention.cuh"

namespace la {

using sa::bf16;

constexpr int kWarps = 4;                // one per 16 query rows
constexpr int kQueryRows = 16 * kWarps;  // query rows per block
constexpr int kThreads = 32 * kWarps;
constexpr int kKeyRows = 64;             // keys per K/V tile
constexpr int kStepKeys = 32;            // keys per softmax step, S in registers
constexpr int kSub = kStepKeys / 8;      // 8-key fragments per step

// blocks per SM the registers are budgeted for: 4 for bf16 heads of Dh <= 64
// (at most 128 registers), else 2 (255), where fp32's FMA loops and Dh = 128's
// fragments would spill at 128
template <typename T> constexpr int min_blocks(int dc) {
  return std::is_same<T, bf16>::value && dc <= 4 ? 4 : 2;
}

// exp(s − m) for the row max m, by expf as PyTorch's softmax computes it (the
// short tile's exp2 of log2-scaled scores is a few fp32 ulps off it, which
// flips more of P's bf16 roundings against the plain version over L keys)
__device__ __forceinline__ float exp_shifted(float s, float m) { return expf(s - m); }

// shared memory: the Q tile, two K and two V tiles
template <typename T> __host__ __device__ inline size_t smem_bytes(int dh) {
  return sizeof(T) * (size_t)(kQueryRows + 4 * kKeyRows) * sa::row_stride<T>(dh);
}

// d = a·b over k = 8 (mma.m16n8k8): {a0, a1} is one k-half of an m16n8k16
// A fragment, b one register of its B fragment
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0, uint32_t a1,
                                            uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// s += one k = 16 chunk of Q·Kᵀ, as two k = 8 products into zeroed
// accumulators added in fp32, rounded to nearest
__device__ __forceinline__ void add_chunk(float (&s)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16_k8(t0, a[0], a[1], b0);
  mma_bf16_k8(t1, a[2], a[3], b1);
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] += t0[i] + t1[i];
}

// ---- S for the warp's 16 query rows against one step's keys ------------------
//
// Ks points at the step's first staged key. s[j][e] = S[row q0 + g + 8·(e >>
// 1)][key 8·j + 2·t + (e & 1)] of the step (lane = 4·g + t), the mma
// accumulator layout of short_attention.cuh.

template <int DC>
__device__ __forceinline__ void tile_scores(const uint32_t (&qf)[DC][4], const bf16* Ks,
                                            int rs, int dh_p, float (&s)[kSub][4]) {
  const int lane = threadIdx.x & 31;
  const int dc = dh_p / 16;
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const bf16* krow = Ks + (8 * j + (lane & 7)) * rs;
#pragma unroll
    for (int c = 0; c < DC; c += 2) {
      if (c < dc) {
        // chunks c and c + 1 in one ldmatrix; past Dh the upper half re-reads
        // chunk c and goes unused
        int col = 16 * c + 8 * (lane >> 3);
        if (col >= dh_p) col -= 16;
        uint32_t kb[4];
        sa::ldsm_x4(kb, krow + col);
        add_chunk(s[j], qf[c], kb[0], kb[1]);
        if (c + 1 < dc) add_chunk(s[j], qf[c + 1], kb[2], kb[3]);
      }
    }
  }
}

// fp32: q from the warp's rows of Qs, already scaled
template <int DC>
__device__ __forceinline__ void tile_scores(const float* Qs, const float* Ks, int rs,
                                            int q0, int dh_p, float (&s)[kSub][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* qa = Qs + (q0 + g) * rs;
  const float* qb = qa + 8 * rs;
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const float* ka = Ks + (8 * j + 2 * t) * rs;
    const float* kb = ka + rs;
#pragma unroll 2
    for (int d = 0; d < dh_p; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(qa + d);
      const float4 y = *reinterpret_cast<const float4*>(qb + d);
      const float4 u = *reinterpret_cast<const float4*>(ka + d);
      const float4 w = *reinterpret_cast<const float4*>(kb + d);
      s[j][0] = fmaf(x.w, u.w, fmaf(x.z, u.z, fmaf(x.y, u.y, fmaf(x.x, u.x, s[j][0]))));
      s[j][1] = fmaf(x.w, w.w, fmaf(x.z, w.z, fmaf(x.y, w.y, fmaf(x.x, w.x, s[j][1]))));
      s[j][2] = fmaf(y.w, u.w, fmaf(y.z, u.z, fmaf(y.y, u.y, fmaf(y.x, u.x, s[j][2]))));
      s[j][3] = fmaf(y.w, w.w, fmaf(y.z, w.z, fmaf(y.y, w.y, fmaf(y.x, w.x, s[j][3]))));
    }
  }
}

// keys past L, and with `causal` keys past the row, are -inf
__device__ __forceinline__ void mask_tile(float (&s)[kSub][4], int row0, int k0, int L,
                                          int causal) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1), key = k0 + 8 * j + 2 * t + (e & 1);
      if (key >= L || (causal && key > row)) s[j][e] = -INFINITY;
    }
  }
}

// ---- O += P·V for one step's staged V rows -----------------------------------

template <int DC>
__device__ __forceinline__ void tile_values(const bf16* Vs, int rs, int dh_p,
                                            const float (&p)[kSub][4],
                                            float (&o)[2 * DC][4]) {
  const int lane = threadIdx.x & 31;
  const int dc = dh_p / 16;
  // P rounded to bf16 as the A operand: 8-key fragments 2·kc and 2·kc + 1
  // make one k = 16 chunk
#pragma unroll
  for (int kc = 0; kc < kSub / 2; ++kc) {
    const uint32_t a[4] = {sa::pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                           sa::pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                           sa::pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                           sa::pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
    const bf16* vrow = Vs + (16 * kc + (lane & 7) + 8 * ((lane >> 3) & 1)) * rs;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      if (c < dc) {
        uint32_t vb[4];
        sa::ldsm_x4_trans(vb, vrow + 16 * c + 8 * (lane >> 4));
        sa::mma_bf16(o[2 * c], a, vb[0], vb[1]);
        sa::mma_bf16(o[2 * c + 1], a, vb[2], vb[3]);
      }
    }
  }
}

template <int DC>
__device__ __forceinline__ void tile_values(const float* Vs, int rs, int dh_p,
                                            const float (&p)[kSub][4],
                                            float (&o)[2 * DC][4]) {
  // the quad's lane t2 holds keys 8·j + 2·t2, +1 of both rows; this lane
  // owns columns 8·nt + 2·t, +1
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int ntc = dh_p / 8;
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
#pragma unroll
    for (int t2 = 0; t2 < 4; ++t2) {
      const int src = (lane & ~3) | t2;
      const float a0 = __shfl_sync(0xffffffffu, p[j][0], src);
      const float a1 = __shfl_sync(0xffffffffu, p[j][1], src);
      const float b0 = __shfl_sync(0xffffffffu, p[j][2], src);
      const float b1 = __shfl_sync(0xffffffffu, p[j][3], src);
      const float* v0 = Vs + (8 * j + 2 * t2) * rs + 2 * t;
      const float* v1 = v0 + rs;
#pragma unroll
      for (int nt = 0; nt < 2 * DC; ++nt) {
        if (nt < ntc) {
          const float2 x = *reinterpret_cast<const float2*>(v0 + 8 * nt);
          const float2 y = *reinterpret_cast<const float2*>(v1 + 8 * nt);
          o[nt][0] = fmaf(a1, y.x, fmaf(a0, x.x, o[nt][0]));
          o[nt][1] = fmaf(a1, y.y, fmaf(a0, x.y, o[nt][1]));
          o[nt][2] = fmaf(b1, y.x, fmaf(b0, x.x, o[nt][2]));
          o[nt][3] = fmaf(b1, y.y, fmaf(b0, x.y, o[nt][3]));
        }
      }
    }
  }
}

// ---- one block: one (sequence, head), one 64-row query tile ----------------------

// h: the (sequence, head)'s first rows and row strides; Lq query rows attend
// over Lk keys (Lq = Lk with `causal`)
template <typename T, int DC>
__device__ __forceinline__ void attend_long(const sa::HeadPtrs<T>& h, int Lq, int Lk, int dh,
                                            int causal, float q_scale, bool vec_in,
                                            bool vec_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rs = sa::row_stride<T>(dh), dh_p = sa::padded_dh(dh);
  const int tile = kKeyRows * rs;
  T* const Qs = reinterpret_cast<T*>(smem_raw);
  T* const Ks = Qs + kQueryRows * rs;  // two buffers
  T* const Vs = Ks + 2 * tile;         // two buffers

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qt0 = kQueryRows * blockIdx.y;  // the block's first query row
  const int q0 = 16 * warp;                  // the warp's first row in the tile
  // the keys: all of them, or with `causal` those up to the tile's last row
  const int k_end = min(Lk, causal ? qt0 + kQueryRows : Lk);
  const int n_kt = (k_end + kKeyRows - 1) / kKeyRows;
  auto stage_k = [&](int j) {
    const int k0 = kKeyRows * j;
    sa::stage(Ks + (j & 1) * tile, rs, h.k + k0 * h.k_sl, h.k_sl, min(kKeyRows, Lk - k0),
              kKeyRows, dh, vec_in);
  };
  auto stage_v = [&](int j) {
    const int k0 = kKeyRows * j;
    sa::stage(Vs + (j & 1) * tile, rs, h.v + k0 * h.v_sl, h.v_sl, min(kKeyRows, Lk - k0),
              kKeyRows, dh, vec_in);
  };

  // Q (rows past Lq zero) and the first K tile
  sa::stage(Qs, rs, h.q + qt0 * h.q_sl, h.q_sl, min(kQueryRows, Lq - qt0), kQueryRows, dh,
            vec_in);
  stage_k(0);
  sa::cp_async_commit();
  sa::cp_async_wait<0>();
  __syncthreads();

  // q · scale in q's type: bf16 in the A fragments, fp32 in the warp's rows
  uint32_t qf[DC][4];
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      if (c < dh_p / 16) {
        sa::ldsm_x4(qf[c], Qs + (q0 + (lane & 15)) * rs + 16 * c + 8 * (lane >> 4));
#pragma unroll
        for (int i = 0; i < 4; ++i) qf[c][i] = sa::scale_bf16x2(qf[c][i], q_scale);
      }
    }
  } else {
    for (int i = lane; i < 16 * dh_p; i += 32) Qs[(q0 + i / dh_p) * rs + i % dh_p] *= q_scale;
    __syncwarp();
  }
  // S of tile j's keys [kStepKeys·st, kStepKeys·(st + 1)), masked
  auto scores = [&](int j, int st, float (&s)[kSub][4]) {
    const T* k = Ks + (j & 1) * tile + kStepKeys * st * rs;
    if constexpr (std::is_same<T, bf16>::value) {
      tile_scores<DC>(qf, k, rs, dh_p, s);
    } else {
      tile_scores<DC>(Qs, k, rs, q0, dh_p, s);
    }
    // a step of real keys needs no mask without `causal`
    const int k0 = kKeyRows * j + kStepKeys * st;
    if (causal || k0 + kStepKeys > Lk) mask_tile(s, qt0 + q0, k0, Lk, causal);
  };
  // a step past the last key (of the tile's last row, with `causal`) is skipped
  auto past_end = [&](int j, int st) { return kKeyRows * j + kStepKeys * st >= k_end; };

  // pass 1: each row's max m and Σ exp(S − m), per lane, rescaled as m grows
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) {
      stage_k(j + 1);
      sa::cp_async_commit();
    }
#pragma unroll
    for (int st = 0; st < kKeyRows / kStepKeys; ++st) {
      if (past_end(j, st)) break;
      float s[kSub][4];
      scores(j, st, s);
      float t0 = m0, t1 = m1;
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        t0 = fmaxf(t0, fmaxf(s[i][0], s[i][1]));
        t1 = fmaxf(t1, fmaxf(s[i][2], s[i][3]));
      }
      t0 = sa::quad_max(t0);
      t1 = sa::quad_max(t1);
      // every row has a key in the first step, so t0, t1 are finite from here
      l0 *= exp_shifted(m0, t0);
      l1 *= exp_shifted(m1, t1);
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        l0 += exp_shifted(s[i][0], t0) + exp_shifted(s[i][1], t0);
        l1 += exp_shifted(s[i][2], t1) + exp_shifted(s[i][3], t1);
      }
      m0 = t0;
      m1 = t1;
    }
    sa::cp_async_wait<0>();
    __syncthreads();
  }
  // each row's Σ exp(S − m); P = e / l is divided, not multiplied by 1 / l
  const float l0s = sa::quad_sum(l0), l1s = sa::quad_sum(l1);

  // pass 2: P = exp(S − m) / l, rounded to T in tile_values, and O += P·V
  float o[2 * DC][4];
#pragma unroll
  for (int nt = 0; nt < 2 * DC; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  stage_k(0);
  stage_v(0);
  sa::cp_async_commit();
  sa::cp_async_wait<0>();
  __syncthreads();
  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) {
      stage_k(j + 1);
      stage_v(j + 1);
      sa::cp_async_commit();
    }
#pragma unroll
    for (int st = 0; st < kKeyRows / kStepKeys; ++st) {
      if (past_end(j, st)) break;
      float s[kSub][4];
      scores(j, st, s);
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        s[i][0] = exp_shifted(s[i][0], m0) / l0s;
        s[i][1] = exp_shifted(s[i][1], m0) / l0s;
        s[i][2] = exp_shifted(s[i][2], m1) / l1s;
        s[i][3] = exp_shifted(s[i][3], m1) / l1s;
      }
      const T* v = Vs + (j & 1) * tile + kStepKeys * st * rs;
      if constexpr (std::is_same<T, bf16>::value) {
        // the step's P·V from zero on the tensor cores, added to O rounded
        // to nearest
        float ot[2 * DC][4];
#pragma unroll
        for (int nt = 0; nt < 2 * DC; ++nt) ot[nt][0] = ot[nt][1] = ot[nt][2] = ot[nt][3] = 0.f;
        tile_values<DC>(v, rs, dh_p, s, ot);
#pragma unroll
        for (int nt = 0; nt < 2 * DC; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[nt][i] += ot[nt][i];
      } else {
        tile_values<DC>(v, rs, dh_p, s, o);
      }
    }
    sa::cp_async_wait<0>();
    __syncthreads();
  }
  // the warp's own Q rows stage the output (its Q is no longer read)
  sa::store_tile<DC>(o, Qs, rs, q0, min(kQueryRows, Lq - qt0), dh, h.o + qt0 * h.o_sl,
                     h.o_sl, vec_out);
}


// ---- the one-pass kernel: one block per (sequence, head) ----------------------
//
// A pair of warps takes each 16-row query tile: warp i of the pair holds S
// for key tiles of 8 [i·T, (i + 1)·T), T = one_pass_tiles(L): 13 (the pair's
// 208 keys are ViT-B/16's 197 padded to 16) or 17 (ViT-L/14's 257 padded to
// 272). P·V takes a warp's keys 16 at a time, and an odd last tile alone, as
// a k = 8 product. Every loop runs its whole compile-time count, with no
// branch inside: q, k and v are staged with their columns zero-filled to
// 16·DC and K and V with their rows zero-filled to the pair's 16·T keys, so
// a padded column adds 0 to S and a padded key, masked to -inf, gets P = 0
// against a zero V row. (Runtime guards per chunk had made the compiler
// keep S in local memory across the branches' joins.)
constexpr int kOnePassMaxL = 272;
__host__ __device__ constexpr int one_pass_tiles(int L) { return L <= 208 ? 13 : 17; }
// the shared row stride at DC chunks of 16 columns: +16 bytes, as sa::row_stride
__host__ __device__ constexpr int one_pass_stride(int dc) { return 16 * dc + 8; }
// pairs a block, and blocks an SM the registers are budgeted for: at Dh <=
// 64, 2 blocks of 3 pairs, 12 warps an SM, 3 on each scheduler (at most 168
// registers: the scheduler's 16,384 over its 3 warps; at 4 pairs, 128, the
// instances spilled and ran no faster); Dh = 128 (q's fragments twice as
// large), 1 block (at most 255)
constexpr int kOnePassPairs = 3;
__host__ __device__ constexpr int one_pass_min_blocks(int dc) { return dc > 4 ? 1 : 2; }

// shared memory: K and V of the head (16·T rows each), then each pair's 16
// staged rows (its Q tile, then its output), its exchange of the rows' max
// and sum (2 × 2 × 16 fp32) and of warp 1's partial O over 64 columns (fp32,
// 32 lanes × 8 fragments of 4)
constexpr int kExchangeFloats = 4 * 16 + 32 * 8 * 4;
__host__ __device__ inline size_t one_pass_smem(int L, int dh) {
  const int dc = dh <= 64 ? 4 : 8;
  return sizeof(bf16) * (size_t)(2 * 16 * one_pass_tiles(L) + 16 * kOnePassPairs) *
             one_pass_stride(dc) +
         (size_t)kOnePassPairs * kExchangeFloats * sizeof(float);
}

__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(pair + 1) : "memory");
}

// rows x cols of src (row stride sl) -> fill_rows x COLS of dst (row stride
// rs), zero past `rows` and `cols`; threads tid, tid + n, ... of the copy take
// part, with 16-byte cp.async where `vec` (cols a multiple of 8), else
// element loads
template <int COLS>
__device__ __forceinline__ void stage_rows(bf16* dst, int rs, const bf16* src, long long sl,
                                           int rows, int fill_rows, int cols, bool vec,
                                           int tid, int n) {
  if (vec) {
    constexpr int cpr = COLS / 8;  // copies a row
    for (int i = tid; i < fill_rows * cpr; i += n) {
      const int r = i / cpr, c = 8 * (i % cpr);
      const bool real = r < rows && c < cols;
      sa::cp_async16(dst + r * rs + c, real ? src + r * sl + c : src, real);
    }
  } else {
    for (int i = tid; i < fill_rows * COLS; i += n) {
      const int r = i / COLS, c = i % COLS;
      dst[r * rs + c] = r < rows && c < cols ? src[r * sl + c] : sa::zero<bf16>();
    }
  }
}

// x · s for a pair of bf16, rounded to bf16 (nearest even): the product of
// two bf16 is exact before its one rounding, as q * asarray(s, bf16) rounds
// it; the addend -0 keeps the product's sign of zero
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t x, uint32_t s) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(x), "r"(s), "r"(0x80008000u));
  return d;
}

// S of the warp's 16 rows against its T key tiles from Kw, in the mma
// accumulator layout: s[j][e] = S[row g + 8·(e >> 1)][key 8·j + 2·t + (e &
// 1)] (lane = 4·g + t); a key tile's Dh/16 k = 16 products chained from zero
template <int T, int DC>
__device__ __forceinline__ void one_pass_scores(const uint32_t (&qf)[DC][4], const bf16* Kw,
                                                float (&s)[T][4]) {
  constexpr int RS = one_pass_stride(DC);
  const int lane = threadIdx.x & 31;
  // chunks c and c + 1 in one ldmatrix
  const bf16* const k_lane = Kw + (lane & 7) * RS + 8 * (lane >> 3);
#pragma unroll
  for (int j = 0; j < T; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; c += 2) {
      uint32_t kb[4];
      sa::ldsm_x4(kb, k_lane + 8 * j * RS + 16 * c);
      sa::mma_bf16(s[j], qf[c], kb[0], kb[1]);
      sa::mma_bf16(s[j], qf[c + 1], kb[2], kb[3]);
    }
  }
}

// one block: one (sequence, head); its pairs of warps walk the 16-row query
// tiles. q_rows(r0), o_rows(r0): the addresses of the head's q and output
// at row r0 (h.q and h.o are not read), recomputed at each tile
template <int T, int DC, class QRows, class ORows>
__device__ __forceinline__ void attend_one_pass(const sa::HeadPtrs<bf16>& h,
                                                const QRows& q_rows, const ORows& o_rows,
                                                int L, int dh,
                                                int causal, float q_scale, bool vec_in,
                                                bool vec_out) {
  constexpr int P = kOnePassPairs, RS = one_pass_stride(DC), KP = 16 * T;  // keys a pair
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int pair = threadIdx.x >> 6, half = (threadIdx.x >> 5) & 1;
  bf16* const Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* const Vs = Ks + KP * RS;
  bf16* const Qs = Vs + KP * RS + 16 * pair * RS;  // the pair's Q tile, then its output
  float* const xm = reinterpret_cast<float*>(Vs + KP * RS + 16 * P * RS) +
                    pair * kExchangeFloats;  // [2][16] max, [2][16] sum
  float* const xl = xm + 2 * 16;
  float4* const xo = reinterpret_cast<float4*>(xm + 4 * 16);  // warp 1's O, [8][32]
  const int k0w = 8 * T * half;  // the warp's first key
  const uint32_t scale2 = sa::pack_bf16(q_scale, q_scale);

  // K (rows past L zero) with each pair's first Q tile, then V
  if (16 * pair < L)
    stage_rows<16 * DC>(Qs, RS, q_rows(16 * pair), h.q_sl, min(16, L - 16 * pair), 16, dh,
                        vec_in, threadIdx.x & 63, 64);
  stage_rows<16 * DC>(Ks, RS, h.k, h.k_sl, L, KP, dh, vec_in, threadIdx.x, 64 * P);
  sa::cp_async_commit();
  stage_rows<16 * DC>(Vs, RS, h.v, h.v_sl, L, KP, dh, vec_in, threadIdx.x, 64 * P);
  sa::cp_async_commit();
  sa::cp_async_wait<1>();
  __syncthreads();

  for (int qt = pair, it = 0;; qt += P, ++it) {
    const bool has = 16 * qt < L;
    if (!has && it > 0) break;
    const int r0 = 16 * qt;
    uint32_t pk[T][2];  // P rounded to bf16, the A fragments of P·V
    if (has) {
      if (it > 0) {
        stage_rows<16 * DC>(Qs, RS, q_rows(r0), h.q_sl, min(16, L - r0), 16, dh, vec_in,
                            threadIdx.x & 63, 64);
        sa::cp_async_commit();
        sa::cp_async_wait<0>();
        pair_sync(pair);
      }
      // q · scale in bf16, as A fragments
      uint32_t qf[DC][4];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        sa::ldsm_x4(qf[c], Qs + (lane & 15) * RS + 16 * c + 8 * (lane >> 4));
#pragma unroll
        for (int i = 0; i < 4; ++i) qf[c][i] = mul_bf16x2(qf[c][i], scale2);
      }
      float s[T][4];
      one_pass_scores<T, DC>(qf, Ks + k0w * RS, s);

      // keys past L, and with `causal` keys past the row, are -inf (a
      // warp-uniform test skips each tile none of whose keys is); then each
      // row's max over the pair
      const int kmin = causal ? min(L, r0 + 1) : L;  // the least row's key bound
      const int kmax0 = causal ? min(L, r0 + g + 1) : L, kmax1 = causal ? min(L, r0 + g + 9) : L;
#pragma unroll
      for (int j = 0; j < T; ++j) {
        if (k0w + 8 * j + 8 > kmin) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0w + 8 * j + 2 * t + (e & 1);
            s[j][e] = key < (e < 2 ? kmax0 : kmax1) ? s[j][e] : -INFINITY;
          }
        }
      }
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < T; ++j) {
        m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
        m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
      }
      m0 = sa::quad_max(m0);
      m1 = sa::quad_max(m1);
      if (t == 0) {
        xm[16 * half + g] = m0;
        xm[16 * half + g + 8] = m1;
      }
      pair_sync(pair);
      m0 = fmaxf(xm[g], xm[16 + g]);
      m1 = fmaxf(xm[g + 8], xm[16 + g + 8]);
      // e = exp(S − m) in place; l = Σ e over the final m, warp 0's keys'
      // sum plus warp 1's
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int j = 0; j < T; ++j) {
        s[j][0] = exp_shifted(s[j][0], m0);
        s[j][1] = exp_shifted(s[j][1], m0);
        s[j][2] = exp_shifted(s[j][2], m1);
        s[j][3] = exp_shifted(s[j][3], m1);
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
      l0 = sa::quad_sum(l0);
      l1 = sa::quad_sum(l1);
      if (t == 0) {
        xl[16 * half + g] = l0;
        xl[16 * half + g + 8] = l1;
      }
      pair_sync(pair);
      l0 = xl[g] + xl[16 + g];
      l1 = xl[g + 8] + xl[16 + g + 8];
      // P = e · (1/l), rounded to bf16 and packed
      const float i0 = __frcp_rn(l0), i1 = __frcp_rn(l1);
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const float p[4] = {s[j][0] * i0, s[j][1] * i0, s[j][2] * i1, s[j][3] * i1};
        pk[j][0] = sa::pack_bf16(p[0], p[1]);
        pk[j][1] = sa::pack_bf16(p[2], p[3]);
      }
    }
    if (it == 0) {  // V
      sa::cp_async_wait<0>();
      __syncthreads();
    }
    if (!has) break;

    // O = P·V over the warp's keys, 64 columns (4 chunks of 16) at a time:
    // each step of two k = 16 chunks (32 keys), and an odd last tile, from
    // zero on the tensor cores, added to O in fp32, rounded to nearest (so
    // Dh = 128 keeps 32 fp32 of O, not 64); then O = warp 0's sum
    // plus warp 1's, staged in bf16 in the pair's output rows by warp 0
    const bf16* const v_lane =
        Vs + (k0w + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS + 8 * (lane >> 4);
    // the last tile's 8 keys: lanes 8·i .. 8·i + 7 address the 8 × 8 block at
    // columns 8·i (.trans: each a B fragment of m16n8k8)
    const bf16* const v_tail = Vs + (k0w + 8 * (T - 1) + (lane & 7)) * RS + 8 * (lane >> 3);
#pragma unroll
    for (int cb = 0; cb < DC / 4; ++cb) {
      float o[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
      for (int st = 0; st < (T / 2 + 1) / 2; ++st) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // the first step sums into O itself, which is zero there
          float ot[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          float (&acc0)[4] = st == 0 ? o[2 * c] : ot[0];
          float (&acc1)[4] = st == 0 ? o[2 * c + 1] : ot[1];
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const int kc = 2 * st + kk;
            if (kc < T / 2) {
              const uint32_t a[4] = {pk[2 * kc][0], pk[2 * kc][1], pk[2 * kc + 1][0],
                                     pk[2 * kc + 1][1]};
              uint32_t vb[4];
              sa::ldsm_x4_trans(vb, v_lane + 16 * kc * RS + 64 * cb + 16 * c);
              sa::mma_bf16(acc0, a, vb[0], vb[1]);
              sa::mma_bf16(acc1, a, vb[2], vb[3]);
            }
          }
          if (st > 0) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              o[2 * c][i] += ot[0][i];
              o[2 * c + 1][i] += ot[1][i];
            }
          }
        }
      }
      if constexpr (T % 2 == 1) {
        // the last key tile, a step of its own: k = 8 products from zero,
        // 32 columns (4 n-tiles of 8) an ldmatrix
#pragma unroll
        for (int c = 0; c < 4; c += 2) {
          uint32_t vb[4];
          sa::ldsm_x4_trans(vb, v_tail + 64 * cb + 16 * c);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            float ot[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16_k8(ot, pk[T - 1][0], pk[T - 1][1], vb[n]);
#pragma unroll
            for (int i = 0; i < 4; ++i) o[2 * c + n][i] += ot[i];
          }
        }
      }
      if (half == 1) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          xo[32 * nt + lane] = make_float4(o[nt][0], o[nt][1], o[nt][2], o[nt][3]);
      }
      pair_sync(pair);
      if (half == 0) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float4 w = xo[32 * nt + lane];
          bf16* const out = Qs + g * RS + 64 * cb + 8 * nt + 2 * t;
          sa::put_pair(out, o[nt][0] + w.x, o[nt][1] + w.y);
          sa::put_pair(out + 8 * RS, o[nt][2] + w.z, o[nt][3] + w.w);
        }
      }
      if (cb + 1 < DC / 4) pair_sync(pair);  // warp 0 has read xo
    }
    // warp 0 writes the tile's rows out through Qs (the tile's Q is in both
    // warps' registers): 16-byte vectors where `vec_out`
    if (half == 0) {
      __syncwarp();
      const int rows = min(16, L - r0);
      bf16* const dst = o_rows(r0);
      if (vec_out) {
        const int cpr = dh / 8;  // vec_out: Dh a multiple of 8
        for (int i = lane; i < rows * cpr; i += 32) {
          const int r = i / cpr, c = 8 * (i - r * cpr);
          *reinterpret_cast<uint4*>(dst + r * h.o_sl + c) =
              *reinterpret_cast<const uint4*>(Qs + r * RS + c);
        }
      } else {
        for (int i = lane; i < rows * dh; i += 32) {
          const int r = i / dh, c = i - r * dh;
          dst[r * h.o_sl + c] = Qs[r * RS + c];
        }
      }
    }
    pair_sync(pair);  // the output has left Qs before the next Q tile lands there
  }
}

}  // namespace la
