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
// Bound on the H100: bytes at the ViT shapes. q, k, v are read once and o
// written once (4·B·L·E elements); the work is 4·B·H·L²·Dh flops (ViT-B/16
// at batch 64, L = 197: 7.6 GFLOP, 7.7 µs on the bf16 tensor cores, against
// 23.1 µs of bytes). Design, simple first: one block per (sequence, head,
// 64-row query tile), 4 warps of 16 query rows. The block stages its Q tile
// once, then streams K (and V) in tiles of 64 keys through two shared
// buffers with cp.async (sa::stage): the next tile's copy is in flight while
// the warps compute on the current one. Two passes over the keys, each tile
// taken in steps of 32 keys so that a warp's S is 16 registers a lane and 4
// blocks fit an SM in bf16 (the latency of the per-tile barrier and of the
// mma chains is hidden by the other blocks, not by the block itself):
//
// - pass 1: S = Q·Kᵀ (mma.sync.m16n8k8 for bf16, CUDA-core FMAs for fp32,
//   as the short tile), each row's running max m and its sum l of
//   exponentials rescaled to it, in fp32;
// - pass 2: S again, P = exp(S − m) / l with the final m and l, P rounded to
//   q's type, and O += P·V in fp32.
//
// The second pass recomputes S (a third more tensor-core work than one
// pass) so that P is normalised before it is rounded, as the contract and
// the plain version round it: a one-pass online softmax rounds the
// unnormalised P and rescales O after, which misses the plain version by a
// bf16 ulp at a visible share of outputs. For the same reason P is expf and
// an IEEE division, as PyTorch's softmax. The sums: an mma's fp32
// accumulation does not round to nearest as cuBLAS's FMAs do, and a long
// chain of mmas into one accumulator drifts from the plain version's sums,
// which over L keys flips the bf16 rounding of a growing share of outputs.
// So each k = 8 product of S (mma.m16n8k8) and each 32-key step of P·V
// starts from a zeroed accumulator and is added to S or O on the CUDA cores,
// rounded to nearest: what is left is the order of the sums, as between two
// plain versions (chip_smoke.py phase 26 reads both).
//
// Causal key tiles past the query tile's diagonal are skipped, as are steps
// past the last key; a step with a masked key is masked per element. Making
// it fast (one pass with a rounding-exact rescale, wgmma, TMA) is later work.

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

// h: the (sequence, head)'s first rows and row strides
template <typename T, int DC>
__device__ __forceinline__ void attend_long(const sa::HeadPtrs<T>& h, int L, int dh, int causal,
                                            float q_scale, bool vec_in, bool vec_out) {
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
  const int k_end = min(L, causal ? qt0 + kQueryRows : L);
  const int n_kt = (k_end + kKeyRows - 1) / kKeyRows;
  auto stage_k = [&](int j) {
    const int k0 = kKeyRows * j;
    sa::stage(Ks + (j & 1) * tile, rs, h.k + k0 * h.k_sl, h.k_sl, min(kKeyRows, L - k0),
              kKeyRows, dh, vec_in);
  };
  auto stage_v = [&](int j) {
    const int k0 = kKeyRows * j;
    sa::stage(Vs + (j & 1) * tile, rs, h.v + k0 * h.v_sl, h.v_sl, min(kKeyRows, L - k0),
              kKeyRows, dh, vec_in);
  };

  // Q (rows past L zero) and the first K tile
  sa::stage(Qs, rs, h.q + qt0 * h.q_sl, h.q_sl, min(kQueryRows, L - qt0), kQueryRows, dh,
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
    if (causal || k0 + kStepKeys > L) mask_tile(s, qt0 + q0, k0, L, causal);
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
  sa::store_tile<DC>(o, Qs, rs, q0, min(kQueryRows, L - qt0), dh, h.o + qt0 * h.o_sl,
                     h.o_sl, vec_out);
}

}  // namespace la
