// Short-sequence attention tile for Hopper (sm_90a): the device code that
// csrc/fused_mha.cu and csrc/fused_attention.cu share.
//
// Both kernels attend sequences of L <= 128 keys with heads of Dh <= 128,
// where the work (4·L·Dh flops per query row) is far below the card's
// ops-per-byte balance: their bound is the bytes of q, k, v and o. So one
// block stages one (sequence, head) in shared memory with 16-byte copies,
// and one warp computes each 16-row tile of queries against all of its
// head's keys with the scores and P held in registers:
//
// - stage(): a head's rows [rows, stride] -> shared [rows padded to 16,
//   Dh padded to 16, +16 bytes], by cp.async of 16 bytes where the base,
//   the row stride and Dh·esize are all 16-byte multiples (decided once per
//   launch, passed in as `vec`), else by element loads in the same kernel.
//   Columns past Dh are zero, and so are K's and V's rows past L: a padded
//   key's V row adds 0·0 and never NaN. The 16-byte row pad puts the 8 rows
//   that one ldmatrix phase reads on 8 different bank groups.
// - scores() and values(), bf16: S = Q·Kᵀ and O = P·V on the tensor cores
//   with mma.sync.m16n8k16 (bf16 in, fp32 accumulate), operands by ldmatrix
//   (.trans for V): 16 query rows × 8-key tiles × 16-column chunks of Dh.
//   The softmax runs on the accumulator fragments: a row's max and sum over
//   the 4 lanes that hold it; padded keys are -inf before the max. P is
//   rounded to bf16 and repacked from the S fragment straight into the A
//   fragment of the P·V product (the FlashAttention-2 register layout): it
//   never touches shared memory. V's copy lands while the scores run.
// - scores() and values(), fp32: the same fragment layout on CUDA-core
//   FMAs. TF32 would round q and k to 10 bits and miss the 2e-5 fp32 parity.
// - store_tile(): the output fragment is rounded to T, staged in the warp's
//   own (already consumed) query rows, and written out in 16-byte vectors.
//
// A kernel supplies the score policy (its contract: where the scale goes,
// causal or additive masking) and the addresses of its (sequence, head).
// Register arrays are sized by the template bucket <NKT key tiles of 8,
// DC column chunks of 16>; loops run to the launch's own L and Dh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sa {

using bf16 = __nv_bfloat16;

constexpr int kMaxL = 128;
constexpr int kMaxDh = 128;

// A kernel of bucket NKT (key tiles of 8) runs one warp per 16-row query
// tile: at most 4 warps at L <= 64, 8 at L <= 128. The short buckets are
// compiled for 4 blocks of 128 threads per SM (at most 128 registers); the
// long one for a single block, which lets it keep its larger fragments in
// registers without spilling.
constexpr int max_threads(int nkt) { return nkt > 8 ? 256 : 128; }
constexpr int min_blocks(int nkt) { return nkt > 8 ? 1 : 4; }

__host__ __device__ inline int padded_len(int l) { return (l + 15) / 16 * 16; }
__host__ __device__ inline int padded_dh(int dh) { return (dh + 15) / 16 * 16; }
// shared-memory row stride in elements: Dh padded to 16, plus 16 bytes
template <typename T> __host__ __device__ inline int row_stride(int dh) {
  return padded_dh(dh) + 16 / (int)sizeof(T);
}
// shared memory of one (sequence, head): q, k, v tiles
template <typename T> __host__ __device__ inline size_t head_smem(int l, int dh) {
  return 3 * sizeof(T) * (size_t)padded_len(l) * row_stride<T>(dh);
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.f); }

// ---- loads ----------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = fill ? 16 : 0;  // 0 source bytes: 16 zero bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x cols of src (row stride sl) -> the first fill_rows rows of dst
// (row stride rs), columns zero-filled to padded_dh(cols) and rows past
// `rows` zero; all threads of the block take part. Each thread walks its
// copies as (row, copy-in-row) pairs, stepped without a division.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int rs, const T* src, long long sl,
                                      int rows, int fill_rows, int cols, bool vec) {
  const int per = vec ? 16 / (int)sizeof(T) : 1;  // elements per copy
  const int cpr = padded_dh(cols) / per;           // copies per row
  const int dr = blockDim.x / cpr, dk = blockDim.x - dr * cpr;
  int r = threadIdx.x / cpr, k = threadIdx.x - r * cpr;
  while (r < fill_rows) {
    const int c = k * per;
    const bool real = r < rows && c < cols;  // vec: cols·esize is a 16-byte multiple
    if (vec) {
      cp_async16(dst + r * rs + c, real ? src + r * sl + c : src, real);
    } else {
      dst[r * rs + c] = real ? src[r * sl + c] : zero<T>();
    }
    r += dr;
    k += dk;
    if (k >= cpr) {
      k -= cpr;
      ++r;
    }
  }
}

// ---- tensor-core building blocks --------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a · b: a 16x16 (row), b 16x8 (col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// each bf16 of a pair times s, rounded to bf16: q * asarray(s, bf16)
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  return pack_bf16(f.x * s, f.y * s);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- the softmax on the S fragment --------------------------------------------
//
// Fragment layout (mma m16n8 accumulator): lane = 4·g + t holds, for key
// tile j, s[j][e] = S[row q0 + g + 8·(e >> 1)][key 8·j + 2·t + (e & 1)].
// Keys past L become -inf before the max; everything else goes through the
// policy; tiles past the policy's last key (j >= nkt) are P = 0. A row
// whose every key is -inf gives NaN (the reference's softmax does too). The
// exponential is exp2 of the scores in log2 units, and P is e times the
// row's one reciprocal of Σe: each within a few fp32 ulps of expf and
// e / Σe, far inside the fp32 and bf16 tolerances, at a fraction of their
// instructions. On return s holds P in fp32, unrounded.
template <int NKT, class Score>
__device__ __forceinline__ void softmax_rows(float (&s)[NKT][4], int q0, int L,
                                             int nkt, const Score& score) {
  constexpr float kLog2e = 1.4426950408889634f;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NKT; ++j) {
    if (j < nkt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + g + 8 * (e >> 1), key = 8 * j + 2 * t + (e & 1);
        s[j][e] = key < L ? score(s[j][e], row, key) : -INFINITY;
      }
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  const float b0 = m0 * kLog2e, b1 = m1 * kLog2e;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < NKT; ++j) {
    if (j < nkt) {
      s[j][0] = exp2f(fmaf(s[j][0], kLog2e, -b0));
      s[j][1] = exp2f(fmaf(s[j][1], kLog2e, -b0));
      s[j][2] = exp2f(fmaf(s[j][2], kLog2e, -b1));
      s[j][3] = exp2f(fmaf(s[j][3], kLog2e, -b1));
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    } else {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
  }
  const float i0 = 1.f / quad_sum(l0), i1 = 1.f / quad_sum(l1);
#pragma unroll
  for (int j = 0; j < NKT; ++j) {
    s[j][0] *= i0;
    s[j][1] *= i0;
    s[j][2] *= i1;
    s[j][3] *= i1;
  }
}

// ---- one 16-row query tile, in two phases ------------------------------------
//
// scores(): S = Q·Kᵀ for the tile's 16 query rows (first row q0), the
// softmax, and P in registers; values(): O = P·V. Between the two the block
// waits for V, so its copy overlaps the scores. Qs, Ks, Vs: the head's
// staged tiles (row stride rs); dh_p: Dh padded to 16. o receives
// O[row][8·nt + 2·t + (e & 1)] in the fragment layout above, in fp32.

template <typename T, int NKT> struct Probs;
template <int NKT> struct Probs<bf16, NKT> {  // P rounded to bf16, as A fragments
  uint32_t p[NKT][2];
  int nkt;
};
template <int NKT> struct Probs<float, NKT> {  // P in fp32, fragment layout
  float p[NKT][4];
  int nkt;
};

template <int NKT, int DC, class Score>
__device__ __forceinline__ void scores(bf16* Qs, const bf16* Ks, int rs, int q0, int L,
                                       int dh_p, const Score& score,
                                       Probs<bf16, NKT>& P) {
  static_assert(NKT % 2 == 0, "P·V takes keys 16 at a time");
  const int lane = threadIdx.x & 31;
  const int dc = dh_p / 16;
  const int nkt = (score.key_end(q0, L) + 7) / 8;

  uint32_t qf[DC][4];
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    if (c < dc) {
      ldsm_x4(qf[c], Qs + (q0 + (lane & 15)) * rs + 16 * c + 8 * (lane >> 4));
      if constexpr (Score::kScaleQ) {
#pragma unroll
        for (int i = 0; i < 4; ++i) qf[c][i] = scale_bf16x2(qf[c][i], score.q_scale);
      }
    }
  }

  float s[NKT][4];
#pragma unroll
  for (int j = 0; j < NKT; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if (j < nkt) {
      const bf16* krow = Ks + (8 * j + (lane & 7)) * rs;
#pragma unroll
      for (int c = 0; c < DC; c += 2) {
        if (c < dc) {
          // chunks c and c + 1 in one ldmatrix; where c + 1 is past Dh the
          // upper half re-reads chunk c (in bounds) and goes unused
          int col = 16 * c + 8 * (lane >> 3);
          if (col >= dh_p) col -= 16;
          uint32_t kb[4];
          ldsm_x4(kb, krow + col);
          mma_bf16(s[j], qf[c], kb[0], kb[1]);
          if (c + 1 < dc) mma_bf16(s[j], qf[c + 1], kb[2], kb[3]);
        }
      }
    }
  }

  softmax_rows<NKT>(s, q0, L, nkt, score);
  // a tile past the last key is all zeros after the softmax
#pragma unroll
  for (int j = 0; j < NKT; ++j) {
    P.p[j][0] = pack_bf16(s[j][0], s[j][1]);
    P.p[j][1] = pack_bf16(s[j][2], s[j][3]);
  }
  P.nkt = nkt;
}

template <int NKT, int DC>
__device__ __forceinline__ void values(const bf16* Vs, int rs, int dh_p,
                                       const Probs<bf16, NKT>& P, float (&o)[2 * DC][4]) {
  const int lane = threadIdx.x & 31;
  const int dc = dh_p / 16;
#pragma unroll
  for (int nt = 0; nt < 2 * DC; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  // P as the A operand: key tiles 2·kc and 2·kc + 1 make one k = 16 chunk
  const int nkc = (P.nkt + 1) / 2;
#pragma unroll
  for (int kc = 0; kc < NKT / 2; ++kc) {
    if (kc < nkc) {
      const uint32_t a[4] = {P.p[2 * kc][0], P.p[2 * kc][1], P.p[2 * kc + 1][0],
                             P.p[2 * kc + 1][1]};
      const bf16* vrow = Vs + (16 * kc + (lane & 7) + 8 * ((lane >> 3) & 1)) * rs;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        if (c < dc) {
          uint32_t vb[4];
          ldsm_x4_trans(vb, vrow + 16 * c + 8 * (lane >> 4));
          mma_bf16(o[2 * c], a, vb[0], vb[1]);
          mma_bf16(o[2 * c + 1], a, vb[2], vb[3]);
        }
      }
    }
  }
}

template <int NKT, int DC, class Score>
__device__ __forceinline__ void scores(float* Qs, const float* Ks, int rs, int q0, int L,
                                       int dh_p, const Score& score,
                                       Probs<float, NKT>& P) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nkt = (score.key_end(q0, L) + 7) / 8;

  if constexpr (Score::kScaleQ) {  // q * asarray(s, float32), in the warp's own rows
    for (int i = lane; i < 16 * dh_p; i += 32) Qs[(q0 + i / dh_p) * rs + i % dh_p] *= score.q_scale;
    __syncwarp();
  }

  float (&s)[NKT][4] = P.p;
  const float* qa = Qs + (q0 + g) * rs;
  const float* qb = qa + 8 * rs;
#pragma unroll
  for (int j = 0; j < NKT; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if (j < nkt) {
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

  softmax_rows<NKT>(s, q0, L, nkt, score);
  P.nkt = nkt;
}

template <int NKT, int DC>
__device__ __forceinline__ void values(const float* Vs, int rs, int dh_p,
                                       const Probs<float, NKT>& P, float (&o)[2 * DC][4]) {
  // O += P·V key by key: the quad's lane t2 holds keys 8·j + 2·t2, +1 of
  // both rows; this lane owns columns 8·nt + 2·t, +1
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int ntc = dh_p / 8;
#pragma unroll
  for (int nt = 0; nt < 2 * DC; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NKT; ++j) {
    if (j < P.nkt) {
#pragma unroll
      for (int t2 = 0; t2 < 4; ++t2) {
        const int src = (lane & ~3) | t2;
        const float a0 = __shfl_sync(0xffffffffu, P.p[j][0], src);
        const float a1 = __shfl_sync(0xffffffffu, P.p[j][1], src);
        const float b0 = __shfl_sync(0xffffffffu, P.p[j][2], src);
        const float b1 = __shfl_sync(0xffffffffu, P.p[j][3], src);
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
}

// ---- the output ---------------------------------------------------------------

__device__ __forceinline__ void put_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void put_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// o (fragment layout) -> rows q0 .. min(q0 + 16, L) of dst (row stride sl),
// through the warp's own rows of `stage_rows`, whose query fragments are
// already in registers.
template <int DC, typename T>
__device__ __forceinline__ void store_tile(const float (&o)[2 * DC][4], T* stage_rows,
                                           int rs, int q0, int L, int dh, T* dst,
                                           long long sl, bool vec) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ntc = padded_dh(dh) / 8;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < 2 * DC; ++nt) {
    if (nt < ntc) {
      put_pair(stage_rows + (q0 + g) * rs + 8 * nt + 2 * t, o[nt][0], o[nt][1]);
      put_pair(stage_rows + (q0 + g + 8) * rs + 8 * nt + 2 * t, o[nt][2], o[nt][3]);
    }
  }
  __syncwarp();
  const int rows = min(16, L - q0);
  const int per = vec ? 16 / (int)sizeof(T) : 1;  // elements per copy
  const int cpr = dh / per;                        // vec: dh·esize is a 16-byte multiple
  const int dr = 32 / cpr, dk = 32 - dr * cpr;
  int r = lane / cpr, k = lane - r * cpr;
  while (r < rows) {
    const int c = k * per;
    T* out = dst + (q0 + r) * sl + c;
    const T* in = stage_rows + (q0 + r) * rs + c;
    if (vec) {
      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(in);
    } else {
      *out = *in;
    }
    r += dr;
    k += dk;
    if (k >= cpr) {
      k -= cpr;
      ++r;
    }
  }
}

// ---- one block: one (sequence, head), one warp per query tile --------------
//
// h is the block's (sequence, head): its q, k, v, o base pointers and row
// strides. At L <= 16 the block is a single warp: an SM holds 32 of them
// (at L = 8, 32 × 3 KB of copies in flight), and no warp waits at a
// barrier for another sequence's copies.

template <typename T>
struct HeadPtrs {
  const T *q, *k, *v;
  T* o;
  long long q_sl, k_sl, v_sl, o_sl;
};

template <typename T, int NKT, int DC, class Score>
__device__ __forceinline__ void attend_block(const HeadPtrs<T>& h, int L, int dh,
                                             bool vec_in, bool vec_out,
                                             const Score& score) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const Qs = reinterpret_cast<T*>(smem_raw);
  const int lp = padded_len(L), rs = row_stride<T>(dh), dh_p = padded_dh(dh);
  T* const Ks = Qs + lp * rs;
  T* const Vs = Ks + lp * rs;

  // k and v rows past L are zero (P = 0 times a stale NaN would not be);
  // q's are left as they are, as a padded query row is never stored. v
  // comes in a second group, so that its copy overlaps the scores.
  stage(Qs, rs, h.q, h.q_sl, L, L, dh, vec_in);
  stage(Ks, rs, h.k, h.k_sl, L, lp, dh, vec_in);
  cp_async_commit();
  stage(Vs, rs, h.v, h.v_sl, L, lp, dh, vec_in);
  cp_async_commit();

  const int q0 = 16 * (threadIdx.x >> 5);
  Probs<T, NKT> P;
  cp_async_wait<1>();  // q and k
  __syncthreads();
  scores<NKT, DC>(Qs, Ks, rs, q0, L, dh_p, score, P);
  cp_async_wait<0>();  // v
  __syncthreads();
  float o[2 * DC][4];
  values<NKT, DC>(Vs, rs, dh_p, P, o);
  store_tile<DC>(o, Qs, rs, q0, L, dh, h.o, h.o_sl, vec_out);
}

// ---- host side ----------------------------------------------------------------

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }
// a stride of n elements keeps 16-byte alignment (unused where the dim has size 1)
inline bool stride16(long long n, int esize, long long size) {
  return size == 1 || (n * esize) % 16 == 0;
}

// Calls f.template run<NKT, DC>() for the bucket of (L, Dh): key tiles of 8
// for L <= 16, 64, 128; column chunks of 16 for Dh <= 64, 128. The caller
// has checked 1 <= L <= kMaxL and 1 <= Dh <= kMaxDh.
template <class F>
cudaError_t with_bucket(int L, int dh, F& f) {
  if (dh <= 64) {
    if (L <= 16) return f.template run<2, 4>();
    if (L <= 64) return f.template run<8, 4>();
    return f.template run<16, 4>();
  }
  if (L <= 16) return f.template run<2, 8>();
  if (L <= 64) return f.template run<8, 8>();
  return f.template run<16, 8>();
}

// launches kernel with one block per (sequence, head); returns
// cudaGetLastError()
template <typename T, typename Kernel, typename Args>
cudaError_t launch_heads(Kernel kernel, const Args& args, long long n_heads, int L, int dh,
                         cudaStream_t stream) {
  if (n_heads > 0x7fffffffLL) return cudaErrorInvalidValue;  // blocks are counted in int
  const size_t smem = head_smem<T>(L, dh);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)n_heads, padded_len(L) / 16 * 32, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace sa
