// LayerNorm of the LN sweep's "mxu" design, forward, for Hopper (sm_90a);
// below it, its "mxu_bf16" design (ln_mxu_bf16_kernel, with its own note).
//
// Replaces the Pallas kernel body scripts/bench_ln_kernel.py:mxu_kernel
// (:39, launched through make_pallas :88). Contract, that of the body and
// of ln_mxu_plain (vtc_tpu_torch/ops/ln_designs.py): fp32 row sums Σx and
// Σx² as a product with ones, mean = Σx/d, var = Σx²/d − mean², y = (x −
// mean)·rsqrt(var + eps)·scale + bias in fp32, rounded to x's type (fp32 or
// bf16).
//
// Bound on the H100: bytes, one read and one write of the rows (24.6 MB at
// [8000, 768] bf16: 7.34 µs at 3.35 TB/s); the sums are a few operations
// per element. So each row is read from device memory once and the sums
// stay off the FMA pipe:
//
// - One read. A block of 16·R rows stages them in shared memory with
//   sa::stage (16-byte cp.async where the base, the row stride and d·esize
//   are 16-byte multiples, else element loads in the same kernel); padded
//   columns and rows are zero and add nothing to a sum. The block then
//   normalizes from shared memory.
// - The sums on the tensor cores. mma.sync.m16n8k16 with B all ones, held
//   in registers: every column of D is the row sum of A's 16-column chunk,
//   so each lane ends with the sums of its own rows g and g + 8 (d0, d2),
//   with no shuffle, and A may hold a row's elements in any order. bf16
//   rows: Σx in one product (A by ldmatrix); x² is exact in fp32 and splits
//   exactly into two bf16 parts, two products. fp32 rows: x and the fp32
//   x·x each split exactly into three bf16 parts (8 + 8 + 8 bits cover
//   fp32's 24), six products; the lanes read their floats as float4s, and
//   the fragment's row g is tile row frag_row(g), which puts the two rows
//   of one 8-lane phase on disjoint banks.
// - Exact sums need one more step. The tensor core aligns its addends to
//   the largest and truncates what falls below. Each chunk therefore starts
//   from a zero accumulator and takes its parts smallest first, and its sum
//   is added to the row's fp32 sums outside the tensor core. A running sum
//   kept in the accumulator across the row would truncate every small part
//   against a sum 48 chunks deep (d = 768), not against its chunk's.
// - S = warps / R warps share one 16-row tile's column chunks; their partial
//   sums meet in shared memory, one thread per row turns them into (mean,
//   rstd), and every warp then normalizes whole rows in 16-byte vectors with
//   the tile's scale and bias held in registers across its rows.
//
// Registers (ptxas -v, sm_90a, CUDA 12.8): <bf16> 48, <fp32> 47; neither
// spills. The launch bound is 256 threads (8 warps).
//
// Plain C interface, loaded with ctypes (vtc_tpu_torch/ops/ln_designs.py).

#include "short_attention.cuh"

namespace {

using sa::bf16;

constexpr uint32_t kOnes = 0x3F803F80u;  // two bf16 ones: the B fragment
constexpr int kMaxWarps = 8;
constexpr int kMaxSmem = 232448;  // shared memory a block can use on the H100

template <typename T>
struct Args {
  const T* x;
  const float *w, *b;
  T* y;
  long long sx;  // x's row stride in elements; y is contiguous
  int rows, d, tile_rows, splits, vec_in, vec_out;
  float eps;
};

// rows staged, the per-warp partial sums, the per-row (mean, rstd)
template <typename T>
__host__ __device__ inline size_t smem_bytes(int tile_rows, int warps, int d) {
  return sizeof(T) * (size_t)tile_rows * sa::row_stride<T>(d) +
         sizeof(float2) * (16 * warps + tile_rows);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// (p, q) = hi + lo exactly, for p and q of at most 16 significant bits
__device__ __forceinline__ void split2(float p, float q, uint32_t& hi, uint32_t& lo) {
  hi = sa::pack_bf16(p, q);
  const float2 h = unpack_bf16(hi);
  lo = sa::pack_bf16(p - h.x, q - h.y);
}

// (p, q) = hi + mid + lo exactly, for fp32 p and q of magnitude 2^-110 or
// more (or 0): p − hi has at most 16 significant bits, and is exact
__device__ __forceinline__ void split3(float p, float q, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = sa::pack_bf16(p, q);
  const float2 h = unpack_bf16(hi);
  split2(p - h.x, q - h.y, mid, lo);
}

// Σ of a chunk's parts, smallest first, from a zero accumulator: d[0] is
// the sum of fragment row g, d[2] of row g + 8
template <int N>
__device__ __forceinline__ float2 chunk_sum(const uint32_t (&parts)[N][4]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = N - 1; i >= 0; --i) sa::mma_bf16(d, parts[i], kOnes, kOnes);
  return make_float2(d[0], d[2]);
}

struct Sums {
  float x0, x1, q0, q1;  // Σx and Σx² of fragment rows g (0) and g + 8 (1)
  __device__ void add(float2 sx, float2 sq) {
    x0 += sx.x;
    x1 += sx.y;
    q0 += sq.x;
    q1 += sq.y;
  }
};

// the tile row of fragment row g (and g + 8 of g + 8)
__device__ __forceinline__ int frag_row(const bf16*, int g) { return g; }
__device__ __forceinline__ int frag_row(const float*, int g) {
  return (g >> 1) | ((g & 1) << 2);  // 0 4 1 5 2 6 3 7: one phase's rows 4 apart
}

// chunk c (columns 16c .. 16c + 15) of a staged 16-row tile
__device__ __forceinline__ void add_chunk(Sums& s, const bf16* tile, int rs, int c) {
  const int lane = threadIdx.x & 31;
  uint32_t x[1][4], q[2][4];  // x; x² as (hi, lo)
  sa::ldsm_x4(x[0], tile + (lane & 15) * rs + 16 * c + 8 * (lane >> 4));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = unpack_bf16(x[0][i]);
    split2(f.x * f.x, f.y * f.y, q[0][i], q[1][i]);
  }
  s.add(chunk_sum(x), chunk_sum(q));
}

__device__ __forceinline__ void add_chunk(Sums& s, const float* tile, int rs, int c) {
  const int lane = threadIdx.x & 31;
  const float* ra = tile + frag_row(tile, lane >> 2) * rs + 16 * c + 4 * (lane & 3);
  const float4 u = *reinterpret_cast<const float4*>(ra);           // row g: a0, a2
  const float4 v = *reinterpret_cast<const float4*>(ra + 8 * rs);  // row g + 8: a1, a3
  uint32_t x[3][4], q[3][4];  // x and x·x as (hi, mid, lo)
  split3(u.x, u.y, x[0][0], x[1][0], x[2][0]);
  split3(v.x, v.y, x[0][1], x[1][1], x[2][1]);
  split3(u.z, u.w, x[0][2], x[1][2], x[2][2]);
  split3(v.z, v.w, x[0][3], x[1][3], x[2][3]);
  split3(u.x * u.x, u.y * u.y, q[0][0], q[1][0], q[2][0]);
  split3(v.x * v.x, v.y * v.y, q[0][1], q[1][1], q[2][1]);
  split3(u.z * u.z, u.w * u.w, q[0][2], q[1][2], q[2][2]);
  split3(v.z * v.z, v.w * v.w, q[0][3], q[1][3], q[2][3]);
  s.add(chunk_sum(x), chunk_sum(q));
}

// ---- 16-byte vectors of T as floats ----------------------------------------

__device__ __forceinline__ void unpack16(float (&v)[4], uint4 u) {
  const float4 f = *reinterpret_cast<const float4*>(&u);
  v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
}
__device__ __forceinline__ void unpack16(float (&v)[8], uint4 u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = unpack_bf16(w[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack16(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack16(const float (&v)[8]) {
  return make_uint4(sa::pack_bf16(v[0], v[1]), sa::pack_bf16(v[2], v[3]),
                    sa::pack_bf16(v[4], v[5]), sa::pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16(v); }

// PER consecutive elements: one 16-byte vector, or PER = 1 element
template <int PER, typename T>
__device__ __forceinline__ void load(float (&v)[PER], const T* p) {
  if constexpr (PER == 1) {
    v[0] = to_f32(*p);
  } else {
    unpack16(v, *reinterpret_cast<const uint4*>(p));
  }
}
template <int PER, typename T>
__device__ __forceinline__ void store(T* p, const float (&v)[PER]) {
  if constexpr (PER == 1) {
    put(p, v[0]);
  } else {
    *reinterpret_cast<uint4*>(p) = pack16(v);
  }
}
template <int PER>
__device__ __forceinline__ void load_params(float (&v)[PER], const float* p) {
  if constexpr (PER == 1) {
    v[0] = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < PER; i += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = f.x, v[i + 1] = f.y, v[i + 2] = f.z, v[i + 3] = f.w;
    }
  }
}

// y = (x − mean)·rstd·w + b for the block's staged rows: warp i takes rows
// i, i + warps, ...; lane l columns PER·l + 32·PER·k, with w and b loaded
// once per column vector
template <int PER, typename T>
__device__ __forceinline__ void normalize(const Args<T>& a, const T* xs, int rs,
                                          const float2* coef, long long row0, int valid) {
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  for (int c = PER * lane; c < a.d; c += 32 * PER) {
    float w[PER], b[PER];
    load_params<PER>(w, a.w + c);
    load_params<PER>(b, a.b + c);
    for (int r = warp; r < valid; r += warps) {
      const float2 k = coef[r];
      float v[PER];
      load<PER>(v, xs + r * rs + c);
#pragma unroll
      for (int i = 0; i < PER; ++i) v[i] = fmaf((v[i] - k.x) * k.y, w[i], b[i]);
      store<PER>(a.y + (row0 + r) * a.d + c, v);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarps) ln_mxu_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const xs = reinterpret_cast<T*>(smem_raw);
  const int rs = sa::row_stride<T>(a.d), nr = a.tile_rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float2* const part = reinterpret_cast<float2*>(xs + nr * rs);  // [warps][16] (Σx, Σx²)
  float2* const coef = part + 16 * (blockDim.x >> 5);            // [nr] (mean, rstd)
  const long long row0 = (long long)blockIdx.x * nr;
  const int valid = (int)min((long long)nr, a.rows - row0);

  sa::stage(xs, rs, a.x + row0 * a.sx, a.sx, valid, nr, a.d, a.vec_in);
  sa::cp_async_commit();
  sa::cp_async_wait<0>();
  __syncthreads();

  // warp = tile·S + split: the split's chunks of its tile's 16 rows
  const int tile = warp / a.splits;
  const T* const tx = xs + 16 * tile * rs;
  Sums s{0.f, 0.f, 0.f, 0.f};
  for (int c = warp - tile * a.splits; c < sa::padded_dh(a.d) / 16; c += a.splits)
    add_chunk(s, tx, rs, c);
  if ((lane & 3) == 0) {
    const int r = frag_row(tx, lane >> 2);
    part[16 * warp + r] = make_float2(s.x0, s.q0);
    part[16 * warp + r + 8] = make_float2(s.x1, s.q1);
  }
  __syncthreads();

  if (threadIdx.x < nr) {  // 32·warps >= 32·R >= 16·R threads
    const int r = threadIdx.x;
    const float2* p = part + 16 * (r >> 4) * a.splits + (r & 15);
    float sx = 0.f, sq = 0.f;
    for (int i = 0; i < a.splits; ++i) {
      sx += p[16 * i].x;
      sq += p[16 * i].y;
    }
    const float mean = sx / a.d;
    coef[r] = make_float2(mean, rsqrtf(sq / a.d - mean * mean + a.eps));
  }
  __syncthreads();

  if (a.vec_out) {
    normalize<16 / sizeof(T)>(a, xs, rs, coef, row0, valid);
  } else {
    normalize<1>(a, xs, rs, coef, row0, valid);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, long long sx,
                   int rows, int d, int tile_rows, int warps, float eps,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(tile_rows, warps, d);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // once per instance: any launch up to the card's limit may follow
  static const cudaError_t attr = cudaFuncSetAttribute(
      ln_mxu_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const int es = sizeof(T);
  // 16-byte copies in: x's base and row stride and d·esize at 16-byte
  // multiples; 16-byte vectors out: y's base (its rows are d apart) and
  // those of the fp32 scale and bias
  const bool d16 = (d * es) % 16 == 0;
  const bool vec_in = d16 && sa::aligned16(x) && sa::stride16(sx, es, rows);
  const bool vec_out = d16 && sa::aligned16(y) && sa::aligned16(w) && sa::aligned16(b);
  const Args<T> a{static_cast<const T*>(x), static_cast<const float*>(w),
                  static_cast<const float*>(b), static_cast<T*>(y), sx, rows, d,
                  tile_rows, warps / (tile_rows / 16), vec_in, vec_out, eps};
  const long long blocks = ((long long)rows + tile_rows - 1) / tile_rows;
  ln_mxu_kernel<T><<<(unsigned)blocks, 32 * warps, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---- ln_mxu_bf16: the sweep's "mxu_bf16" design ------------------------------
//
// Replaces the Pallas kernel body scripts/bench_ln_kernel.py:mxu_bf16_kernel
// (:61, launched through make_pallas :88). Contract, that of the body and of
// ln_mxu_bf16_plain (vtc_tpu_torch/ops/ln_designs.py): bf16 x in, bf16 out;
// Σx of the bf16 values and Σ of x² rounded to bf16, each accumulated in
// fp32; mean = Σx/d, var = Σx²/d − mean², rstd = rsqrt(var + eps) in fp32;
// then each bf16 operation of the body, rounded to bf16 as it is there:
// xc = x − bf16(mean), y = xc·bf16(rstd), y·bf16(scale), + bf16(bias).
//
// Bound on the H100: bytes, as ln_mxu's (24.6 MB at [8000, 768]: 7.34 µs at
// 3.35 TB/s). The design:
//
// - One read of each row: a tile of 16·R rows is staged in shared memory by
//   sa::stage (16-byte cp.async where x's base, row stride and d·2 are
//   16-byte multiples, element loads otherwise; padded columns and rows are
//   zero) and normalized from there.
// - The sums on the tensor cores, one product per part: each 16-column
//   chunk of a 16-row tile takes one mma.sync.m16n8k16 for x (A by ldmatrix,
//   B the all-ones fragment) and one for bf16(x²), the A fragment squared in
//   bf16x2. The design rounds x² to bf16, so it has one part, not ln_mxu's
//   two exact ones. Each chunk starts from a zero accumulator and is added
//   to the row's fp32 sums outside the tensor core, as in ln_mxu.
// - The bf16 steps are fma.rn.bf16x2 instructions, one per pair of elements
//   and step: each rounds the exact result once, which equals the fp32
//   operation rounded to bf16 (fp32 carries more than 2·8 + 2 bits, so the
//   double rounding is innocuous) and so equals the body's bf16 operation.
// - Persistent, double-buffered blocks: this is what ln_mxu lacks, whose one
//   wave of blocks each loads, waits, sums and stores. Block b walks tiles
//   b, b + grid, ... over two shared-memory stages: tile t + grid's
//   cp.async group is in flight while tile t is summed, normalized and
//   stored. The wrapper sizes the grid (ln_mxu_bf16_grid) so that each SM
//   keeps about LN_MXU_BF16_IN_FLIGHT bytes of tile loads in flight, twice
//   the 25 KB that 3.35 TB/s × about 1 µs of latency / 132 SMs gives by
//   arithmetic: two blocks of 16-row tiles at d = 768, each walking about
//   two of the sweep's 500 tiles. On the card that beat one block per SM
//   and one block per tile (one wave, as ln_mxu), and starting both stages'
//   copies at once, which costs a fourth barrier per tile (PERF.md, row
//   5b). TMA bulk copies would take the same 16-byte rule and an mbarrier
//   per stage for the same bytes; cp.async groups reuse sa::stage. Element
//   loads (the unaligned path) are synchronous, so there the next tile's
//   copy does not overlap.
// - Scale and bias are rounded to bf16 once per block, into shared memory,
//   and read from there for every tile.
// - Stores: 16-byte vectors where y's base allows (PER = 8), element stores
//   otherwise (PER = 1), each lane's scale and bias vector held across the
//   warp's rows.
//
// Registers (ptxas -v, sm_90a, CUDA 12.8): <8> 47, <1> 39; neither spills.

constexpr uint32_t kNegOnes = 0xBF80BF80u;   // two bf16 −1s
constexpr uint32_t kNegZeros = 0x80008000u;  // two bf16 −0s

struct BfArgs {
  const bf16* x;
  const float *w, *b;
  bf16* y;
  long long sx;  // x's row stride in elements; y is contiguous
  int rows, d, tile_rows, splits, tiles, vec_in;
  float eps;
};

// two stages of rows, scale and bias in bf16, the per-warp partial sums,
// the per-row (mean, rstd) as bf16 pairs
__host__ __device__ inline size_t bf16_smem_bytes(int tile_rows, int warps, int d) {
  return 2 * sizeof(bf16) * (size_t)tile_rows * sa::row_stride<bf16>(d) +
         2 * sizeof(bf16) * (size_t)sa::padded_dh(d) +
         sizeof(float2) * (16 * warps + tile_rows);
}

// a·b + c on two bf16 pairs, the exact result rounded once to bf16
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  return fma_bf16x2(b, kNegOnes, a);
}
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  return fma_bf16x2(a, b, kNegZeros);
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  return fma_bf16x2(a, kOnes, b);
}

// chunk c of a staged 16-row tile: x and bf16(x²), one part each
__device__ __forceinline__ void add_rounded_chunk(Sums& s, const bf16* tile, int rs, int c) {
  const int lane = threadIdx.x & 31;
  uint32_t x[1][4], q[1][4];
  sa::ldsm_x4(x[0], tile + (lane & 15) * rs + 16 * c + 8 * (lane >> 4));
#pragma unroll
  for (int i = 0; i < 4; ++i) q[0][i] = mul_bf16x2(x[0][i], x[0][i]);
  s.add(chunk_sum(x), chunk_sum(q));
}

// PER consecutive bf16 as (PER + 1) / 2 pairs: one 16-byte vector, or one
// element in the low half
template <int PER>
struct Pairs {
  uint32_t v[(PER + 1) / 2];
};
template <int PER>
__device__ __forceinline__ Pairs<PER> load_pairs(const bf16* p) {
  Pairs<PER> r;
  if constexpr (PER == 1) {
    r.v[0] = *reinterpret_cast<const uint16_t*>(p);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    r.v[0] = u.x, r.v[1] = u.y, r.v[2] = u.z, r.v[3] = u.w;
  }
  return r;
}
template <int PER>
__device__ __forceinline__ void store_pairs(bf16* p, const Pairs<PER>& r) {
  if constexpr (PER == 1) {
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)r.v[0];
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(r.v[0], r.v[1], r.v[2], r.v[3]);
  }
}

// the body's bf16 steps for the tile's valid rows: warp i takes rows i,
// i + warps, ...; lane l columns PER·l + 32·PER·k, with scale and bias read
// once per column vector
template <int PER>
__device__ __forceinline__ void normalize_rounded(const BfArgs& a, const bf16* xs, int rs,
                                                  const bf16* ws, const bf16* bs,
                                                  const uint2* coef, long long row0,
                                                  int valid) {
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  for (int c = PER * lane; c < a.d; c += 32 * PER) {
    const Pairs<PER> w = load_pairs<PER>(ws + c), b = load_pairs<PER>(bs + c);
    for (int r = warp; r < valid; r += warps) {
      const uint2 k = coef[r];  // (mean, mean), (rstd, rstd) in bf16
      Pairs<PER> v = load_pairs<PER>(xs + r * rs + c);
#pragma unroll
      for (int i = 0; i < (PER + 1) / 2; ++i)
        v.v[i] = add_bf16x2(mul_bf16x2(mul_bf16x2(sub_bf16x2(v.v[i], k.x), k.y), w.v[i]),
                            b.v[i]);
      store_pairs<PER>(a.y + (row0 + r) * a.d + c, v);
    }
  }
}

template <int PER>
__global__ void __launch_bounds__(32 * kMaxWarps) ln_mxu_bf16_kernel(const BfArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rs = sa::row_stride<bf16>(a.d), dp = sa::padded_dh(a.d), nr = a.tile_rows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* const stages = reinterpret_cast<bf16*>(smem_raw);  // [2][nr][rs]
  bf16* const ws = stages + 2 * nr * rs;                     // [dp] bf16(scale)
  bf16* const bs = ws + dp;                                  // [dp] bf16(bias)
  float2* const part = reinterpret_cast<float2*>(bs + dp);  // [warps][16] (Σx, Σx²)
  uint2* const coef = reinterpret_cast<uint2*>(part + 16 * (blockDim.x >> 5));  // [nr]

  // tile -> stage buf, one cp.async group
  auto stage = [&](int tile, int buf) {
    const long long row0 = (long long)tile * nr;
    sa::stage(stages + buf * nr * rs, rs, a.x + row0 * a.sx, a.sx,
              (int)min((long long)nr, a.rows - row0), nr, a.d, a.vec_in);
    sa::cp_async_commit();
  };
  stage(blockIdx.x, 0);
  for (int c = threadIdx.x; c < dp; c += blockDim.x) {
    ws[c] = __float2bfloat16(c < a.d ? __ldg(a.w + c) : 0.f);
    bs[c] = __float2bfloat16(c < a.d ? __ldg(a.b + c) : 0.f);
  }

  // warp = tile·S + split: the split's chunks of its 16-row tile
  const int sub = warp / a.splits, split = warp - sub * a.splits;
  int buf = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, buf ^= 1) {
    bf16* const xs = stages + buf * nr * rs;
    sa::cp_async_wait<0>();
    // tile t has landed for every thread, and every thread is done with
    // the other stage (tile t − grid), which now takes tile t + grid
    __syncthreads();
    if (t + (int)gridDim.x < a.tiles) stage(t + gridDim.x, buf ^ 1);

    const bf16* const tx = xs + 16 * sub * rs;
    Sums s{0.f, 0.f, 0.f, 0.f};
    for (int c = split; c < dp / 16; c += a.splits) add_rounded_chunk(s, tx, rs, c);
    if ((lane & 3) == 0) {
      const int r = lane >> 2;
      part[16 * warp + r] = make_float2(s.x0, s.q0);
      part[16 * warp + r + 8] = make_float2(s.x1, s.q1);
    }
    __syncthreads();

    if (threadIdx.x < nr) {  // 32·warps >= 32·R >= 16·R threads
      const int r = threadIdx.x;
      const float2* p = part + 16 * (r >> 4) * a.splits + (r & 15);
      float sx = 0.f, sq = 0.f;
      for (int i = 0; i < a.splits; ++i) {
        sx += p[16 * i].x;
        sq += p[16 * i].y;
      }
      const float mean = sx / a.d;
      // the body's var = Σx²/d − mean·mean, no fused multiply-add
      const float rstd = rsqrtf(__fsub_rn(sq / a.d, __fmul_rn(mean, mean)) + a.eps);
      coef[r] = make_uint2(sa::pack_bf16(mean, mean), sa::pack_bf16(rstd, rstd));
    }
    __syncthreads();

    const long long row0 = (long long)t * nr;
    normalize_rounded<PER>(a, xs, rs, ws, bs, coef, row0,
                           (int)min((long long)nr, a.rows - row0));
  }
}

template <int PER>
cudaError_t launch_bf16(const BfArgs& a, int blocks, int warps, size_t smem,
                        cudaStream_t stream) {
  // once per instance: any launch up to the card's limit may follow
  static const cudaError_t attr = cudaFuncSetAttribute(
      ln_mxu_bf16_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  ln_mxu_bf16_kernel<PER><<<blocks, 32 * warps, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: [rows, d] with row stride sx (elements) and a contiguous last dim; w, b:
// contiguous fp32 [d]; y: contiguous [rows, d] of x's type. A block takes
// rows_per_block = 16·R rows with `warps` warps, a multiple of R, at most 8.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape or configuration the kernel
// does not take).
extern "C" int vtc_ln_mxu(const void* x, const void* w, const void* b, void* y,
                          long long sx, int rows, int d, int rows_per_block, int warps,
                          float eps, int dtype, void* stream) {
  if (rows < 1 || d < 1 || rows_per_block < 16 || rows_per_block % 16 || warps < 1 ||
      warps > kMaxWarps || warps % (rows_per_block / 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, w, b, y, sx, rows, d, rows_per_block, warps, eps, st);
  if (dtype == 1)
    return (int)launch<bf16>(x, w, b, y, sx, rows, d, rows_per_block, warps, eps, st);
  return (int)cudaErrorInvalidValue;
}

// x: bf16 [rows, d] with row stride sx (elements) and a contiguous last dim;
// w, b: contiguous fp32 [d]; y: contiguous bf16 [rows, d]. Tiles of
// rows_per_tile = 16·R rows, `warps` warps a block (a multiple of R, at most
// 8), at most `blocks` blocks, each walking tiles a grid apart. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape or
// configuration the kernel does not take).
extern "C" int vtc_ln_mxu_bf16(const void* x, const void* w, const void* b, void* y,
                               long long sx, int rows, int d, int rows_per_tile, int warps,
                               int blocks, float eps, void* stream) {
  if (rows < 1 || d < 1 || rows_per_tile < 16 || rows_per_tile % 16 || warps < 1 ||
      warps > kMaxWarps || warps % (rows_per_tile / 16) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bf16_smem_bytes(rows_per_tile, warps, d);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int tiles = (int)(((long long)rows + rows_per_tile - 1) / rows_per_tile);
  // 16-byte copies in: x's base and row stride and d·2 at 16-byte multiples;
  // 16-byte vectors out: y's base (its rows are d apart). Scale and bias are
  // read once per block, by element.
  const bool d16 = (d * 2) % 16 == 0;
  const BfArgs a{static_cast<const bf16*>(x), static_cast<const float*>(w),
                 static_cast<const float*>(b), static_cast<bf16*>(y), sx, rows, d,
                 rows_per_tile, warps / (rows_per_tile / 16), tiles,
                 d16 && sa::aligned16(x) && sa::stride16(sx, 2, rows), eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks > tiles) blocks = tiles;
  if (d16 && sa::aligned16(y)) return (int)launch_bf16<8>(a, blocks, warps, smem, st);
  return (int)launch_bf16<1>(a, blocks, warps, smem, st);
}
