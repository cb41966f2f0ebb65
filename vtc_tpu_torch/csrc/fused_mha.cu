// Heads-packed multi-head attention for short sequences (L <= 128), forward.
//
// Replaces the Pallas kernel vtc_tpu/ops/pallas_attention.py:fused_mha
// (_fused_mha_fwd_impl :223, _mha_kernel :182). Contract, that of
// _mha_reference (:268): q is scaled by Dh^-0.5 in q's type (the scale
// rounded to T, the product rounded to T), QK^T in fp32, optional causal
// mask, softmax in fp32, P rounded to q's type, P@V with an fp32
// accumulator, output rounded to q's type. The TPU kernel's 128-row
// supertile packing and block-diagonal mask are means of the TPU, not part
// of the contract, and are not carried over.
//
// Bound on the H100: bytes. q, k, v are read once and o written once
// (4·B·L·E elements); the work, 4·B·H·L²·Dh flops, is far below the card's
// ops-per-byte balance at L <= 128 (ViT-B/32, L = 50: 1.2 GFLOP, 1.2 µs on
// the bf16 tensor cores, against 14.7 µs of bytes). Design
// (short_attention.cuh, shared with fused_attention.cu): one block per
// (sequence, head) stages its q, k, v tiles in shared memory as T with
// 16-byte cp.async straight from the strided [B, L, E] column slices of the
// merged qkv GEMM (no head transpose, no copy), v in a second group that
// lands while the scores run; one warp per 16-row query tile runs S = QKᵀ
// and P·V on mma.sync (bf16) or CUDA-core FMAs (fp32), the scores and P in
// registers. q is scaled before the first product: bf16 in registers after
// ldmatrix, fp32 in the warp's own shared rows. Causal key tiles wholly
// above a query tile's diagonal are skipped; the diagonal tile is masked in
// the softmax. At L = 50 a block is 4 warps and 27.6 KB of bf16 tiles, so
// several blocks share an SM and one block's copies overlap another's
// products. wgmma would buy nothing here: the products are far below the
// bytes.
//
// Registers (ptxas -v, sm_90a), per instance <T, key tiles, Dh chunks>:
// the path's <bf16, 8, 4> (L <= 64) 77, <bf16, 2, 4> (L <= 16) 52 and
// <fp32, 2, 4> (the CAM) 72; the largest, <fp32, 16, 8>, 168. No instance
// spills (the launch bounds of short_attention.cuh see to that).
//
// Past L = 128 the same contract runs on the long route of
// long_attention.cuh (entry vtc_fused_mha_long below): bf16 up to L = 272
// in one pass over the keys with each head's K and V staged once, fp32 and
// longer rows in two passes over 64-key tiles.
//
// Plain C interface, loaded with ctypes (vtc_tpu_torch/ops/attention.py).

#include "long_attention.cuh"
#include "short_attention.cuh"

namespace {

// the fp32 scores of q·scale (already in T) and k, with the causal mask
struct CausalScore {
  static constexpr bool kScaleQ = true;
  float q_scale;
  int causal;
  __device__ int key_end(int q0, int L) const { return causal ? min(L, q0 + 16) : L; }
  __device__ float operator()(float acc, int row, int key) const {
    return (causal && key > row) ? -INFINITY : acc;
  }
};

// L: the query rows (and the output's), Lk: the keys; Lk = L but on the
// long route with fewer queries than keys
template <typename T>
struct Args {
  const T *q, *k, *v;
  T* o;
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;
  int B, L, Lk, H, Dh, causal, vec_in, vec_out;
  float scale;
};

// block i = b·H + h; head h is columns [h·Dh, (h+1)·Dh) of E
template <typename T>
__device__ __forceinline__ sa::HeadPtrs<T> head(const Args<T>& a, int i) {
  const int b = i / a.H, col = (i - b * a.H) * a.Dh, e = a.H * a.Dh;
  return {a.q + b * a.q_sb + col, a.k + b * a.k_sb + col, a.v + b * a.v_sb + col,
          a.o + (long long)b * a.L * e + col, a.q_sl, a.k_sl, a.v_sl, e};
}

template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<sa::bf16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T, int NKT, int DC>
__global__ void __launch_bounds__(sa::max_threads(NKT), sa::min_blocks(NKT))
fused_mha_kernel(const Args<T> a) {
  const CausalScore score{round_to<T>(a.scale), a.causal};
  sa::attend_block<T, NKT, DC>(head(a, blockIdx.x), a.L, a.Dh, a.vec_in, a.vec_out,
                               score);
}

template <typename T>
struct Launch {
  const Args<T>& a;
  cudaStream_t stream;
  template <int NKT, int DC> cudaError_t run() const {
    return sa::launch_heads<T>(fused_mha_kernel<T, NKT, DC>, a, (long long)a.B * a.H,
                               a.L, a.Dh, stream);
  }
};

template <typename T>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  Launch<T> f{a, stream};
  return sa::with_bucket(a.L, a.Dh, f);
}

// ---- the long route (long_attention.cuh) ----------------------------------------

// the two-pass kernel: one block per (sequence, head, 64-row query tile)
template <typename T, int DC>
__global__ void __launch_bounds__(la::kThreads, la::min_blocks<T>(DC))
fused_mha_long_kernel(const Args<T> a) {
  la::attend_long<T, DC>(head(a, blockIdx.x), a.L, a.Lk, a.Dh, a.causal, round_to<T>(a.scale),
                         a.vec_in, a.vec_out);
}

// the one-pass kernel: one block per (sequence, head), pairs of warps
template <int T, int DC>
__global__ void __launch_bounds__(64 * la::kOnePassPairs, la::one_pass_min_blocks(DC))
fused_mha_long_onepass_kernel(const Args<sa::bf16> a) {
  // a tile's q and output rows, from the kernel's arguments and the block
  // index read anew (volatile: not hoisted) at each tile: the 17-tile
  // instance spilled base addresses held across its tiles
  const auto rows = [=](const sa::bf16* base, long long sb, long long sl, int r0) {
    int i;
    asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(i));
    const int b = i / a.H;
    return base + b * sb + (i - b * a.H) * a.Dh + r0 * sl;
  };
  const auto q_rows = [=](int r0) { return rows(a.q, a.q_sb, a.q_sl, r0); };
  const auto o_rows = [=](int r0) {
    return const_cast<sa::bf16*>(rows(a.o, (long long)a.L * a.H * a.Dh, a.H * a.Dh, r0));
  };
  la::attend_one_pass<T, DC>(head(a, blockIdx.x), q_rows, o_rows, a.L, a.Dh, a.causal,
                             round_to<sa::bf16>(a.scale), a.vec_in, a.vec_out);
}

template <typename T, int DC>
cudaError_t launch_two_pass(const Args<T>& a, cudaStream_t stream) {
  const auto kernel = fused_mha_long_kernel<T, DC>;
  // once per instance: the shared memory of its widest head
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)la::smem_bytes<T>(16 * DC));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((unsigned)((long long)a.B * a.H),
                  (unsigned)((a.L + la::kQueryRows - 1) / la::kQueryRows));
  kernel<<<grid, la::kThreads, la::smem_bytes<T>(a.Dh), stream>>>(a);
  return cudaGetLastError();
}

template <int T, int DC>
cudaError_t launch_one_pass(const Args<sa::bf16>& a, cudaStream_t stream) {
  const auto kernel = fused_mha_long_onepass_kernel<T, DC>;
  const size_t smem = la::one_pass_smem(16 * T, 16 * DC);  // the instance's, at any (L, Dh)
  // once per instance
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  kernel<<<(unsigned)((long long)a.B * a.H), 64 * la::kOnePassPairs, smem, stream>>>(a);
  return cudaGetLastError();
}

// The route's plan, by L (and Dh for the buckets); launch_long follows it and
// the C entry vtc_fused_mha_long_plan reports it (ops.attention.long_plan).
struct Plan {
  int one_pass;   // 1: the one-pass kernel, 0: the two-pass kernel
  int key_tiles;  // one pass: the key tiles of 8 of S each warp holds
  int threads;    // a block
  int smem;       // dynamic shared memory a block, bytes
};

inline Plan long_plan(int L, int Dh, int dtype) {
  if (dtype == 1 && L <= la::kOnePassMaxL)
    return {1, la::one_pass_tiles(L), 64 * la::kOnePassPairs, (int)la::one_pass_smem(L, Dh)};
  return {0, 0, la::kThreads,
          (int)(dtype == 1 ? la::smem_bytes<sa::bf16>(Dh) : la::smem_bytes<float>(Dh))};
}

// Lq = Lk follows long_plan; fewer queries than keys take the two-pass kernel
template <typename T>
cudaError_t launch_long(const Args<T>& a, cudaStream_t stream) {
  if constexpr (std::is_same<T, sa::bf16>::value) {
    const Plan p = long_plan(a.L, a.Dh, 1);
    if (p.one_pass && a.L == a.Lk) {
      if (p.key_tiles == 13)
        return a.Dh <= 64 ? launch_one_pass<13, 4>(a, stream) : launch_one_pass<13, 8>(a, stream);
      return a.Dh <= 64 ? launch_one_pass<17, 4>(a, stream) : launch_one_pass<17, 8>(a, stream);
    }
  }
  return a.Dh <= 64 ? launch_two_pass<T, 4>(a, stream) : launch_two_pass<T, 8>(a, stream);
}

// the kernel's arguments, with 16-byte copies where every base, the head
// offset h·Dh and every row and batch stride are 16-byte multiples
template <typename T>
Args<T> make_args(const void* q, const void* k, const void* v, void* o, long long q_sb,
                  long long q_sl, long long k_sb, long long k_sl, long long v_sb,
                  long long v_sl, int B, int L, int Lk, int H, int Dh, int causal,
                  float scale) {
  const int es = sizeof(T);
  const bool dh16 = (Dh * es) % 16 == 0;
  const bool vec_in = dh16 && sa::aligned16(q) && sa::aligned16(k) && sa::aligned16(v) &&
                      sa::stride16(q_sb, es, B) && sa::stride16(k_sb, es, B) &&
                      sa::stride16(v_sb, es, B) && sa::stride16(q_sl, es, L) &&
                      sa::stride16(k_sl, es, Lk) && sa::stride16(v_sl, es, Lk);
  const bool vec_out = dh16 && sa::aligned16(o);
  return Args<T>{static_cast<const T*>(q), static_cast<const T*>(k),
                 static_cast<const T*>(v), static_cast<T*>(o), q_sb, q_sl, k_sb, k_sl,
                 v_sb, v_sl, B, L, Lk, H, Dh, causal, vec_in, vec_out, scale};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last dim of
// q, k and v is contiguous and o is a contiguous [B, L, H*Dh]. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for shapes the
// kernel does not take).
extern "C" int vtc_fused_mha(const void* q, const void* k, const void* v, void* o,
                             long long q_sb, long long q_sl, long long k_sb,
                             long long k_sl, long long v_sb, long long v_sl, int B,
                             int L, int H, int Dh, int causal, float scale, int dtype,
                             void* stream) {
  if (L < 1 || L > sa::kMaxL || Dh < 1 || Dh > sa::kMaxDh || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch(make_args<float>(q, k, v, o, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, B,
                                        L, L, H, Dh, causal, scale), st);
  if (dtype == 1)
    return (int)launch(make_args<sa::bf16>(q, k, v, o, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl,
                                           B, L, L, H, Dh, causal, scale), st);
  return (int)cudaErrorInvalidValue;
}

// The long route at any Lq >= 1 (the wrapper takes it past L = 128, and for
// fewer queries than keys): q and o are [B, Lq, H*Dh], k and v [B, Lk, H*Dh],
// Lq <= Lk, the causal mask at Lq = Lk only. At Lq = Lk bf16 up to L = 272
// runs on the one-pass kernel, past it and in fp32 on the two-pass kernel;
// Lq < Lk runs on the two-pass kernel. At most 65,535 query tiles of 64 rows.
extern "C" int vtc_fused_mha_long(const void* q, const void* k, const void* v, void* o,
                                  long long q_sb, long long q_sl, long long k_sb,
                                  long long k_sl, long long v_sb, long long v_sl, int B,
                                  int Lq, int Lk, int H, int Dh, int causal, float scale,
                                  int dtype, void* stream) {
  if (Lq < 1 || Lk < Lq || (causal && Lq != Lk) ||
      (Lq + la::kQueryRows - 1) / la::kQueryRows > 65535 || Dh < 1 || Dh > sa::kMaxDh ||
      B < 1 || H < 1 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_long(make_args<float>(q, k, v, o, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl,
                                             B, Lq, Lk, H, Dh, causal, scale), st);
  if (dtype == 1)
    return (int)launch_long(make_args<sa::bf16>(q, k, v, o, q_sb, q_sl, k_sb, k_sl, v_sb,
                                                v_sl, B, Lq, Lk, H, Dh, causal, scale), st);
  return (int)cudaErrorInvalidValue;
}

// The plan vtc_fused_mha_long follows at (L, Dh, dtype): out = {one_pass,
// key_tiles, threads, smem}. Returns 0, or cudaErrorInvalidValue.
extern "C" int vtc_fused_mha_long_plan(int L, int Dh, int dtype, int* out) {
  if (L < 1 || Dh < 1 || Dh > sa::kMaxDh || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Plan p = long_plan(L, Dh, dtype);
  out[0] = p.one_pass;
  out[1] = p.key_tiles;
  out[2] = p.threads;
  out[3] = p.smem;
  return 0;
}
