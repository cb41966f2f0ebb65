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
// Plain C interface, loaded with ctypes (vtc_tpu_torch/ops/attention.py).

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

template <typename T>
struct Args {
  const T *q, *k, *v;
  T* o;
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;
  int B, L, H, Dh, causal, vec_in, vec_out;
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
cudaError_t launch(const void* q, const void* k, const void* v, void* o, long long q_sb,
                   long long q_sl, long long k_sb, long long k_sl, long long v_sb,
                   long long v_sl, int B, int L, int H, int Dh, int causal, float scale,
                   cudaStream_t stream) {
  const int es = sizeof(T);
  // 16-byte copies need every base, the head offset h·Dh and every row and
  // batch stride at 16-byte multiples
  const bool dh16 = (Dh * es) % 16 == 0;
  const bool vec_in = dh16 && sa::aligned16(q) && sa::aligned16(k) && sa::aligned16(v) &&
                      sa::stride16(q_sb, es, B) && sa::stride16(k_sb, es, B) &&
                      sa::stride16(v_sb, es, B) && sa::stride16(q_sl, es, L) &&
                      sa::stride16(k_sl, es, L) && sa::stride16(v_sl, es, L);
  const bool vec_out = dh16 && sa::aligned16(o);
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<T*>(o), q_sb, q_sl, k_sb, k_sl,
                  v_sb, v_sl, B, L, H, Dh, causal, vec_in, vec_out, scale};
  Launch<T> f{a, stream};
  return sa::with_bucket(L, Dh, f);
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
    return (int)launch<float>(q, k, v, o, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, B, L, H,
                              Dh, causal, scale, st);
  if (dtype == 1)
    return (int)launch<sa::bf16>(q, k, v, o, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, B, L, H,
                                 Dh, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
