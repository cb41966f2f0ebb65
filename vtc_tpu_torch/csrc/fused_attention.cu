// Attention over [B, H, L, D] with an optional additive [L, L] mask, forward.
//
// Replaces the Pallas kernel vtc_tpu/ops/pallas_attention.py:fused_attention
// (_fused_attention_fwd_impl :69, _attn_kernel :42). Contract, that of
// _reference_attention (:118): scores = the fp32 product q·kᵀ times the scale
// in fp32 (q is not scaled in its own type, unlike fused_mha), plus the fp32
// mask broadcast over batch and heads, softmax in fp32 (max subtracted,
// e / Σe; a row the mask covers whole gives NaN), P rounded to q's type,
// P@V with an fp32 accumulator, output rounded to q's type. The Pallas
// form's padding to (8, 128) tiles changes no real row and is not carried
// over.
//
// Bound on the H100: bytes. q, k, v are read once and o written once
// (4·B·H·L·D elements); the work, 4·B·H·L²·D flops, is far below the card's
// ops-per-byte balance at L <= 128 (at the TimeSformer's temporal shape,
// L = 8, it is 16 flops per element moved). Design (short_attention.cuh,
// shared with fused_mha.cu): every tensor comes with its (batch, head, row)
// strides, so the TimeSformer hands over the 4-D head views of its merged
// qkv GEMM's column slices with no transpose copy, and the output is
// written in the [B, L, H, D] order that out_proj reads. A block stages one
// (sequence, head)'s q, k, v in shared memory with 16-byte cp.async; one
// warp per 16-row query tile runs S = QKᵀ and P·V on mma.sync (bf16) or
// CUDA-core FMAs (fp32), scores and P in registers, the scale and the mask
// applied to the fp32 S fragment. At L = 8 a (sequence, head) is an 8 × 64
// tile of 1 KB per tensor, one warp's block: one m16n8k16 tile for S with 8
// real rows, P·V at k = 16 with keys 8-15 zero. 32 such blocks share an SM,
// so it has about 96 KB of copies in flight.
//
// Registers (ptxas -v, sm_90a), per instance <T, key tiles, Dh chunks>:
// the temporal attention's <bf16, 2, 4> 48 (fp32: 68); the largest,
// <fp32, 16, 8>, 168. No instance spills.
//
// Plain C interface, loaded with ctypes (vtc_tpu_torch/ops/attention.py).

#include "short_attention.cuh"

namespace {

struct Strides {
  long long b, h, l;  // in elements; the last dim is contiguous
};

// the fp32 scores times the scale, plus the mask (real rows only: padded
// query rows are never stored)
struct MaskScore {
  static constexpr bool kScaleQ = false;
  float scale;
  const float* mask;
  int L;
  __device__ int key_end(int, int L_) const { return L_; }
  __device__ float operator()(float acc, int row, int key) const {
    const float x = acc * scale;
    return (mask != nullptr && row < L) ? x + __ldg(mask + row * L + key) : x;
  }
};

template <typename T>
struct Args {
  const T *q, *k, *v;
  const float* mask;
  T* o;
  Strides sq, sk, sv, so;
  int B, H, L, D, vec_in, vec_out;
  float scale;
};

// block i = b·H + h
template <typename T>
__device__ __forceinline__ sa::HeadPtrs<T> head(const Args<T>& a, int i) {
  const int b = i / a.H, h = i - b * a.H;
  return {a.q + b * a.sq.b + h * a.sq.h, a.k + b * a.sk.b + h * a.sk.h,
          a.v + b * a.sv.b + h * a.sv.h, a.o + b * a.so.b + h * a.so.h,
          a.sq.l, a.sk.l, a.sv.l, a.so.l};
}

template <typename T, int NKT, int DC>
__global__ void __launch_bounds__(sa::max_threads(NKT), sa::min_blocks(NKT))
fused_attention_kernel(const Args<T> a) {
  const MaskScore score{a.scale, a.mask, a.L};
  sa::attend_block<T, NKT, DC>(head(a, blockIdx.x), a.L, a.D, a.vec_in, a.vec_out,
                               score);
}

template <typename T>
struct Launch {
  const Args<T>& a;
  cudaStream_t stream;
  template <int NKT, int DC> cudaError_t run() const {
    return sa::launch_heads<T>(fused_attention_kernel<T, NKT, DC>, a,
                               (long long)a.B * a.H, a.L, a.D, stream);
  }
};

bool strides16(const void* p, const Strides& s, int es, int B, int H, int L) {
  return sa::aligned16(p) && sa::stride16(s.b, es, B) && sa::stride16(s.h, es, H) &&
         sa::stride16(s.l, es, L);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* mask,
                   void* o, Strides sq, Strides sk, Strides sv, Strides so, int B,
                   int H, int L, int D, float scale, cudaStream_t stream) {
  const int es = sizeof(T);
  const bool d16 = (D * es) % 16 == 0;
  const bool vec_in = d16 && strides16(q, sq, es, B, H, L) &&
                      strides16(k, sk, es, B, H, L) && strides16(v, sv, es, B, H, L);
  const bool vec_out = d16 && strides16(o, so, es, B, H, L);
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), mask, static_cast<T*>(o), sq, sk, sv, so,
                  B, H, L, D, vec_in, vec_out, scale};
  Launch<T> f{a, stream};
  return sa::with_bucket(L, D, f);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o are [B, H, L, D] with the
// (batch, head, row) strides given in elements and a contiguous last dim;
// mask is a contiguous fp32 [L, L] or null. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for shapes the kernel does not
// take).
extern "C" int vtc_fused_attention(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    long long q_sb, long long q_sh, long long q_sl, long long k_sb, long long k_sh,
    long long k_sl, long long v_sb, long long v_sh, long long v_sl, long long o_sb,
    long long o_sh, long long o_sl, int B, int H, int L, int D, float scale,
    int dtype, void* stream) {
  if (L < 1 || L > sa::kMaxL || D < 1 || D > sa::kMaxDh || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const Strides sq{q_sb, q_sh, q_sl}, sk{k_sb, k_sh, k_sl}, sv{v_sb, v_sh, v_sl},
      so{o_sb, o_sh, o_sl};
  const float* m = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, m, o, sq, sk, sv, so, B, H, L, D, scale, st);
  if (dtype == 1)
    return (int)launch<sa::bf16>(q, k, v, m, o, sq, sk, sv, so, B, H, L, D, scale, st);
  return (int)cudaErrorInvalidValue;
}
