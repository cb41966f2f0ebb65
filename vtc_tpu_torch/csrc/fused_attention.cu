// Attention over [B, H, L, D] with an optional additive [L, L] mask, forward.
//
// Replaces the Pallas kernel vtc_tpu/ops/pallas_attention.py:fused_attention
// (_fused_attention_fwd_impl :69, _attn_kernel :42). Contract, that of
// _reference_attention (:118): scores = the fp32 product q·kᵀ times the scale
// in fp32 (q is not scaled in its own type, unlike fused_mha), plus the fp32
// mask broadcast over batch and heads, softmax in fp32 (max subtracted,
// e / Σe), P rounded to q's type, P@V with an fp32 accumulator, output
// rounded to q's type. The Pallas form's L and D padding, its key-pad -inf
// columns and its padded rows that attend column 0 change no real row and
// are not carried over: nothing is padded here.
//
// Bound on the H100: bytes. q, k, v are read once and o written once
// (4·B·H·L·D elements); the work, 4·B·H·L²·D flops, is far below the card's
// ops-per-byte balance at L <= 128 (at the TimeSformer's temporal shape,
// L = 8, it is 16 flops per element moved). So the design keeps the scores
// and P out of device memory: one block per (sequence, head) stages that
// head's K and V in shared memory, and each warp walks its query rows with
// the whole score row in registers (4 keys per lane). Every tensor comes
// with its (batch, head, row) strides, so the TimeSformer hands over the 4-D
// head views of its merged qkv GEMM's column slices with no transpose copy,
// and the output is written in the [B, L, H, D] order that out_proj reads.
// Tensor cores, and several short sequences per warp at L = 8, are later
// work.
//
// Plain C interface, loaded with ctypes (vtc_tpu_torch/ops/attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxL = 128;  // keys per row: 4 per lane
constexpr int kMaxD = 128;  // output columns per row: 4 per lane

struct Strides {
  long long b, h, l;  // in elements; the last dim is contiguous
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bfloat16)
}

// the value x takes once stored in T
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory: K [L][D+1] (the +1 pad puts lane j's key row on its own
// bank), V [L][D], and per warp one q row [D] and one P row [L].
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
fused_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ mask,
                       T* __restrict__ o, Strides sq, Strides sk, Strides sv,
                       Strides so, int H, int L, int D, float scale) {
  extern __shared__ float smem[];
  const int ks = D + 1;
  float* Ks = smem;
  float* Vs = Ks + L * ks;
  float* Qs = Vs + L * D;
  float* Ps = Qs + kWarps * D;

  const long long b = blockIdx.x / H;
  const long long h = blockIdx.x % H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  T* ob = o + b * so.b + h * so.h;

  // neighbouring threads read neighbouring columns of one key row
  for (int i = threadIdx.x; i < L * D; i += blockDim.x) {
    const int j = i / D, d = i % D;
    Ks[j * ks + d] = to_f32(kb[j * sk.l + d]);
    Vs[j * D + d] = to_f32(vb[j * sv.l + d]);
  }
  __syncthreads();

  float* qrow = Qs + warp * D;
  float* prow = Ps + warp * L;

  for (int r = warp; r < L; r += kWarps) {
    for (int d = lane; d < D; d += 32) qrow[d] = to_f32(qb[r * sq.l + d]);
    __syncwarp();

    const float* mrow = mask != nullptr ? mask + (long long)r * L : nullptr;
    float sc[kMaxL / 32];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxL / 32; ++t) {
      const int j = lane + 32 * t;
      float s = -INFINITY;
      if (j < L) {
        float acc = 0.f;
        const float* krow = Ks + j * ks;
        for (int d = 0; d < D; ++d) acc = fmaf(qrow[d], krow[d], acc);
        s = acc * scale;
        if (mrow != nullptr) s += mrow[j];
      }
      sc[t] = s;
      m = fmaxf(m, s);
    }
    // a row the mask covers whole has m = -inf and gives NaN, as the
    // reference's softmax does
    m = warp_max(m);

    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxL / 32; ++t) {
      const int j = lane + 32 * t;
      sc[t] = j < L ? expf(sc[t] - m) : 0.f;
      sum += sc[t];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < kMaxL / 32; ++t) {
      const int j = lane + 32 * t;
      if (j < L) prow[j] = round_to<T>(sc[t] / sum);
    }
    __syncwarp();

#pragma unroll
    for (int t = 0; t < kMaxD / 32; ++t) {
      const int d = lane + 32 * t;
      if (d < D) {
        float acc = 0.f;
        for (int j = 0; j < L; ++j) acc = fmaf(prow[j], Vs[j * D + d], acc);
        ob[r * so.l + d] = from_f32<T>(acc);
      }
    }
    __syncwarp();  // qrow and prow are rewritten by the next row
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* mask,
                   void* o, Strides sq, Strides sk, Strides sv, Strides so, int B,
                   int H, int L, int D, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)L * (D + 1) + (size_t)L * D + kWarps * (D + L));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  fused_attention_kernel<T><<<B * H, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      mask, static_cast<T*>(o), sq, sk, sv, so, H, L, D, scale);
  return cudaGetLastError();
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
  if (L < 1 || L > kMaxL || D < 1 || D > kMaxD || B < 1 || H < 1 ||
      (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Strides sq{q_sb, q_sh, q_sl}, sk{k_sb, k_sh, k_sl}, sv{v_sb, v_sh, v_sl},
      so{o_sb, o_sh, o_sl};
  const float* m = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, m, o, sq, sk, sv, so, B, H, L, D, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, m, o, sq, sk, sv, so, B, H, L, D,
                                      scale, st);
  return (int)cudaErrorInvalidValue;
}
