// Heads-packed multi-head attention for short sequences (L <= 128), forward.
//
// Replaces the Pallas kernel vtc_tpu/ops/pallas_attention.py:fused_mha
// (_fused_mha_fwd_impl :223, _mha_kernel :182). Contract, that of
// _mha_reference (:268): q is scaled by Dh^-0.5 in q's type, QK^T in fp32,
// optional causal mask, softmax in fp32, P rounded to q's type, P@V with an
// fp32 accumulator, output rounded to q's type. The TPU kernel's 128-row
// supertile packing and block-diagonal mask are means of the TPU, not part
// of the contract, and are not carried over.
//
// Bound on the H100: bytes. q, k, v are read once and o written once
// (4·B·L·E elements); the work is 4·B·H·L²·Dh flops, far below the card's
// ops-per-byte balance at L <= 128. So the design keeps the scores and P out
// of device memory: one block per (sequence, head) stages that head's Dh
// slice of K and V in shared memory straight from the [B, L, E] layout (no
// head transpose, no copy of the strided q/k/v views of the merged qkv GEMM),
// and each warp walks its query rows with the whole score row in registers.
// Tensor cores (wgmma) and TMA are later work.
//
// Plain C interface, loaded with ctypes (vtc_tpu_torch/ops/attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxL = 128;   // keys per row: 4 per lane
constexpr int kMaxDh = 128;  // output columns per row: 4 per lane

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

// Shared memory: K [L][Dh+1] (the +1 pad puts lane j's key row on its own
// bank), V [L][Dh], and per warp one scaled q row [Dh] and one P row [L].
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
fused_mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 long long q_sb, long long q_sl, long long k_sb, long long k_sl,
                 long long v_sb, long long v_sl, int L, int H, int Dh,
                 int causal, float scale) {
  extern __shared__ float smem[];
  const int ks = Dh + 1;
  float* Ks = smem;
  float* Vs = Ks + L * ks;
  float* Qs = Vs + L * Dh;
  float* Ps = Qs + kWarps * Dh;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int E = H * Dh;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* qb = q + b * q_sb + h * Dh;
  const T* kb = k + b * k_sb + h * Dh;
  const T* vb = v + b * v_sb + h * Dh;
  T* ob = o + (long long)b * L * E + h * Dh;

  // neighbouring threads read neighbouring columns of one key row
  for (int i = threadIdx.x; i < L * Dh; i += blockDim.x) {
    const int j = i / Dh, d = i % Dh;
    Ks[j * ks + d] = to_f32(kb[j * k_sl + d]);
    Vs[j * Dh + d] = to_f32(vb[j * v_sl + d]);
  }
  __syncthreads();

  // the scale rounded to T, then the product rounded to T: q * asarray(s, T)
  const float s = round_to<T>(scale);
  float* qrow = Qs + warp * Dh;
  float* prow = Ps + warp * L;

  for (int r = warp; r < L; r += kWarps) {
    for (int d = lane; d < Dh; d += 32) qrow[d] = round_to<T>(to_f32(qb[r * q_sl + d]) * s);
    __syncwarp();

    const int n_keys = causal ? r + 1 : L;
    float sc[kMaxL / 32];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxL / 32; ++t) {
      const int j = lane + 32 * t;
      float acc = -INFINITY;
      if (j < n_keys) {
        acc = 0.f;
        const float* krow = Ks + j * ks;
        for (int d = 0; d < Dh; ++d) acc = fmaf(qrow[d], krow[d], acc);
      }
      sc[t] = acc;
      m = fmaxf(m, acc);
    }
    m = warp_max(m);  // key 0 is always visible, so m is finite

    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxL / 32; ++t) {
      const int j = lane + 32 * t;
      sc[t] = j < n_keys ? expf(sc[t] - m) : 0.f;
      sum += sc[t];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < kMaxL / 32; ++t) {
      const int j = lane + 32 * t;
      if (j < n_keys) prow[j] = round_to<T>(sc[t] / sum);
    }
    __syncwarp();

#pragma unroll
    for (int t = 0; t < kMaxDh / 32; ++t) {
      const int d = lane + 32 * t;
      if (d < Dh) {
        float acc = 0.f;
        for (int j = 0; j < n_keys; ++j) acc = fmaf(prow[j], Vs[j * Dh + d], acc);
        ob[r * E + d] = from_f32<T>(acc);
      }
    }
    __syncwarp();  // qrow and prow are rewritten by the next row
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   long long q_sb, long long q_sl, long long k_sb, long long k_sl,
                   long long v_sb, long long v_sl, int B, int L, int H, int Dh,
                   int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)L * (Dh + 1) + (size_t)L * Dh + kWarps * (Dh + L));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_mha_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  fused_mha_kernel<T><<<B * H, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, L, H, Dh, causal, scale);
  return cudaGetLastError();
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
  if (L < 1 || L > kMaxL || Dh < 1 || Dh > kMaxDh || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, o, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, B, L, H,
                              Dh, causal, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl,
                                      B, L, H, Dh, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
