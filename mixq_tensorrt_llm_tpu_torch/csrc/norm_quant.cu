// K1: fused RMSNorm -> outlier split -> per-token int8 quantization.
//
// Replaces mixq_tensorrt_llm_tpu/ops/norm_quant.py _norm_quant_kernel
// (rmsnorm_quant_split, and quant_split without the norm). One block per
// row: the row is read once into shared memory as f32 and everything else
// happens there.
//
//   1. sum of squares in f32 (fixed-order block reduction);
//   2. x * rsqrt(mean + eps) * gamma, kept in f32 (the TPU kernel does not
//      round the normed row to bf16 either);
//   3. x_out[j] = bf16(row[fp_ind[j]]): a direct gather where the TPU
//      kernel contracts with a one-hot matrix on the MXU. That product
//      picks exactly one term per output, so the two agree bit for bit;
//   4. the outlier channels are set to 0 (through the same indices);
//   5. scale = max(absmax / 127, 1e-8) by true division (__fdiv_rn);
//      q = clip(rint(x / scale), -127, 127), round half to even.
//
// Bound on the H100: bytes. Per row it reads K values and writes K int8,
// 4 scale bytes and ko bf16; a few flops per byte. The design moves each
// byte once; nvcc must not be given --use_fast_math (steps 2 and 5 rely on
// IEEE division and rounding).

#include "common.cuh"

namespace mixq {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int t = 0; t < 8; ++t) v[t] = __bfloat162float(b[t]);
}

// every thread gets the block's sum (or max); red holds kWarps floats
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();                     // red may still be read from before
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r = MAX ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

template <typename T, bool NORM>
__global__ void __launch_bounds__(kThreads)
norm_quant_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const int* __restrict__ fp_ind, int8_t* __restrict__ qx,
                  float* __restrict__ srow, __nv_bfloat16* __restrict__ xout,
                  int K, int ko, float eps) {
  extern __shared__ float xs[];        // the row, K floats
  __shared__ float red[kWarps];
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const T* xr = x + row * K;

  float ss = 0.f;
  for (int c = tid * 8; c < K; c += kThreads * 8) {
    float v[8];
    load8(xr + c, v);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      xs[c + t] = v[t];
      ss += v[t] * v[t];
    }
  }
  if (NORM) {
    ss = block_reduce<false>(ss, red);
    const float inv = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, static_cast<float>(K)),
                                            eps));
    for (int c = tid; c < K; c += kThreads)
      xs[c] = __fmul_rn(__fmul_rn(xs[c], inv), gamma[c]);
  }
  __syncthreads();

  for (int j = tid; j < ko; j += kThreads) {
    const int i = fp_ind[j];
    xout[row * ko + j] = __float2bfloat16(i >= 0 && i < K ? xs[i] : 0.f);
  }
  __syncthreads();
  for (int j = tid; j < ko; j += kThreads) {
    const int i = fp_ind[j];
    if (i >= 0 && i < K) xs[i] = 0.f;
  }
  __syncthreads();

  float amax = 0.f;
  for (int c = tid; c < K; c += kThreads) amax = fmaxf(amax, fabsf(xs[c]));
  amax = block_reduce<true>(amax, red);
  const float scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
  if (tid == 0) srow[row] = scale;

  int8_t* qr = qx + row * K;
  for (int c = tid * 8; c < K; c += kThreads * 8) {
    __align__(8) int8_t q[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float v = rintf(__fdiv_rn(xs[c + t], scale));
      q[t] = static_cast<int8_t>(fminf(fmaxf(v, -127.f), 127.f));
    }
    *reinterpret_cast<uint2*>(qr + c) = *reinterpret_cast<const uint2*>(q);
  }
}

template <typename T, bool NORM>
int launch(const void* x, const void* gamma, const void* fp_ind, void* qx,
           void* srow, void* xout, int M, int K, int ko, float eps,
           cudaStream_t st) {
  auto kernel = norm_quant_kernel<T, NORM>;
  const int smem = K * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<M, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const int*>(fp_ind), static_cast<int8_t*>(qx),
      static_cast<float*>(srow), static_cast<__nv_bfloat16*>(xout), K, ko,
      eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mixq

using namespace mixq;

extern "C" const char* mixq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (M, K) of `dtype`, gamma (K,) f32 (read only when do_norm), fp_ind (ko,)
// int32 -> q_x (M, K) int8, scale_row (M,) f32, x_out (M, ko) bf16. The
// wrapper guarantees M >= 1, K % 8 == 0, K <= 32768, 16-byte aligned x.
extern "C" int mixq_norm_quant_split(const void* x, const void* gamma,
                                     const void* fp_ind, void* qx, void* srow,
                                     void* xout, int M, int K, int ko,
                                     float eps, int do_norm, int dtype,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return do_norm ? launch<__nv_bfloat16, true>(x, gamma, fp_ind, qx, srow,
                                                 xout, M, K, ko, eps, st)
                   : launch<__nv_bfloat16, false>(x, gamma, fp_ind, qx, srow,
                                                  xout, M, K, ko, eps, st);
  if (dtype == kF32)
    return do_norm ? launch<float, true>(x, gamma, fp_ind, qx, srow, xout, M,
                                         K, ko, eps, st)
                   : launch<float, false>(x, gamma, fp_ind, qx, srow, xout, M,
                                          K, ko, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
