// Shared helpers for the port's CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mixq {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kNegInf = -1e30f;   // the Pallas kernels' NEG_INF mask value

// element types a wrapper may pass; the value is the C interface's dtype code
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

// int8 KV pages come with per-(token, head) f32 scales; bf16 and f32 pages
// hold the values themselves
template <typename P>
constexpr bool kQuantPages = std::is_same<P, int8_t>::value;

template <typename X>
struct Type {
  using type = X;
};

// f(Type<T>{}, Type<P>{}) for the value type T (f32 or bf16) and the KV
// page type P (int8, bf16 or f32) a wrapper passes as dtype codes.
template <typename F>
int with_page_types(int dtype, int page_dtype, F f) {
  auto pages = [&](auto t) {
    if (page_dtype == kI8) return f(t, Type<int8_t>{});
    if (page_dtype == kBF16) return f(t, Type<__nv_bfloat16>{});
    if (page_dtype == kF32) return f(t, Type<float>{});
    return static_cast<int>(cudaErrorInvalidValue);
  };
  if (dtype == kBF16) return pages(Type<__nv_bfloat16>{});
  if (dtype == kF32) return pages(Type<float>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// f(Type<OutT>{}) for the output type (f32 or bf16) a wrapper passes
template <typename F>
int with_out_type(int out_dtype, F f) {
  if (out_dtype == kBF16) return f(Type<__nv_bfloat16>{});
  if (out_dtype == kF32) return f(Type<float>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}
__device__ __forceinline__ int warp_max_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Causal + StreamingLLM window/sink mask on absolute positions
// (ops/paged_attention.py _mask_positions).
__device__ __forceinline__ bool keep_position(int pos_kv, int pos_q,
                                              int window, int sink) {
  bool keep = pos_kv <= pos_q;
  if (window) keep = keep && (pos_kv > pos_q - window || pos_kv < sink);
  return keep;
}

}  // namespace mixq

extern "C" const char* mixq_error_string(int err);
