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

// 8 consecutive row values (16 bytes of bf16, 32 of f32), kept as loaded
template <typename T>
struct Chunk;
template <>
struct Chunk<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void get(float f[8]) const {
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {     // exact: a bf16 is the top of an f32
      f[2 * i] = __uint_as_float(ws[i] << 16);
      f[2 * i + 1] = __uint_as_float(ws[i] & 0xFFFF0000u);
    }
  }
};
template <>
struct Chunk<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void get(float f[8]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

// clip(rint(y / scale), -127, 127) with the quotient rounded as
// __fdiv_rn rounds it, without a division (Markstein's theorem): with rcp =
// RN(1 / scale), q0 = RN(y * rcp) lies within an ulp of y / scale, so r =
// y - q0 * scale is exact in one fma and RN(q0 + r * rcp) is the correctly
// rounded quotient (for scale = max(absmax / 127, 1e-8) over y's row,
// |y / scale| <= 127 * (1 + 2^-24) and scale >= 1e-8: nothing overflows,
// and a quotient small enough to underflow rounds to code 0 either way).
// The quotient is clipped before it is rounded, where the plain version
// rounds first: at +-127, an integer, the two agree (a quotient beyond 127
// rounds to 127 or further out, and clips to 127 either way). Rounding
// adds kRound (1.5 * 2^23: the sum keeps no fraction, ties to even), so
// the code is the low byte of the sum's bits: no conversion instruction,
// no branch. Used by K1 (norm_quant.cu) and K5 / K6 (paged_write.cu).
constexpr float kRound = 12582912.f;
__device__ __forceinline__ uint32_t qcode(float y, float scale, float rcp) {
  const float q0 = __fmul_rn(y, rcp);
  const float q = __fmaf_rn(__fmaf_rn(-q0, scale, y), rcp, q0);
  return __float_as_uint(__fadd_rn(fminf(fmaxf(q, -127.f), 127.f), kRound));
}

// 8 values quantized, as 8 int8 codes
__device__ __forceinline__ uint2 quant8(const float y[8], float scale,
                                        float rcp) {
  uint32_t v[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) v[t] = qcode(y[t], scale, rcp);
  // the low bytes of 4 words: (v0, v1), (v2, v3), then the two pairs
  auto pack = [](const uint32_t* u) {
    return __byte_perm(__byte_perm(u[0], u[1], 0x0040),
                       __byte_perm(u[2], u[3], 0x0040), 0x5410);
  };
  return make_uint2(pack(v), pack(v + 4));
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
