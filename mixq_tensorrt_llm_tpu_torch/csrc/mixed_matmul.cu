// K2 / K3: the MixQ mixed-precision GEMM (W8A8O16) and its epilogue pass.
//
//   out[m, n] = acc[m, n] * scale_row[m] * scale_col[n]
//             + sum_j x_out[m, j] * fp_weight[j, n]          (then SiLU)
//   acc = q_x @ qweight, exact in int32
//
// Replaces mixq_tensorrt_llm_tpu/ops/mixed_matmul.py:
//   K2  _mixed_kernel     (mixed_matmul: int8 GEMM + side GEMM + epilogue)
//   K3  _epilogue_kernel  (mixed_matmul_hybrid: the same epilogue over an
//                          int32 accumulator computed outside, here by
//                          torch._int_mm as the JAX function leaves it to
//                          an XLA dot)
//
// Bound on the H100: operations at prefill sizes (M ~ 1024: 2*M*N*K int8
// ops against N*K weight bytes), bytes at small M. The design keeps
// everything but the int8 operands and the output out of device memory:
// 128 x 128 output tiles, 8 warps of 32 x 64, int8 tensor-core wmma
// (16x16x16, s32 accumulate, exact) over 64-deep K steps staged in shared
// memory, the next step's global loads held in registers meanwhile. The
// outlier side GEMM (bf16 x_out (M, ko) @ fp_weight (ko, N), f32
// accumulate) runs in the same block on bf16 wmma, 32 outlier channels a
// step, into its own f32 fragments. The epilogue then goes one 16 x 16
// fragment at a time through the warp's scratch, in the JAX order:
// acc*srow*scol, + side, SiLU, output type; __fmul_rn/__fadd_rn keep nvcc
// from fusing them into an FMA that would round differently.
//
// wmma loads need 32-byte aligned tile pointers, which 16-byte int8 k
// slices of a padded row-major tile are not. The int8 tiles are therefore
// kept as 16-column chunks: chunk c of the A tile holds its 128 rows x 16
// k-bytes contiguously, chunk c of the B tile its 64 k-rows x 16 n-bytes
// (row-major, ldm 16), each chunk padded by 32 bytes against bank
// conflicts while staging.
//
// Rows of M past the end are masked (zero-filled on load, not stored);
// K % 64 == 0, N % 128 == 0 and ko % 8 == 0 are checked by the wrapper.

#include <mma.h>

#include "common.cuh"

namespace mixq {

using namespace nvcuda;

constexpr int kBM = 128, kBN = 128, kBK = 64, kSK = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAChunk = kBM * 16 + 32;               // bytes
constexpr int kBChunk = kBK * 16 + 32;
constexpr int kInt8Stage = (kBK / 16) * kAChunk + (kBN / 16) * kBChunk;
constexpr int kLdS = kSK + 8;                        // side A, bf16 elements
constexpr int kLdW = kBN + 8;                        // side B
constexpr int kSideStage = (kBM * kLdS + kSK * kLdW) * 2;
constexpr int kStage = kInt8Stage > kSideStage ? kInt8Stage : kSideStage;

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  __align__(16) __nv_bfloat16 b[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) b[t] = __float2bfloat16(v[t]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(b);
}

// FROM_ACC: K3 (acc read from device memory) instead of K2 (acc computed)
template <bool FROM_ACC, typename OutT>
__device__ __forceinline__ void mixed_body(
    const int8_t* __restrict__ qx, const int* __restrict__ acc_in,
    const float* __restrict__ srow, const __nv_bfloat16* __restrict__ xo,
    const int8_t* __restrict__ qw, const float* __restrict__ scol,
    const __nv_bfloat16* __restrict__ fpw, OutT* __restrict__ out, int M,
    int K, int N, int ko, int silu) {
  __shared__ __align__(128) unsigned char stage[kStage];
  __shared__ __align__(128) int scratch_i[kWarps][16 * 16];
  __shared__ __align__(128) float scratch_f[kWarps][16 * 16];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;          // 4 x 2 warps of 32 x 64
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][4];
  if constexpr (!FROM_ACC) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0);
    int8_t* As = reinterpret_cast<int8_t*>(stage);
    int8_t* Bs = As + (kBK / 16) * kAChunk;
    // A: 128 x 64 bytes, B: 64 x 128 bytes; 2 uint4 of each a thread
    uint4 ra[2], rb[2];
    auto load = [&](int k0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kThreads;
        const int ar = idx >> 2, ac = idx & 3;
        ra[i] = m0 + ar < M
                    ? *reinterpret_cast<const uint4*>(
                          qx + static_cast<size_t>(m0 + ar) * K + k0 + ac * 16)
                    : make_uint4(0u, 0u, 0u, 0u);
        const int br = idx >> 3, bc = idx & 7;
        rb[i] = *reinterpret_cast<const uint4*>(
            qw + static_cast<size_t>(k0 + br) * N + n0 + bc * 16);
      }
    };
    const int steps = K / kBK;
    load(0);
    for (int s = 0; s < steps; ++s) {
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kThreads;
        *reinterpret_cast<uint4*>(As + (idx & 3) * kAChunk + (idx >> 2) * 16) =
            ra[i];
        *reinterpret_cast<uint4*>(Bs + (idx & 7) * kBChunk + (idx >> 3) * 16) =
            rb[i];
      }
      __syncthreads();
      if (s + 1 < steps) load((s + 1) * kBK);
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                       wmma::row_major> b[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(
              a[i],
              reinterpret_cast<const signed char*>(As + kc * kAChunk +
                                                   (wm * 32 + i * 16) * 16),
              16);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(
              b[j],
              reinterpret_cast<const signed char*>(
                  Bs + (wn * 4 + j) * kBChunk + kc * 16 * 16),
              16);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
  }

  // outlier side GEMM, kSK channels a step
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> side[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(side[i][j], 0.f);
  __nv_bfloat16* Ss = reinterpret_cast<__nv_bfloat16*>(stage);
  __nv_bfloat16* Ws = Ss + kBM * kLdS;
  for (int s0 = 0; s0 < ko; s0 += kSK) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      const int sr = idx >> 2, sc = (idx & 3) * 8;       // 128 x 32
      *reinterpret_cast<uint4*>(Ss + sr * kLdS + sc) =
          (m0 + sr < M && s0 + sc < ko)
              ? *reinterpret_cast<const uint4*>(
                    xo + static_cast<size_t>(m0 + sr) * ko + s0 + sc)
              : make_uint4(0u, 0u, 0u, 0u);
      const int wr = idx >> 4, wc = (idx & 15) * 8;      // 32 x 128
      *reinterpret_cast<uint4*>(Ws + wr * kLdW + wc) =
          s0 + wr < ko ? *reinterpret_cast<const uint4*>(
                             fpw + static_cast<size_t>(s0 + wr) * N + n0 + wc)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], Ss + (wm * 32 + i * 16) * kLdS + kk,
                               kLdS);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], Ws + kk * kLdW + wn * 64 + j * 16, kLdW);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(side[i][j], a[i], b[j], side[i][j]);
    }
  }

  int* ci = scratch_i[warp];
  float* cf = scratch_f[warp];
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (!FROM_ACC)
        wmma::store_matrix_sync(ci, acc[i][j], 16, wmma::mem_row_major);
      wmma::store_matrix_sync(cf, side[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wm * 32 + i * 16 + r;
      const int col = n0 + wn * 64 + j * 16 + c0;
      if (row < M) {
        const float sr = srow[row];
        float v[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int a = FROM_ACC ? acc_in[static_cast<size_t>(row) * N + col + t]
                                 : ci[r * 16 + c0 + t];
          float y = __fmul_rn(__fmul_rn(__int2float_rn(a), sr), scol[col + t]);
          y = __fadd_rn(y, cf[r * 16 + c0 + t]);
          if (silu) y = __fmul_rn(y, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-y))));
          v[t] = y;
        }
        store8(out + static_cast<size_t>(row) * N + col, v);
      }
      __syncwarp();
    }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
mixed_matmul_kernel(const int8_t* qx, const float* srow,
                    const __nv_bfloat16* xo, const int8_t* qw,
                    const float* scol, const __nv_bfloat16* fpw, OutT* out,
                    int M, int K, int N, int ko, int silu) {
  mixed_body<false, OutT>(qx, nullptr, srow, xo, qw, scol, fpw, out, M, K, N,
                          ko, silu);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
mixed_epilogue_kernel(const int* acc, const float* srow,
                      const __nv_bfloat16* xo, const float* scol,
                      const __nv_bfloat16* fpw, OutT* out, int M, int N,
                      int ko, int silu) {
  mixed_body<true, OutT>(nullptr, acc, srow, xo, nullptr, scol, fpw, out, M,
                         0, N, ko, silu);
}

}  // namespace mixq

using namespace mixq;

extern "C" const char* mixq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K2. q_x (M, K) int8, scale_row (M,) f32, x_out (M, ko) bf16, qweight
// (K, N) int8, scale_col (N,) f32, fp_weight (ko, N) bf16 -> out (M, N).
extern "C" int mixq_mixed_matmul(const void* qx, const void* srow,
                                 const void* xo, const void* qw,
                                 const void* scol, const void* fpw, void* out,
                                 int M, int K, int N, int ko, int silu,
                                 int out_dtype, void* stream) {
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM), block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* q = static_cast<const int8_t*>(qx);
  auto* sr = static_cast<const float*>(srow);
  auto* x = static_cast<const __nv_bfloat16*>(xo);
  auto* w = static_cast<const int8_t*>(qw);
  auto* sc = static_cast<const float*>(scol);
  auto* f = static_cast<const __nv_bfloat16*>(fpw);
  if (out_dtype == kBF16)
    mixed_matmul_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        q, sr, x, w, sc, f, static_cast<__nv_bfloat16*>(out), M, K, N, ko,
        silu);
  else if (out_dtype == kF32)
    mixed_matmul_kernel<float><<<grid, block, 0, st>>>(
        q, sr, x, w, sc, f, static_cast<float*>(out), M, K, N, ko, silu);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K3. acc (M, N) int32 and the rest as K2, without q_x and qweight.
extern "C" int mixq_mixed_epilogue(const void* acc, const void* srow,
                                   const void* xo, const void* scol,
                                   const void* fpw, void* out, int M, int N,
                                   int ko, int silu, int out_dtype,
                                   void* stream) {
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM), block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<const int*>(acc);
  auto* sr = static_cast<const float*>(srow);
  auto* x = static_cast<const __nv_bfloat16*>(xo);
  auto* sc = static_cast<const float*>(scol);
  auto* f = static_cast<const __nv_bfloat16*>(fpw);
  if (out_dtype == kBF16)
    mixed_epilogue_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        a, sr, x, sc, f, static_cast<__nv_bfloat16*>(out), M, N, ko, silu);
  else if (out_dtype == kF32)
    mixed_epilogue_kernel<float><<<grid, block, 0, st>>>(
        a, sr, x, sc, f, static_cast<float*>(out), M, N, ko, silu);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
