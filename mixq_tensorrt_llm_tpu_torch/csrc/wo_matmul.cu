// K4: weight-only W8A16 GEMM, out = (bf16 x @ int8 W) * scale_col, f32 sums.
//
// Replaces mixq_tensorrt_llm_tpu/ops/wo_matmul.py _wo_kernel (wo_matmul).
// The weight stays in the JAX package's (K, N) int8 layout, read in place
// at 1 byte per weight and converted in registers or shared memory: no
// dequantized copy of it ever exists in device memory. Two regimes, chosen
// by M in one entry point:
//
//   wo_gemv_kernel  (M <= 16, decode). Bound by bytes: every weight byte is
//     read once for 2*M flops. A block owns 32 columns (so N = 4096 gives
//     128 blocks for 132 SMs) and walks all of K; each thread reads 8
//     consecutive weights of a row (4 threads cover a row's 32-byte
//     sector) and keeps M x 8 f32 sums. x is staged, transposed to f32, in
//     shared memory one K-chunk at a time, and the chunk's weight loads are
//     issued before the staging so the two latencies overlap. The 64 rows
//     a sweep covers are summed by a fixed butterfly of warp shuffles and a
//     fixed-order pass over the 8 warps: deterministic, no float atomics.
//
//   wo_gemm_kernel  (M > 16, prefill). Bound by operations at M ~ 1024.
//     128 x 128 output tiles, 8 warps of 32 x 64, bf16 tensor-core wmma
//     (16x16x16, f32 accumulate). Each 32-deep K step stages the x tile and
//     the int8 W tile converted to bf16 (exact: |w| <= 127) in shared
//     memory; the next step's global loads are held in registers while the
//     current step multiplies. scale_col multiplies in the epilogue.
//
// Products of a bf16 value and an int8 value are exact in f32, so both
// regimes differ from the plain version (an f32-accumulated bf16 product)
// only in the order of the sums.
//
// K12 / K13: packed-int4 weight-only GEMM (packed_gemv_kernel below).
// Replaces ops/wo_matmul.py _wo_packed_kernel (wo_matmul_packed, K12) and
// _wo_packed_grouped_kernel (wo_matmul_packed_grouped, K13). The weight is
// quant.core.pack_int4's K-half layout, int8 (K/2, N): byte (kp, n) holds
// row kp in its low nibble and row kp + K/2 in its high nibble, so the low
// nibbles dot x[:, :K/2] and the high ones x[:, K/2:]. It is read in place
// at 0.5 byte per weight and split into sign-extended nibbles in
// registers: no unpacked copy exists in device memory. Bound by bytes in
// decode (0.5 byte per 2*M flops). One block owns 32 columns and walks all
// K/2 packed rows; a thread reads 4 bytes (4 columns) of 8 consecutive
// packed rows per 256-row chunk, while the chunk's two halves of x are
// staged, transposed to f32, in shared memory. K13 multiplies each
// thread's f32 partial sum over its 8 rows (which lie in one group:
// group_size % 8 == 0) by the group's scale before adding it in; the
// weights are never scaled. Up to 16 rows of x per block; larger M runs
// 16-row slabs as blockIdx.x, so the slabs of one column block are
// scheduled together and share its weight reads in L2. Sums across
// threads: a fixed shuffle butterfly, then the 8 warps in order.

#include <mma.h>

#include "common.cuh"

namespace mixq {

using namespace nvcuda;

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

__device__ __forceinline__ float s8_at(uint32_t word, int j) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * j)) & 0xffu));
}

// ---------------------------------------------------------------------------
// small M: GEMV
// ---------------------------------------------------------------------------
constexpr int kGemvThreads = 256;
constexpr int kGemvCols = 32;                          // columns per block
constexpr int kGemvTPR = kGemvCols / 8;                // threads per row
constexpr int kGemvRPS = kGemvThreads / kGemvTPR;      // rows per sweep: 64
constexpr int kGemvUnroll = 8;                         // loads in flight
constexpr int kGemvChunk = kGemvRPS * kGemvUnroll;     // 512 rows of K
constexpr int kGemvWarps = kGemvThreads / 32;

template <int MT, typename OutT>
__global__ void __launch_bounds__(kGemvThreads)
wo_gemv_kernel(const __nv_bfloat16* __restrict__ x,
               const int8_t* __restrict__ w, const float* __restrict__ scol,
               OutT* __restrict__ out, int M, int K, int N) {
  // x chunk transposed (row stride MT + 1 keeps the 8 rows a warp reads in
  // distinct banks); reused for the cross-warp sums at the end
  __shared__ float smem[kGemvChunk * (MT + 1)];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rt = tid / kGemvTPR, ct = tid % kGemvTPR;
  const int n0 = blockIdx.x * kGemvCols;
  const int8_t* wcol = w + n0 + ct * 8;

  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[m][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kGemvChunk) {
    uint2 wv[kGemvUnroll];
#pragma unroll
    for (int u = 0; u < kGemvUnroll; ++u) {
      const int k = k0 + rt + u * kGemvRPS;
      wv[u] = k < K ? *reinterpret_cast<const uint2*>(
                          wcol + static_cast<size_t>(k) * N)
                    : make_uint2(0u, 0u);
    }
    for (int i = tid; i < kGemvChunk * MT; i += kGemvThreads) {
      const int m = i / kGemvChunk, r = i % kGemvChunk, k = k0 + r;
      smem[r * (MT + 1) + m] =
          (m < M && k < K)
              ? __bfloat162float(x[static_cast<size_t>(m) * K + k])
              : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kGemvUnroll; ++u) {
      const float* xr = smem + (rt + u * kGemvRPS) * (MT + 1);
      float wf[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wf[j] = s8_at(wv[u].x, j);
        wf[4 + j] = s8_at(wv[u].y, j);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xm = xr[m];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[m][c] = fmaf(xm, wf[c], acc[m][c]);
      }
    }
    __syncthreads();
  }

  // the 8 row groups of a warp (lane bits 2..4), then the 8 warps in order
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(kFullMask, v, 4);
      v += __shfl_xor_sync(kFullMask, v, 8);
      v += __shfl_xor_sync(kFullMask, v, 16);
      acc[m][c] = v;
    }
  float* red = smem;                       // [warp][m][col]
  if (lane < kGemvTPR) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        red[(warp * MT + m) * kGemvCols + ct * 8 + c] = acc[m][c];
  }
  __syncthreads();
  for (int i = tid; i < MT * kGemvCols; i += kGemvThreads) {
    const int m = i / kGemvCols, c = i % kGemvCols;
    if (m >= M) continue;
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < kGemvWarps; ++v) s += red[(v * MT + m) * kGemvCols + c];
    store_f(out + static_cast<size_t>(m) * N + n0 + c, s * scol[n0 + c]);
  }
}

// ---------------------------------------------------------------------------
// large M: bf16 tensor-core GEMM over int8 tiles converted in shared memory
// ---------------------------------------------------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kGemmThreads = 256;
constexpr int kLdA = kBK + 8;      // bf16 elements; rows stay 16-byte aligned
constexpr int kLdB = kBN + 8;

template <typename OutT>
__global__ void __launch_bounds__(kGemmThreads)
wo_gemm_kernel(const __nv_bfloat16* __restrict__ x,
               const int8_t* __restrict__ w, const float* __restrict__ scol,
               OutT* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(128) __nv_bfloat16 As[kBM * kLdA];
  __shared__ __align__(128) __nv_bfloat16 Bs[kBK * kLdB];
  __shared__ __align__(128) float Cs[kGemmThreads / 32][16 * 16];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;        // 4 x 2 warps of 32 x 64
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // per step: A is 128 x 32 bf16 (2 uint4 a thread), B 32 x 128 int8 (1)
  uint4 ra[2], rb;
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kGemmThreads, r = idx >> 2, c = (idx & 3) * 8;
      ra[i] = m0 + r < M ? *reinterpret_cast<const uint4*>(
                               x + static_cast<size_t>(m0 + r) * K + k0 + c)
                         : make_uint4(0u, 0u, 0u, 0u);
    }
    const int r = tid >> 3, c = (tid & 7) * 16;
    rb = *reinterpret_cast<const uint4*>(
        w + static_cast<size_t>(k0 + r) * N + n0 + c);
  };

  const int steps = K / kBK;
  load(0);
  for (int s = 0; s < steps; ++s) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kGemmThreads, r = idx >> 2, c = (idx & 3) * 8;
      *reinterpret_cast<uint4*>(As + r * kLdA + c) = ra[i];
    }
    {
      const int r = tid >> 3, c = (tid & 7) * 16;
      const uint32_t words[4] = {rb.x, rb.y, rb.z, rb.w};
      __align__(16) __nv_bfloat16 b[16];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[q * 4 + j] = __float2bfloat16(s8_at(words[q], j));
      *reinterpret_cast<uint4*>(Bs + r * kLdB + c) =
          reinterpret_cast<const uint4*>(b)[0];
      *reinterpret_cast<uint4*>(Bs + r * kLdB + c + 8) =
          reinterpret_cast<const uint4*>(b)[1];
    }
    __syncthreads();
    if (s + 1 < steps) load((s + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * kLdA + kk,
                               kLdA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * kLdB + wn * 64 + j * 16, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  // epilogue, one 16 x 16 fragment at a time through the warp's scratch
  float* cs = Cs[warp];
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wm * 32 + i * 16 + r;
      const int col = n0 + wn * 64 + j * 16 + c0;
      if (row < M) {
        float v[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] = cs[r * 16 + c0 + t] * scol[col + t];
        store8(out + static_cast<size_t>(row) * N + col, v);
      }
      __syncwarp();
    }
}

// ---------------------------------------------------------------------------
// K12 / K13: packed int4 (K-half layout), per-channel or per-group scales
// ---------------------------------------------------------------------------
constexpr int kPkThreads = 256;
constexpr int kPkCols = 32;                       // columns per block
constexpr int kPkTPR = kPkCols / 4;               // threads per packed row
constexpr int kPkRowThreads = kPkThreads / kPkTPR;  // 32
constexpr int kPkRows = 8;                        // packed rows per thread
constexpr int kPkChunk = kPkRowThreads * kPkRows;   // 256 packed rows
constexpr int kPkWarps = kPkThreads / 32;
constexpr int kPkSlab = 16;                       // rows of x per block

// nibble j (0..7, low nibble of byte 0 first) of `word`, sign-extended
__device__ __forceinline__ float nib_lo(uint32_t word, int c) {
  return static_cast<float>(static_cast<int32_t>(word << (28 - 8 * c)) >> 28);
}
__device__ __forceinline__ float nib_hi(uint32_t word, int c) {
  return static_cast<float>(static_cast<int32_t>(word << (24 - 8 * c)) >> 28);
}

// x (M, K) bf16; w (K/2, N) packed int8; GROUPED: scale (K/gs, N) f32,
// else scale (N,) f32. Block (blockIdx.x: 16-row slab of x, blockIdx.y:
// 32 columns). The body of both kernels below.
template <int MT, bool GROUPED, typename OutT>
__device__ __forceinline__ void packed_gemv(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, OutT* __restrict__ out, int M, int K,
    int N, int gs) {
  // the chunk's low-half and high-half x rows, transposed; (MT + 1) keeps
  // the rows a warp reads in distinct banks. Reused for the final sums.
  __shared__ float xs[2 * kPkChunk * (MT + 1)];
  float* xlo = xs;
  float* xhi = xs + kPkChunk * (MT + 1);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rt = tid / kPkTPR, ct = tid % kPkTPR;
  const int m0 = blockIdx.x * kPkSlab, n0 = blockIdx.y * kPkCols;
  const int col = n0 + ct * 4;
  const int Kp = K / 2;
  const int8_t* wcol = w + col;
  const int nlo_groups = GROUPED ? Kp / gs : 0;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  for (int kp0 = 0; kp0 < Kp; kp0 += kPkChunk) {
    const int r0 = kp0 + rt * kPkRows;          // this thread's first row
    uint32_t wv[kPkRows];
#pragma unroll
    for (int u = 0; u < kPkRows; ++u)
      wv[u] = r0 + u < Kp ? *reinterpret_cast<const uint32_t*>(
                                wcol + static_cast<size_t>(r0 + u) * N)
                          : 0u;
    for (int i = tid; i < kPkChunk * MT; i += kPkThreads) {
      const int m = i / kPkChunk, r = i % kPkChunk, kp = kp0 + r;
      const bool in = m0 + m < M && kp < Kp;
      const __nv_bfloat16* xr = x + static_cast<size_t>(m0 + m) * K + kp;
      xlo[r * (MT + 1) + m] = in ? __bfloat162float(xr[0]) : 0.f;
      xhi[r * (MT + 1) + m] = in ? __bfloat162float(xr[Kp]) : 0.f;
    }
    __syncthreads();
    if constexpr (GROUPED) {
      // the thread's 8 rows lie in one group of each half: partial sums
      // over them, scaled by the group's scales, then accumulated
      float part[MT][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[m][c] = 0.f;
        const float* xb = half ? xhi : xlo;
#pragma unroll
        for (int u = 0; u < kPkRows; ++u) {
          const float* xr = xb + (rt * kPkRows + u) * (MT + 1);
          float wf[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            wf[c] = half ? nib_hi(wv[u], c) : nib_lo(wv[u], c);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xm = xr[m];
#pragma unroll
            for (int c = 0; c < 4; ++c)
              part[m][c] = fmaf(xm, wf[c], part[m][c]);
          }
        }
        if (r0 < Kp) {
          const int g = r0 / gs + (half ? nlo_groups : 0);
          const float4 s4 = *reinterpret_cast<const float4*>(
              scale + static_cast<size_t>(g) * N + col);
          const float sg[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[m][c] = fmaf(part[m][c], sg[c], acc[m][c]);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < kPkRows; ++u) {
        const float* xl = xlo + (rt * kPkRows + u) * (MT + 1);
        const float* xh = xhi + (rt * kPkRows + u) * (MT + 1);
        float lo[4], hi[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          lo[c] = nib_lo(wv[u], c);
          hi[c] = nib_hi(wv[u], c);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float a = xl[m], b = xh[m];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[m][c] = fmaf(b, hi[c], fmaf(a, lo[c], acc[m][c]));
        }
      }
    }
    __syncthreads();
  }

  // the 4 row threads of a warp (lane bits 3..4), then the 8 warps in order
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(kFullMask, v, 8);
      v += __shfl_xor_sync(kFullMask, v, 16);
      acc[m][c] = v;
    }
  float* red = xs;                         // [warp][m][col]
  if (lane < kPkTPR) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[(warp * MT + m) * kPkCols + ct * 4 + c] = acc[m][c];
  }
  __syncthreads();
  for (int i = tid; i < MT * kPkCols; i += kPkThreads) {
    const int m = i / kPkCols, c = i % kPkCols;
    if (m0 + m >= M) continue;
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < kPkWarps; ++v) s += red[(v * MT + m) * kPkCols + c];
    if constexpr (!GROUPED) s *= scale[n0 + c];
    store_f(out + static_cast<size_t>(m0 + m) * N + n0 + c, s);
  }
}

// K12 (per-channel scales) and K13 (group scales): two names, so a trace
// tells them apart
template <int MT, typename OutT>
__global__ void __launch_bounds__(kPkThreads)
packed_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ scale, OutT* __restrict__ out,
                   int M, int K, int N, int gs) {
  packed_gemv<MT, false, OutT>(x, w, scale, out, M, K, N, gs);
}

template <int MT, typename OutT>
__global__ void __launch_bounds__(kPkThreads)
packed_grouped_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                           const int8_t* __restrict__ w,
                           const float* __restrict__ scale,
                           OutT* __restrict__ out, int M, int K, int N,
                           int gs) {
  packed_gemv<MT, true, OutT>(x, w, scale, out, M, K, N, gs);
}

template <int MT, bool GROUPED, typename OutT>
void launch_packed_mt(dim3 grid, cudaStream_t st,
                      const __nv_bfloat16* x, const int8_t* w,
                      const float* scale, OutT* out, int M, int K, int N,
                      int gs) {
  if constexpr (GROUPED)
    packed_grouped_gemv_kernel<MT, OutT><<<grid, kPkThreads, 0, st>>>(
        x, w, scale, out, M, K, N, gs);
  else
    packed_gemv_kernel<MT, OutT><<<grid, kPkThreads, 0, st>>>(
        x, w, scale, out, M, K, N, gs);
}

template <bool GROUPED, typename OutT>
int launch_packed(const void* x, const void* w, const void* scale, void* out,
                  int M, int K, int N, int gs, cudaStream_t st) {
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* wp = static_cast<const int8_t*>(w);
  auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<OutT*>(out);
  const dim3 grid((M + kPkSlab - 1) / kPkSlab, N / kPkCols);
  if (M <= 1)
    launch_packed_mt<1, GROUPED>(grid, st, xp, wp, sp, op, M, K, N, gs);
  else if (M <= 2)
    launch_packed_mt<2, GROUPED>(grid, st, xp, wp, sp, op, M, K, N, gs);
  else if (M <= 4)
    launch_packed_mt<4, GROUPED>(grid, st, xp, wp, sp, op, M, K, N, gs);
  else if (M <= 8)
    launch_packed_mt<8, GROUPED>(grid, st, xp, wp, sp, op, M, K, N, gs);
  else
    launch_packed_mt<16, GROUPED>(grid, st, xp, wp, sp, op, M, K, N, gs);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch(const void* x, const void* w, const void* scol, void* out, int M,
           int K, int N, cudaStream_t st) {
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* wp = static_cast<const int8_t*>(w);
  auto* sp = static_cast<const float*>(scol);
  auto* op = static_cast<OutT*>(out);
  if (M <= 16) {
    const dim3 grid(N / kGemvCols), block(kGemvThreads);
    if (M <= 1)
      wo_gemv_kernel<1, OutT><<<grid, block, 0, st>>>(xp, wp, sp, op, M, K, N);
    else if (M <= 2)
      wo_gemv_kernel<2, OutT><<<grid, block, 0, st>>>(xp, wp, sp, op, M, K, N);
    else if (M <= 4)
      wo_gemv_kernel<4, OutT><<<grid, block, 0, st>>>(xp, wp, sp, op, M, K, N);
    else if (M <= 8)
      wo_gemv_kernel<8, OutT><<<grid, block, 0, st>>>(xp, wp, sp, op, M, K, N);
    else
      wo_gemv_kernel<16, OutT><<<grid, block, 0, st>>>(xp, wp, sp, op, M, K,
                                                        N);
  } else {
    const dim3 grid(N / kBN, (M + kBM - 1) / kBM), block(kGemmThreads);
    wo_gemm_kernel<OutT><<<grid, block, 0, st>>>(xp, wp, sp, op, M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mixq

using namespace mixq;

extern "C" const char* mixq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (M, K) bf16, w (K, N) int8, scale_col (N,) f32 -> out (M, N) of
// out_dtype. The wrapper guarantees M >= 1, K % 32 == 0, N % 128 == 0 and
// 16-byte aligned x and w.
extern "C" int mixq_wo_matmul(const void* x, const void* w, const void* scol,
                              void* out, int M, int K, int N, int out_dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == kBF16)
    return launch<__nv_bfloat16>(x, w, scol, out, M, K, N, st);
  if (out_dtype == kF32) return launch<float>(x, w, scol, out, M, K, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K12: x (M, K) bf16, w (K/2, N) packed int4 (K-half layout), scale_col
// (N,) f32 -> out (M, N). K13 (group_size > 0): scale (K/group_size, N) f32
// group scales instead. The wrapper guarantees M >= 1, K % 2 == 0,
// N % 128 == 0, 16-byte aligned w and scale, and for K13
// group_size % 8 == 0 and (K/2) % group_size == 0.
extern "C" int mixq_wo_matmul_packed(const void* x, const void* w,
                                     const void* scale, void* out, int M,
                                     int K, int N, int group_size,
                                     int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool grouped = group_size > 0;
  if (out_dtype == kBF16)
    return grouped ? launch_packed<true, __nv_bfloat16>(x, w, scale, out, M,
                                                        K, N, group_size, st)
                   : launch_packed<false, __nv_bfloat16>(x, w, scale, out, M,
                                                         K, N, 0, st);
  if (out_dtype == kF32)
    return grouped ? launch_packed<true, float>(x, w, scale, out, M, K, N,
                                                group_size, st)
                   : launch_packed<false, float>(x, w, scale, out, M, K, N, 0,
                                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}
