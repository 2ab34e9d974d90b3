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
// K12 / K13: packed-int4 weight-only GEMMs. The weight is quant.core.pack_int4's
// K-half layout, int8 (K/2, N): byte (kp, n) holds row kp in its low nibble
// and row kp + K/2 in its high nibble. It is read in place at 0.5 byte per
// weight: no unpacked copy exists in device memory. Bound by bytes in decode
// (0.5 byte per 2*M flops).
//
//   packed_mma_kernel (K12, per-channel scales; replaces ops/wo_matmul.py
//     _wo_packed_kernel). At M = 8 its 2·M flops a weight would take the
//     f32 CUDA cores longer than the bytes take, so two weight bytes are
//     two bf16x2 operands of a tensor-core mma (a byte permute, a mask and
//     a subtract each: no float convert); the weight and x stream through
//     a 4-stage ring of 16-byte cp.async copies (3 stages, 34 KB, in
//     flight a block; up to 4 blocks an SM), and K/2 is split across
//     blocks so that every 13B decode shape fills the 132 SMs twice over;
//     the splits' partials are summed in a fixed order by the last block
//     to arrive, in the same launch. A deeper ring (6, 8 stages) and TMA
//     tensor-map boxes in place of cp.async measured no faster on the
//     H100 (PERF.md).
//   packed_grouped_gemv_kernel (K13, per-group scales; replaces
//     _wo_packed_grouped_kernel): the earlier CUDA-core GEMV, unchanged.

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
// K12: packed int4 (K-half layout), per-channel scales, on the tensor cores
// ---------------------------------------------------------------------------
// Operands swapped, as the weight-only decode GEMMs of TensorRT-LLM and
// Marlin lay them out: the mma's 16 rows are output columns, its n = 8 are
// rows of x (two n-tiles at M <= 16). Its 16-deep k step covers 8 packed
// rows r0..r0+7: thread t's k pairs (2t, 2t+1) are the low nibbles of
// packed rows r0 + 2t and r0 + 2t + 1, its pairs (2t+8, 2t+9) their high
// nibbles. So an A register is one column's byte from each of two
// neighbouring rows (a byte permute, then a mask that puts two nibbles in
// two bf16 mantissas), and a B register is two neighbouring values of one
// half of x, one 32-bit read.
constexpr int kQmThreads = 256;                  // 8 warps
constexpr int kQmCols = 128;                     // output columns per block
constexpr int kQmChunk = 64;                     // packed rows per stage
constexpr int kQmStages = 4;                     // the ring of async copies
// bytes per staged weight row: 16 bytes of padding put a warp's 32-bit
// reads of rows 2t and 2t + 1 in 32 distinct banks
constexpr int kQmLdw = kQmCols + 16;
constexpr int kQmLdx = kQmChunk + 8;             // bf16 per staged x row
constexpr int kQmColGroups = kQmCols / 32;       // warps across the columns
constexpr int kQmKGroups = kQmThreads / 32 / kQmColGroups;  // and along K
constexpr int kQmSlab = 16;                      // rows of x per block

// One ring stage: 64 packed rows x 128 columns of the weight, and the two
// halves of x at those rows, x[m][kp] and x[m][kp + K/2], for MT rows.
template <int MT>
struct QmStage {
  static constexpr int kW = kQmChunk * kQmLdw;
  static constexpr int kX = MT * kQmLdx * 2;     // bytes of one half
  static constexpr int kBytes = kW + 2 * kX;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronous; zeros where !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The nibbles at bits 0-3 and 16-19 of `v` as bf16x2, each sign-extended:
// u = nibble ^ 8 in the mantissa of 128.0 (bf16 0x4300) is 128 + (s + 8)
// exactly, and subtracting 136 leaves s. Exact: |s| <= 8.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t v) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n"          // (a & b) ^ c
      : "=r"(r)
      : "r"(v), "n"(0x000F000F), "n"(0x43084308));
  __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&r);
  h = __hsub2(h, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d += a · b, m16n8k16, bf16 in, f32 accumulators (g = lane / 4, t = lane
// % 4): a[0] = A[g][2t..], a[1] = A[g+8][2t..], a[2] = A[g][2t+8..], a[3]
// = A[g+8][2t+8..]; b0 = B[2t..2t+1][g], b1 = B[2t+8..][g]; d[0..1] =
// D[g][2t..2t+1], d[2..3] = D[g+8][2t..].
__device__ __forceinline__ void mma_16816(float d[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block (blockIdx.x: 128 columns, .y: split of K/2, .z: 16-row slab of x).
// The split's chunks of 64 packed rows, with their slice of x, stream
// through a ring of kQmStages stages by 16-byte cp.async.cg copies. Warp
// (cg, kg) owns 32 columns and half of each chunk's rows. A thread's two
// 32-bit reads of a k step, rows 2t and 2t + 1 of columns 4g..4g+3, feed
// two mma tiles: tile tau's row g + 8h is column 4g + 2·tau + h of the
// warp's 32 (byte 2·tau + h of each word). Sums: the K groups of a block in
// order, then (splits > 1) the last block of a column tile to arrive, by an
// atomic ticket, adds the splits' f32 partials in split order: fixed
// order, one launch.
template <int MT, typename OutT>
__global__ void __launch_bounds__(kQmThreads)
packed_mma_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ w,
                  const float* __restrict__ scale, OutT* __restrict__ out,
                  float* __restrict__ part, unsigned* __restrict__ tickets,
                  int M, int K, int N, int chunks_per_split) {
  using Stage = QmStage<MT>;
  constexpr int NT = MT / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last_block;
  const int Kp = K / 2;
  const int n_chunks = (Kp + kQmChunk - 1) / kQmChunk;
  const int tile = blockIdx.x, split = blockIdx.y, slab = blockIdx.z;
  const int splits = gridDim.y;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);
  const int n0 = tile * kQmCols, m0 = slab * kQmSlab;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // 16-byte copies of x where K % 16 == 0 (then K/2 % 8 == 0 and a copy
  // is all in range or all out), else one value at a time
  const bool x_vec = K % 16 == 0;

  auto load_stage = [&](int c) {
    unsigned char* dst = smem + ((c - c_begin) % kQmStages) * Stage::kBytes;
    const int kp0 = c * kQmChunk;
    for (int i = tid; i < kQmChunk * (kQmCols / 16); i += kQmThreads) {
      const int r = i / (kQmCols / 16), v = i % (kQmCols / 16);
      const bool in = kp0 + r < Kp;
      const int8_t* src =
          w + static_cast<size_t>(in ? kp0 + r : 0) * N + n0 + v * 16;
      cp_async16(smem_u32(dst + r * kQmLdw + v * 16), src, in);
    }
    auto* xs = reinterpret_cast<__nv_bfloat16*>(dst + Stage::kW);
    if (x_vec) {
      for (int i = tid; i < 2 * MT * (kQmChunk / 8); i += kQmThreads) {
        const int half = i / (MT * (kQmChunk / 8));
        const int m = (i / (kQmChunk / 8)) % MT, j = (i % (kQmChunk / 8)) * 8;
        const bool in = m0 + m < M && kp0 + j < Kp;
        const __nv_bfloat16* src =
            in ? x + static_cast<size_t>(m0 + m) * K + half * Kp + kp0 + j : x;
        cp_async16(smem_u32(xs + (half * MT + m) * kQmLdx + j), src, in);
      }
    } else {
      for (int i = tid; i < 2 * MT * kQmChunk; i += kQmThreads) {
        const int half = i / (MT * kQmChunk);
        const int m = (i / kQmChunk) % MT, j = i % kQmChunk;
        const bool in = m0 + m < M && kp0 + j < Kp;
        xs[(half * MT + m) * kQmLdx + j] =
            in ? x[static_cast<size_t>(m0 + m) * K + half * Kp + kp0 + j]
               : __float2bfloat16(0.f);
      }
    }
  };
  for (int s = 0; s < kQmStages - 1; ++s) {
    if (c_begin + s < c_end) load_stage(c_begin + s);
    cp_async_commit();
  }

  const int cg = warp % kQmColGroups, kg = warp / kQmColGroups;
  float acc[2][NT][4];
#pragma unroll
  for (int tau = 0; tau < 2; ++tau)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tau][nt][e] = 0.f;

  for (int c = c_begin; c < c_end; ++c) {
    cp_async_wait<kQmStages - 2>();   // chunk c has landed
    __syncthreads();                  // ... for every thread; c - 1 is read
    if (c + kQmStages - 1 < c_end) load_stage(c + kQmStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + ((c - c_begin) % kQmStages) * Stage::kBytes;
    const unsigned char* ws = st + cg * 32 + 4 * g;
    const auto* xs = reinterpret_cast<const __nv_bfloat16*>(st + Stage::kW);
#pragma unroll
    for (int ks = 0; ks < kQmChunk / (8 * kQmKGroups); ++ks) {
      const int r0 = kg * (kQmChunk / kQmKGroups) + ks * 8;
      const uint32_t w0 =
          *reinterpret_cast<const uint32_t*>(ws + (r0 + 2 * t) * kQmLdw);
      const uint32_t w1 =
          *reinterpret_cast<const uint32_t*>(ws + (r0 + 2 * t + 1) * kQmLdw);
      uint32_t b[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* xr = xs + (nt * 8 + g) * kQmLdx + r0 + 2 * t;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(xr);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(xr + MT * kQmLdx);
      }
#pragma unroll
      for (int tau = 0; tau < 2; ++tau) {
        // byte 2·tau (row g) of w0 and w1 as bytes 0 and 2 of p0, byte
        // 2·tau + 1 (row g + 8) as those of p1
        const uint32_t p0 = __byte_perm(w0, w1, 0x4400 + 0x1111 * 2 * tau);
        const uint32_t p1 =
            __byte_perm(w0, w1, 0x4400 + 0x1111 * (2 * tau + 1));
        const uint32_t a[4] = {nibbles_bf16x2(p0), nibbles_bf16x2(p1),
                               nibbles_bf16x2(p0 >> 4),
                               nibbles_bf16x2(p1 >> 4)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_16816(acc[tau][nt], a, b[nt][0], b[nt][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                    // the ring is free: the K groups

  float* red = reinterpret_cast<float*>(smem);   // [kg][m][column]
#pragma unroll
  for (int tau = 0; tau < 2; ++tau)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cg * 32 + 4 * g + 2 * tau + (e >> 1);
        const int m = nt * 8 + 2 * t + (e & 1);
        red[(kg * MT + m) * kQmCols + col] = acc[tau][nt][e];
      }
  __syncthreads();
  float* mine = part + (static_cast<size_t>(split) * gridDim.z + slab) * MT * N;
  for (int i = tid; i < MT * kQmCols; i += kQmThreads) {
    const int m = i / kQmCols, col = i % kQmCols;
    float v = red[m * kQmCols + col];
#pragma unroll
    for (int q = 1; q < kQmKGroups; ++q) v += red[(q * MT + m) * kQmCols + col];
    if (splits == 1) {
      if (m0 + m < M)
        store_f(out + static_cast<size_t>(m0 + m) * N + n0 + col,
                v * scale[n0 + col]);
    } else {
      mine[static_cast<size_t>(m) * N + n0 + col] = v;
    }
  }
  if (splits == 1) return;

  // the last split of this column tile to arrive sums all, in split order
  __threadfence();
  __syncthreads();
  unsigned* ticket = tickets + static_cast<size_t>(slab) * gridDim.x + tile;
  if (tid == 0) last_block = atomicAdd(ticket, 1u) == splits - 1u;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const size_t split_stride = static_cast<size_t>(gridDim.z) * MT * N;
  const float* first = part + static_cast<size_t>(slab) * MT * N;
  for (int i = tid; i < MT * kQmCols; i += kQmThreads) {
    const int m = i / kQmCols, col = i % kQmCols;
    if (m0 + m >= M) continue;
    const float* p = first + static_cast<size_t>(m) * N + n0 + col;
    float v = __ldcg(p);
    for (int s = 1; s < splits; ++s) v += __ldcg(p + s * split_stride);
    store_f(out + static_cast<size_t>(m0 + m) * N + n0 + col,
            v * scale[n0 + col]);
  }
  if (tid == 0) *ticket = 0u;         // ready for the next launch
}

template <int MT, typename OutT>
int launch_packed_mma_mt(dim3 grid, size_t smem, cudaStream_t st,
                         const __nv_bfloat16* x, const int8_t* w,
                         const float* scale, OutT* out, float* part,
                         unsigned* tickets, int M, int K, int N, int cps) {
  cudaError_t e = cudaFuncSetAttribute(
      packed_mma_kernel<MT, OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  packed_mma_kernel<MT, OutT><<<grid, kQmThreads, smem, st>>>(
      x, w, scale, out, part, tickets, M, K, N, cps);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch_packed_mma(const void* x, const void* w, const void* scale,
                      void* out, void* part, void* tickets, int M, int K,
                      int N, int splits, int cps, cudaStream_t st) {
  const int n_chunks = (K / 2 + kQmChunk - 1) / kQmChunk;
  if (splits < 1 || cps < 1 || N % kQmCols ||
      static_cast<long long>(splits) * cps < n_chunks ||
      (splits - 1) * cps >= n_chunks || (splits > 1 && !part))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mt = M <= 8 ? 8 : 16;
  const size_t smem = static_cast<size_t>(kQmStages) *
                      (mt == 8 ? QmStage<8>::kBytes : QmStage<16>::kBytes);
  const dim3 grid(N / kQmCols, splits, (M + kQmSlab - 1) / kQmSlab);
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* wp = static_cast<const int8_t*>(w);
  auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<OutT*>(out);
  auto* pp = static_cast<float*>(part);
  auto* tp = static_cast<unsigned*>(tickets);
  if (mt == 8)
    return launch_packed_mma_mt<8>(grid, smem, st, xp, wp, sp, op, pp, tp, M,
                                   K, N, cps);
  return launch_packed_mma_mt<16>(grid, smem, st, xp, wp, sp, op, pp, tp, M,
                                  K, N, cps);
}

// ---------------------------------------------------------------------------
// K13: packed int4 (K-half layout), per-group scales
// ---------------------------------------------------------------------------
// One block owns 32 columns and walks all K/2 packed rows; a thread reads 4
// bytes (4 columns) of 8 consecutive packed rows per 256-row chunk, while
// the chunk's two halves of x are staged, transposed to f32, in shared
// memory; nibbles are split in registers. Each thread's f32 partial sum
// over its 8 rows (which lie in one group: group_size % 8 == 0) is
// multiplied by the group's scale before it is added in; the weights are
// never scaled. Up to 16 rows of x per block; larger M runs 16-row slabs as
// blockIdx.x. Sums across threads: a fixed shuffle butterfly, then the 8
// warps in order.
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

// x (M, K) bf16; w (K/2, N) packed int8; scale (K/gs, N) f32. Block
// (blockIdx.x: 16-row slab of x, blockIdx.y: 32 columns).
template <int MT, typename OutT>
__global__ void __launch_bounds__(kPkThreads)
packed_grouped_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                           const int8_t* __restrict__ w,
                           const float* __restrict__ scale,
                           OutT* __restrict__ out, int M, int K, int N,
                           int gs) {
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
  const int nlo_groups = Kp / gs;

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
    // the thread's 8 rows lie in one group of each half: partial sums over
    // them, scaled by the group's scales, then accumulated
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
    store_f(out + static_cast<size_t>(m0 + m) * N + n0 + c, s);
  }
}

template <typename OutT>
int launch_packed_grouped(const void* x, const void* w, const void* scale,
                          void* out, int M, int K, int N, int gs,
                          cudaStream_t st) {
  auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* wp = static_cast<const int8_t*>(w);
  auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<OutT*>(out);
  const dim3 grid((M + kPkSlab - 1) / kPkSlab, N / kPkCols);
  if (M <= 1)
    packed_grouped_gemv_kernel<1, OutT><<<grid, kPkThreads, 0, st>>>(
        xp, wp, sp, op, M, K, N, gs);
  else if (M <= 2)
    packed_grouped_gemv_kernel<2, OutT><<<grid, kPkThreads, 0, st>>>(
        xp, wp, sp, op, M, K, N, gs);
  else if (M <= 4)
    packed_grouped_gemv_kernel<4, OutT><<<grid, kPkThreads, 0, st>>>(
        xp, wp, sp, op, M, K, N, gs);
  else if (M <= 8)
    packed_grouped_gemv_kernel<8, OutT><<<grid, kPkThreads, 0, st>>>(
        xp, wp, sp, op, M, K, N, gs);
  else
    packed_grouped_gemv_kernel<16, OutT><<<grid, kPkThreads, 0, st>>>(
        xp, wp, sp, op, M, K, N, gs);
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
// (N,) f32 -> out (M, N). K/2 is cut into `splits` ranges of
// chunks_per_split chunks of 64 packed rows (ops/wo_matmul.py
// packed_plan); with splits > 1, part holds splits x ceil(M/16) x MT x N f32
// partials (MT = 8 for M <= 8, else 16) and tickets ceil(M/16) x N/128
// zeroed counters, which the kernel leaves zeroed. The wrapper guarantees
// M >= 1, K % 2 == 0, N % 128 == 0 and 16-byte aligned w.
extern "C" int mixq_wo_matmul_packed(const void* x, const void* w,
                                     const void* scale, void* out,
                                     void* part, void* tickets, int M, int K,
                                     int N, int splits, int chunks_per_split,
                                     int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == kBF16)
    return launch_packed_mma<__nv_bfloat16>(x, w, scale, out, part, tickets,
                                            M, K, N, splits,
                                            chunks_per_split, st);
  if (out_dtype == kF32)
    return launch_packed_mma<float>(x, w, scale, out, part, tickets, M, K, N,
                                    splits, chunks_per_split, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K13: x (M, K) bf16, w (K/2, N) packed int4 (K-half layout), scale
// (K/group_size, N) f32 group scales -> out (M, N). The wrapper guarantees
// M >= 1, K % 2 == 0, N % 128 == 0, 16-byte aligned w and scale,
// group_size % 8 == 0 and (K/2) % group_size == 0.
extern "C" int mixq_wo_matmul_packed_grouped(const void* x, const void* w,
                                             const void* scale, void* out,
                                             int M, int K, int N,
                                             int group_size, int out_dtype,
                                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group_size <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (out_dtype == kBF16)
    return launch_packed_grouped<__nv_bfloat16>(x, w, scale, out, M, K, N,
                                                group_size, st);
  if (out_dtype == kF32)
    return launch_packed_grouped<float>(x, w, scale, out, M, K, N,
                                        group_size, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
