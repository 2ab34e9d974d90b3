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
// ops against N*K weight bytes, 1,979 TOP/s), bytes at the speculative
// verify's 40 rows (the int8 and bf16 weights, 3.35 TB/s).
//
// K2, mixed_wgmma_kernel: int8 wgmma with TMA copies, the shape of K4's
// wo_wgmma_kernel (wo_matmul.cu).
//   - Operands swapped: out^T = qweight^T · q_x^T. wgmma takes 8-bit
//     operands from shared memory only K-major, and qweight (K, N) is
//     N-major (the checkpoint's one copy), so its tile is wgmma's register
//     operand A and q_x's tile (K-major, 128-byte swizzled by TMA) the
//     shared-memory operand B: x's rows are wgmma's n (NX = 16, 48 or 128
//     rows a block, from M), output columns its m.
//   - A block owns 256 columns: a producer warpgroup issues every TMA copy
//     into a 4-stage mbarrier ring of 128-deep k steps (two 128 x 128 int8
//     boxes of the weight and q_x's NX x 128 box), and two consumer
//     warpgroups of 128 columns each run m64nNXk32 s8 wgmmas into int32
//     sums (exact); setmaxnreg moves the producer's registers to them.
//   - Column relabelling as in K4: wgmma tau's row 16v + g + 8h is column
//     32v + 4g + 2·tau + h, so a thread's fragment rows are 4 neighbouring
//     columns, one 32-bit word of each k row of the box. A thread reads the
//     4 k rows 4t..4t+3 of its columns and transposes that 4 x 4 block of
//     bytes with byte permutes into the 4 columns' fragment words. Thread t
//     reads its rows in the order 4t + ((i + t) & 3), one byte rotation
//     undoing it after the transpose, so the 4 threads of a column group
//     hit 4 swizzle phases and a warp's reads 32 distinct banks.
//   - Each consumer converts the next stage's fragments while its wgmmas
//     on this one run (two sets of fragments).
//   - The outlier side GEMM runs after the int8 k steps in the same block,
//     on the same ring: its stages hold fp_weight's 64 channels x 256
//     columns and x_out's NX x 64, and bf16 m64nNXk16 wgmmas (fp_weight's
//     fragments built as the int8 ones, x_out the shared-memory operand)
//     accumulate onto y = float(acc) * srow * scol, in place. The side
//     sums are therefore added onto y in the tensor core's order rather
//     than summed first and added once as in JAX: the same function up to
//     f32 rounding (GEMM_TOL). Where there are no outliers the products
//     are zero and y passes through unchanged (the int32-exact case).
//   - Small M: where the row and column tiles leave SMs idle (40 rows:
//     48 column tiles at qkv), K is split across blocks of the same launch
//     (ops/mixed_matmul.py mixed_plan); every split writes its int32 sums,
//     and the last split of a tile to arrive (an atomic ticket) adds them
//     (integer sums: exact in any order), then runs the side GEMM and the
//     epilogue; the others drain the side stages their producer loaded.
//   - Epilogue in the JAX order with __fmul_rn/__fadd_rn (no FMA
//     contraction): acc·srow·scol, + side (above), SiLU, one cast, four
//     neighbouring columns of a row a store.
// TMA's zero fill serves ragged M, N (the last 256-column tile a quarter,
// half or three quarters full: a box wholly past N arrives as zeros and
// still counts its bytes) and K, and ko not a multiple of 64; the stores
// stop at N, four columns at a time.
//
// K3, mixed_epilogue_kernel (off every main path, kept as it was): 128 x
// 128 output tiles, 8 warps of 32 x 64; the side GEMM on bf16 wmma
// (16x16x16, 32 outlier channels a step, staged in shared memory), the
// int32 accumulator read from device memory, the same epilogue order.
//
// Shapes: K % 64 == 0, N % 64 == 0 (K3: N % 128 == 0) and ko % 8 == 0
// (checked by the wrapper); any M.

#include <mma.h>
#include <string.h>

#include "hopper.cuh"

namespace mixq {

// ---------------------------------------------------------------------------
// K2: int8 wgmma + TMA
// ---------------------------------------------------------------------------
constexpr int kMxCols = 128;                     // columns a consumer
constexpr int kMxBlockCols = 2 * kMxCols;        // columns a block
constexpr int kMxDepth = 128;                    // k a ring stage (bytes)
constexpr int kMxSideDepth = 64;                 // outlier channels a stage
constexpr int kMxStages = 4;
constexpr int kMxConsumers = 256;
constexpr int kMxThreads = kMxConsumers + 128;   // + the producer warpgroup
constexpr int kMxConsumerRegs = 240;             // 2 x 128 x 240 + 128 x 24
constexpr int kMxProducerRegs = 24;              //   <= 64 K registers
constexpr int kMxWBytes = kMxDepth * kMxCols;    // a consumer's int8 box
constexpr int kMxSideBox = kMxSideDepth * 64 * 2;  // fp_weight, 64 columns
// a side stage holds 4 fp_weight boxes where a main stage holds the two
// int8 ones, and x_out's box where q_x's is
static_assert(4 * kMxSideBox == 2 * kMxWBytes, "side stage layout");

template <int NX>
struct MixedCfg {
  static constexpr int kXBytes = NX * 128;       // q_x's (x_out's) box
  static constexpr int kStage = 2 * kMxWBytes + kXBytes;
  static constexpr int kAcc = NX / 2;            // sums a wgmma, a thread
  // + 1024: the swizzled boxes start on a 1024-byte boundary
  static constexpr size_t kSmem =
      static_cast<size_t>(kMxStages) * kStage + 1024;
  static_assert(kStage % 1024 == 0, "stages on 1024-byte boundaries");
  static_assert(kSmem <= 232448, "over the 227 KB of shared memory");
};

// the consumers' own barrier (the producer warpgroup has left)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kMxConsumers) : "memory");
}

// v[i]: 4 columns' bytes of k row 4t + ((i + t) & 3) -> f[b]: column b's
// bytes of k rows 4t..4t+3 in order (a 4 x 4 byte transpose, then the
// rotation `rot` of each word undoes the staggered row order)
__device__ __forceinline__ void columns_of_rows(const uint32_t v[4],
                                                uint32_t rot, uint32_t f[4]) {
  const uint32_t s0 = __byte_perm(v[0], v[1], 0x5140);
  const uint32_t s1 = __byte_perm(v[0], v[1], 0x7362);
  const uint32_t s2 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t s3 = __byte_perm(v[2], v[3], 0x7362);
  f[0] = __byte_perm(__byte_perm(s0, s2, 0x5410), 0, rot);
  f[1] = __byte_perm(__byte_perm(s0, s2, 0x7632), 0, rot);
  f[2] = __byte_perm(__byte_perm(s1, s3, 0x5410), 0, rot);
  f[3] = __byte_perm(__byte_perm(s1, s3, 0x7632), 0, rot);
}

// Block (blockIdx.x: NX rows of x, .y: 256 columns, .z: split of K). The
// accumulator element 4j + e of wgmma tau: column 32v + 4g + 2·tau +
// (e >> 1) of the consumer's 128, row of x 8j + 2t + (e & 1).
template <int NX, typename OutT>
__global__ void __launch_bounds__(kMxThreads, 1)
    mixed_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap omap,
                       const __grid_constant__ CUtensorMap fmap,
                       const float* __restrict__ srow,
                       const float* __restrict__ scol, OutT* __restrict__ out,
                       int* __restrict__ part, unsigned* __restrict__ tickets,
                       int M, int N, int n_k, int steps_per_split,
                       int n_side, int silu) {
  using Cfg = MixedCfg<NX>;
  constexpr int A = Cfg::kAcc;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kMxStages];
  __shared__ bool last_block;
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = bars;
  uint64_t* empty = bars + kMxStages;
  const int m0 = blockIdx.x * NX, n0 = blockIdx.y * kMxBlockCols;
  const int split = blockIdx.z, splits = gridDim.z;
  const int k_begin = split * steps_per_split;
  const int n_main = min(n_k, k_begin + steps_per_split) - k_begin;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kMxStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kMxConsumers / 32);  // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kMxConsumers) {                    // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kMxProducerRegs));
    if (tid == kMxConsumers) {
      for (int j = 0; j < n_main + n_side; ++j) {
        const int s = j % kMxStages;
        unsigned char* st = smem + s * Cfg::kStage;
        mbar_wait(&empty[s], ((j / kMxStages) & 1) ^ 1);
        // out-of-bounds rows, columns and k arrive as zeros, and count
        mbar_expect_tx(&full[s], Cfg::kStage);
        if (j < n_main) {
          const int k0 = (k_begin + j) * kMxDepth;
          tma_load_2d(st, &wmap, &full[s], n0, k0);
          tma_load_2d(st + kMxWBytes, &wmap, &full[s], n0 + kMxCols, k0);
          tma_load_2d(st + 2 * kMxWBytes, &xmap, &full[s], k0, m0);
        } else {                                // an outlier side stage
          const int c0 = (j - n_main) * kMxSideDepth;
          for (int b = 0; b < 4; ++b)
            tma_load_2d(st + b * kMxSideBox, &fmap, &full[s], n0 + 64 * b,
                        c0);
          tma_load_2d(st + 2 * kMxWBytes, &omap, &full[s], c0, m0);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kMxConsumerRegs));
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the 16-byte chunk of an int8 box row that holds this thread's columns
  // 32·warp + 4g .. + 3, before the swizzle, and the word in it
  const int chunk = 2 * warp + (g >> 2), word = 4 * (g & 3);
  uint32_t rot = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    rot |= static_cast<uint32_t>((r - t) & 3) << (4 * r);

  int acc[2][A];
#pragma unroll
  for (int tau = 0; tau < 2; ++tau)
#pragma unroll
    for (int i = 0; i < A; ++i) acc[tau][i] = 0;

  // Stage j's A fragments: each 32-deep k step's rows 4t..4t+3 (a0, a1)
  // and 16 + 4t.. (a2, a3) of the thread's 4 columns, through the 128-byte
  // swizzle (chunk ^ row % 8).
  using Frags = uint32_t[kMxDepth / 32][2][4];
  auto convert = [&](int j, Frags& a) {
    const int s = j % kMxStages;
    mbar_wait(&full[s], (j / kMxStages) & 1);
    const unsigned char* wt = smem + s * Cfg::kStage + wg * kMxWBytes;
#pragma unroll
    for (int kk = 0; kk < kMxDepth / 32; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t v[4], f[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = kk * 32 + 16 * half + 4 * t + ((i + t) & 3);
          v[i] = ld32(wt + r * 128 + ((chunk ^ (r & 7)) << 4) + word);
        }
        columns_of_rows(v, rot, f);
#pragma unroll
        for (int tau = 0; tau < 2; ++tau) {
          a[kk][tau][2 * half] = f[2 * tau];
          a[kk][tau][2 * half + 1] = f[2 * tau + 1];
        }
      }
  };
  // Stage j multiplies with `cur` while stage j + 1 converts into `nxt`
  // (a wgmma reads its registers asynchronously).
  auto step = [&](int j, Frags& cur, Frags& nxt) {
    const int s = j % kMxStages;
    const uint32_t x_addr = smem_u32(smem + s * Cfg::kStage + 2 * kMxWBytes);
#pragma unroll
    for (int tau = 0; tau < 2; ++tau) fence_regs<A>(acc[tau]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kMxDepth / 32; ++kk)
#pragma unroll
      for (int tau = 0; tau < 2; ++tau)
        wgmma_s8_rs<NX>(acc[tau], cur[kk][tau],
                        sw128_desc(x_addr + kk * 32, 16, 1024));
    wg_commit();
    if (j + 1 < n_main) convert(j + 1, nxt);
    wg_wait_all();
#pragma unroll
    for (int tau = 0; tau < 2; ++tau) fence_regs<A>(acc[tau]);
    if (lane == 0) mbar_arrive(&empty[s]);      // this warp is done with s
  };
  {
    Frags a0, a1;
    convert(0, a0);
    for (int j = 0; j < n_main; j += 2) {
      step(j, a0, a1);
      if (j + 1 < n_main) step(j + 1, a1, a0);
    }
  }

  if (splits > 1) {
    // int32 partials, laid out [split][tile][int4 q][consumer thread]
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    const size_t tiles = static_cast<size_t>(gridDim.x) * gridDim.y;
    auto at = [&](int sp, int q) {
      return reinterpret_cast<int4*>(part) +
             ((sp * tiles + tile) * (NX / 4) + q) * kMxConsumers + tid;
    };
#pragma unroll
    for (int q = 0; q < NX / 4; ++q) {
      const int* a = &acc[q / (A / 4)][4 * (q % (A / 4))];
      *at(split, q) = make_int4(a[0], a[1], a[2], a[3]);
    }
    __threadfence();
    consumer_sync();
    if (tid == 0) last_block = atomicAdd(&tickets[tile], 1u) == splits - 1u;
    consumer_sync();
    if (!last_block) {
      // the producer loads the side stages whatever the ticket says: take
      // them off the ring before leaving
      for (int p = 0; p < n_side; ++p) {
        const int j = n_main + p;
        mbar_wait(&full[j % kMxStages], (j / kMxStages) & 1);
        if (lane == 0) mbar_arrive(&empty[j % kMxStages]);
      }
      return;
    }
    __threadfence();
    for (int sp = 0; sp < splits; ++sp) {        // exact in any order
      if (sp == split) continue;
#pragma unroll
      for (int q = 0; q < NX / 4; ++q) {
        const int4 v = __ldcg(at(sp, q));
        int* a = &acc[q / (A / 4)][4 * (q % (A / 4))];
        a[0] += v.x;
        a[1] += v.y;
        a[2] += v.z;
        a[3] += v.w;
      }
    }
    if (tid == 0) tickets[tile] = 0u;           // ready for the next launch
  }

  // y = acc * srow * scol, in place of the sums
  const int col = n0 + wg * kMxCols + 32 * warp + 4 * g;
  float sc[4] = {0.f, 0.f, 0.f, 0.f};
  if (col < N) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(scol + col));
    sc[0] = v.x;
    sc[1] = v.y;
    sc[2] = v.z;
    sc[3] = v.w;
  }
  float y[2][A];
#pragma unroll
  for (int j = 0; j < NX / 8; ++j)
#pragma unroll
    for (int odd = 0; odd < 2; ++odd) {
      const int row = m0 + 8 * j + 2 * t + odd;
      const float sr = row < M ? __ldg(srow + row) : 0.f;
#pragma unroll
      for (int tau = 0; tau < 2; ++tau)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * j + 2 * h + odd;
          y[tau][e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[tau][e]), sr),
                                sc[2 * tau + h]);
        }
    }

  // + x_out @ fp_weight onto y: fp_weight's fragments from the swizzled
  // 64-column box of this warp's columns, 8 bytes (4 columns) of k rows
  // 2t, 2t+1, 2t+8 and 2t+9 a k step
  const int box = 2 * wg + (warp >> 1);
  const int s_chunk = 4 * (warp & 1) + (g >> 1), s_off = 8 * (g & 1);
  for (int p = 0; p < n_side; ++p) {
    const int j = n_main + p, s = j % kMxStages;
    mbar_wait(&full[s], (j / kMxStages) & 1);
    const unsigned char* fb = smem + s * Cfg::kStage + box * kMxSideBox;
    const uint32_t o_addr = smem_u32(smem + s * Cfg::kStage + 2 * kMxWBytes);
    uint32_t sa[kMxSideDepth / 16][2][4];
#pragma unroll
    for (int kk = 0; kk < kMxSideDepth / 16; ++kk) {
      uint2 r[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kr = kk * 16 + 2 * t + (q & 1) + 8 * (q >> 1);
        r[q] = *reinterpret_cast<const uint2*>(
            fb + kr * 128 + ((s_chunk ^ (kr & 7)) << 4) + s_off);
      }
#pragma unroll
      for (int tau = 0; tau < 2; ++tau) {
        const uint32_t w0 = tau ? r[0].y : r[0].x, w1 = tau ? r[1].y : r[1].x;
        const uint32_t w8 = tau ? r[2].y : r[2].x, w9 = tau ? r[3].y : r[3].x;
        sa[kk][tau][0] = __byte_perm(w0, w1, 0x5410);
        sa[kk][tau][1] = __byte_perm(w0, w1, 0x7632);
        sa[kk][tau][2] = __byte_perm(w8, w9, 0x5410);
        sa[kk][tau][3] = __byte_perm(w8, w9, 0x7632);
      }
    }
#pragma unroll
    for (int tau = 0; tau < 2; ++tau) fence_regs<A>(y[tau]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kMxSideDepth / 16; ++kk)
#pragma unroll
      for (int tau = 0; tau < 2; ++tau) {
        const uint64_t db = sw128_desc(o_addr + kk * 32, 16, 1024);
        if constexpr (NX == 128)
          wgmma_rs_n128<0>(y[tau], sa[kk][tau], db);
        else
          wgmma_bf16_rs<NX>(y[tau], sa[kk][tau], db);
      }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int tau = 0; tau < 2; ++tau) fence_regs<A>(y[tau]);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  if (col >= N) return;
#pragma unroll
  for (int j = 0; j < NX / 8; ++j)
#pragma unroll
    for (int odd = 0; odd < 2; ++odd) {
      const int row = m0 + 8 * j + 2 * t + odd;
      if (row >= M) continue;
      float v[4] = {y[0][4 * j + odd], y[0][4 * j + 2 + odd],
                    y[1][4 * j + odd], y[1][4 * j + 2 + odd]};
      if (silu) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          v[c] = __fmul_rn(v[c],
                           __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v[c]))));
      }
      OutT* o = out + static_cast<size_t>(row) * N + col;
      if constexpr (std::is_same<OutT, float>::value)
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      else
        *reinterpret_cast<uint2*>(o) =
            make_uint2(pack_f32(v[0], v[1]), pack_f32(v[2], v[3]));
    }
}

template <int NX, typename OutT>
int launch_mixed(const void* qx, const void* srow, const void* xo,
                 const void* qw, const void* scol, const void* fpw,
                 void* out, void* part, void* tickets, int M, int K, int N,
                 int ko, int silu, int splits, int steps_per_split,
                 cudaStream_t st) {
  using Cfg = MixedCfg<NX>;
  const int n_k = (K + kMxDepth - 1) / kMxDepth;
  if (splits < 1 || steps_per_split < 1 ||
      static_cast<long long>(splits) * steps_per_split < n_k ||
      (splits - 1) * steps_per_split >= n_k ||
      (splits > 1 && (!part || !tickets)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap, omap, fmap;
  int e = make_map_2d(&xmap, qx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K,
                      kMxDepth, NX);
  if (!e)
    e = make_map_2d(&wmap, qw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N,
                    kMxCols, kMxDepth);
  if (ko > 0) {
    if (!e)
      e = make_map_2d(&omap, xo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, ko,
                      kMxSideDepth, NX);
    if (!e)
      e = make_map_2d(&fmap, fpw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ko, N,
                      64, kMxSideDepth);
  } else {                                      // no side stages read them
    memset(&omap, 0, sizeof(omap));
    memset(&fmap, 0, sizeof(fmap));
  }
  if (e) return e;
  const cudaError_t a = cudaFuncSetAttribute(
      mixed_wgmma_kernel<NX, OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cfg::kSmem));
  if (a != cudaSuccess) return static_cast<int>(a);
  const dim3 grid((M + NX - 1) / NX, (N + kMxBlockCols - 1) / kMxBlockCols,
                  splits);
  mixed_wgmma_kernel<NX, OutT><<<grid, kMxThreads, Cfg::kSmem, st>>>(
      xmap, wmap, omap, fmap, static_cast<const float*>(srow),
      static_cast<const float*>(scol), static_cast<OutT*>(out),
      static_cast<int*>(part), static_cast<unsigned*>(tickets), M, N, n_k,
      steps_per_split, (ko + kMxSideDepth - 1) / kMxSideDepth, silu);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K3: the epilogue over a given int32 accumulator
// ---------------------------------------------------------------------------
using namespace nvcuda;

constexpr int kBM = 128, kBN = 128, kSK = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLdS = kSK + 8;                        // side A, bf16 elements
constexpr int kLdW = kBN + 8;                        // side B
constexpr int kSideStage = (kBM * kLdS + kSK * kLdW) * 2;

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

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
mixed_epilogue_kernel(const int* __restrict__ acc_in,
                      const float* __restrict__ srow,
                      const __nv_bfloat16* __restrict__ xo,
                      const float* __restrict__ scol,
                      const __nv_bfloat16* __restrict__ fpw,
                      OutT* __restrict__ out, int M, int N, int ko,
                      int silu) {
  __shared__ __align__(128) unsigned char stage[kSideStage];
  __shared__ __align__(128) float scratch_f[kWarps][16 * 16];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;          // 4 x 2 warps of 32 x 64
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

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

  float* cf = scratch_f[warp];
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(cf, side[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wm * 32 + i * 16 + r;
      const int col = n0 + wn * 64 + j * 16 + c0;
      if (row < M) {
        const float sr = srow[row];
        float v[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int a = acc_in[static_cast<size_t>(row) * N + col + t];
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

}  // namespace mixq

using namespace mixq;

extern "C" const char* mixq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K2. q_x (M, K) int8, scale_row (M,) f32, x_out (M, ko) bf16, qweight
// (K, N) int8, scale_col (N,) f32, fp_weight (ko, N) bf16 -> out (M, N).
// nx (16, 48 or 128) rows of x a block; K cut into `splits` ranges of
// steps_per_split 128-deep k steps (ops/mixed_matmul.py mixed_plan); with
// splits > 1, part holds splits x ceil(M/nx) x ceil(N/256) x nx x 256
// int32 partials and tickets ceil(M/nx) x ceil(N/256) zeroed counters,
// which the kernel leaves zeroed. The wrapper guarantees M >= 1, K % 64 ==
// 0, N % 64 == 0, ko % 8 == 0 and 16-byte aligned operands.
extern "C" int mixq_mixed_matmul(const void* qx, const void* srow,
                                 const void* xo, const void* qw,
                                 const void* scol, const void* fpw, void* out,
                                 void* part, void* tickets, int M, int K,
                                 int N, int ko, int silu, int nx, int splits,
                                 int steps_per_split, int out_dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_out_type(out_dtype, [&](auto o) {
    using OutT = typename decltype(o)::type;
#define MIXQ_NX(V)                                                           \
  if (nx == V)                                                               \
    return launch_mixed<V, OutT>(qx, srow, xo, qw, scol, fpw, out, part,     \
                                 tickets, M, K, N, ko, silu, splits,         \
                                 steps_per_split, st);
    MIXQ_NX(16)
    MIXQ_NX(48)
    MIXQ_NX(128)
#undef MIXQ_NX
    return static_cast<int>(cudaErrorInvalidValue);
  });
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
