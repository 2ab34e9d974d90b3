// K14: causal flash attention for the dense prefill, bf16 in and out.
//
// Replaces the stock Pallas TPU flash_attention that
// mixq_tensorrt_llm_tpu/ops/attention.py:58-73 (causal_self_attention, MHA
// without a window) calls: _flash_attention_kernel of
// jax/experimental/pallas/ops/tpu/flash_attention.py. The function is the
// same: f32 q·kᵀ of the bf16 inputs, times `scale`, the causal mask (key <=
// row) as the stock kernel's additive -0.7·FLT_MAX, an online softmax in
// f32, p cast to bf16 before p·v (f32 accumulators), the output rounded to
// bf16 once. The softmax runs in base 2 (exp2f, log2(e) folded into the
// scale): the same function up to the last bits of each exponential.
//
// Layout: q, k, v and out are (B, S, H, D) bf16, read and written through
// their batch, sequence and head strides (D contiguous), so the model's
// q/k/v views go in as they are; JAX transposes to (B, H, S, D) and back.
//
// Bound on the H100: q, k and v read once and out written once is
// 8·B·S·H·D bytes against 2·B·H·D·S(S+1) causal FLOP (two products), about
// S/4 FLOP a byte: at the dense prefill's buckets up to ~1024 tokens the
// bytes bound it (3.35 TB/s), above that the bf16 tensor cores (989
// TFLOP/s). The design is FlashAttention-3's shape for sm_90a: no thread
// spends instructions on a copy or a scalar shared-memory load.
//
// - one block per 128 query rows, head and batch: two consumer warpgroups
//   own 64 rows each, one thread of a producer warpgroup issues every copy
//   by TMA; setmaxnreg moves the producer's registers to the consumers
//   (240 a thread: the 64 x 256 f32 output at D = 256 does not spill). A
//   persistent grid with a static schedule measured slower: causal tiles
//   differ in work, and the block scheduler balances them (PERF.md);
// - Q is loaded once; K and V tiles (kBK keys: 128, or 64 at D = 256 for
//   registers) go into a ring of kStages stages with full and empty
//   mbarriers, so the next tile's copy overlaps this tile's math. The
//   tensor maps are 4-D over the (B, S, H, D) strided views, boxes of 64
//   columns (one 128-byte swizzle row); TMA's out-of-bounds fill gives the
//   zero rows past S;
// - S = Q·Kᵀ is wgmma m64n{kBK}k16 with both operands in shared memory
//   (K-major, 128-byte swizzle); P stays in registers, cast to bf16, as the
//   register A operand of wgmma m64n{D}k16, and V is its shared-memory B
//   operand, MN-major through the descriptor's transpose bit; O stays in
//   f32 registers;
// - only tiles at or below the diagonal are visited, the mask applied only
//   on tiles that cross it; the q tiles with the most keys launch first.
//
// cuTensorMapEncodeTiled comes through cudaGetDriverEntryPoint, so the
// library needs no -lcuda. Any S >= 1; rows past S are not written.

#include <float.h>
#include <math.h>

#include "hopper.cuh"

namespace mixq {
namespace {

constexpr int kBlockQ = 128;                    // 2 warpgroups x 64 rows
constexpr int kConsumers = 256;
constexpr int kFlashThreads = kConsumers + 128; // + the producer warpgroup
// registers a thread after setmaxnreg: 2 x 128 x 240 + 128 x 24 <= 64 K
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr int kStages = 2;
constexpr int kBoxCols = 64;                    // 64 bf16 = 128 bytes
constexpr int kRowBytes = kBoxCols * 2;
constexpr float kMaskValue = -0.7f * FLT_MAX;   // the stock kernel's
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct FlashCfg {
  static constexpr int kBK = D > 128 ? 64 : 128;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kQBytes = kBlockQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;  // one K (or V) tile
  // + 1024: the swizzled tiles start on a 1024-byte boundary
  static constexpr size_t kSmem =
      static_cast<size_t>(kQBytes) + 2 * kStages * kKVBytes + 1024;
  static_assert(kSmem <= 232448, "over the 227 KB of shared memory");
};

template <int BK>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (BK == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}
template <int D>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (D == 128) wgmma_rs_n128<1>(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

struct Strides {
  long long b, s, h;
};

// Accumulator layout of wgmma m64nN (per thread of a warpgroup; w = warp in
// the warpgroup, g = lane / 4, t = lane % 4): element 4j + e is row w·16 +
// g + 8·(e >> 1), column 8j + 2t + (e & 1). The register A operand of
// m64k16 has the mma.sync fragment layout, so two 8-column blocks of the
// logits are one 16-key step of p·v as they stand.
template <int D>
__global__ void __launch_bounds__(kFlashThreads, 1)
    flash_causal_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        __nv_bfloat16* __restrict__ out, int S, Strides ost,
                        float scale_log2) {
  using Cfg = FlashCfg<D>;
  constexpr int BK = Cfg::kBK;
  constexpr int NS = BK / 2;       // logits registers a thread
  constexpr int NO = D / 2;        // output registers a thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;
  unsigned char* ks = qs + Cfg::kQBytes;          // stage s: + s·kKVBytes
  unsigned char* vs = ks + kStages * Cfg::kKVBytes;
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int qt = static_cast<int>(gridDim.x) - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBlockQ;
  // keys 0 .. min(S, q0 + 128) - 1: the diagonal tile is the last
  const int n_kt = (min(S, q0 + kBlockQ) + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);   // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {                     // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      mbar_expect_tx(q_full, Cfg::kQBytes);
      for (int bx = 0; bx < Cfg::kBoxes; ++bx)
        tma_load_4d(qs + bx * kBlockQ * kRowBytes, &qmap, q_full,
                    bx * kBoxCols, h, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * Cfg::kKVBytes);
        for (int bx = 0; bx < Cfg::kBoxes; ++bx) {
          const int off = s * Cfg::kKVBytes + bx * BK * kRowBytes;
          tma_load_4d(ks + off, &kmap, &full[s], bx * kBoxCols, h, j * BK, b);
          tma_load_4d(vs + off, &vmap, &full[s], bx * kBoxCols, h, j * BK, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warp_row = q0 + wg * 64 + warp * 16;    // the warp's first row
  const int row_lo = warp_row + g, row_hi = row_lo + 8;
  const int wg_last = q0 + wg * 64 + 63;
  const uint32_t q_addr = smem_u32(qs) + wg * 64 * kRowBytes;

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  mbar_wait(q_full, 0);

  for (int j = 0; j < n_kt; ++j) {
    const int s = j % kStages;
    const int k0 = j * BK;
    mbar_wait(&full[s], (j / kStages) & 1);
    if (k0 > wg_last) {                        // above all 64 rows
      if (lane == 0) mbar_arrive(&empty[s]);
      continue;
    }

    // logits = q · kᵀ: 64 rows x BK keys, both operands in shared memory
    float sc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    const uint32_t k_addr = smem_u32(ks + s * Cfg::kKVBytes);
    fence_regs<NS>(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;       // bytes into the box row
      wgmma_ss<BK>(sc,
                   sw128_desc(q_addr + (kk / 4) * kBlockQ * kRowBytes + col,
                              16, 1024),
                   sw128_desc(k_addr + (kk / 4) * BK * kRowBytes + col, 16,
                              1024),
                   kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs<NS>(sc);

    // scale (base 2), the causal mask on tiles that cross the diagonal,
    // row max over the 4 threads of a row
    const bool diag = k0 + BK - 1 > warp_row;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int jn = 0; jn < BK / 8; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * jn + e] * scale_log2;
        const int key = k0 + jn * 8 + 2 * t + (e & 1);
        if (diag && key > (e < 2 ? row_lo : row_hi)) x = kMaskValue;
        sc[4 * jn + e] = x;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * jn], sc[4 * jn + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * jn + 2], sc[4 * jn + 3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFullMask, mx_lo, o_));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFullMask, mx_hi, o_));
    }
    // key 0 is in tile 0 and below every row, so m is finite from tile 0
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float al_lo = exp2f(m_lo - mn_lo), al_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int jn = 0; jn < BK / 8; ++jn) {
      sc[4 * jn] = exp2f(sc[4 * jn] - mn_lo);
      sc[4 * jn + 1] = exp2f(sc[4 * jn + 1] - mn_lo);
      sc[4 * jn + 2] = exp2f(sc[4 * jn + 2] - mn_hi);
      sc[4 * jn + 3] = exp2f(sc[4 * jn + 3] - mn_hi);
      sum_lo += sc[4 * jn] + sc[4 * jn + 1];
      sum_hi += sc[4 * jn + 2] + sc[4 * jn + 3];
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      sum_lo += __shfl_xor_sync(kFullMask, sum_lo, o_);
      sum_hi += __shfl_xor_sync(kFullMask, sum_hi, o_);
    }
    l_lo = al_lo * l_lo + sum_lo;
    l_hi = al_hi * l_hi + sum_hi;
#pragma unroll
    for (int i = 0; i < NO; i += 4) {
      o[i] *= al_lo;
      o[i + 1] *= al_lo;
      o[i + 2] *= al_hi;
      o[i + 3] *= al_hi;
    }
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_f32(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_f32(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_f32(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_f32(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // o += bf16(p) · v: v (keys x D, D contiguous) as an MN-major B
    const uint32_t v_addr = smem_u32(vs + s * Cfg::kKVBytes);
    fence_regs<NO>(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(o, pa[kk],
                  sw128_desc(v_addr + kk * 16 * kRowBytes, BK * kRowBytes,
                             1024));
    wg_commit();
    wg_wait_all();
    fence_regs<NO>(o);
    if (lane == 0) mbar_arrive(&empty[s]);     // this warp is done with s
  }

  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  __nv_bfloat16* ob = out + b * ost.b + h * ost.h;
#pragma unroll
  for (int jn = 0; jn < D / 8; ++jn) {
    const int col = jn * 8 + 2 * t;
    if (row_lo < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_lo * ost.s + col) =
          __floats2bfloat162_rn(o[4 * jn] * inv_lo, o[4 * jn + 1] * inv_lo);
    if (row_hi < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_hi * ost.s + col) =
          __floats2bfloat162_rn(o[4 * jn + 2] * inv_hi,
                                o[4 * jn + 3] * inv_hi);
  }
}

// a (B, S, H, D) bf16 view as a 4-D tensor map (D, H, S, B), boxes of 64
// columns x `rows` rows of one head, 128-byte swizzle, zeros out of bounds
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
             Strides st, int rows) {
  const PFN_cuTensorMapEncodeTiled encode = tensor_map_encoder();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int H, Strides qst, Strides kst, Strides vst,
                 Strides ost, float scale, cudaStream_t st) {
  using Cfg = FlashCfg<D>;
  CUtensorMap qmap, kmap, vmap;
  int e = make_map(&qmap, q, B, S, H, D, qst, kBlockQ);
  if (!e) e = make_map(&kmap, k, B, S, H, D, kst, Cfg::kBK);
  if (!e) e = make_map(&vmap, v, B, S, H, D, vst, Cfg::kBK);
  if (e) return e;
  const cudaError_t a = cudaFuncSetAttribute(
      flash_causal_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Cfg::kSmem));
  if (a != cudaSuccess) return static_cast<int>(a);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_causal_kernel<D><<<grid, kFlashThreads, Cfg::kSmem, st>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), S, ost,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mixq

using namespace mixq;

extern "C" const char* mixq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, out (B, S, H, D) bf16 with element strides (batch, seq, head)
// each, head_dim contiguous; pointers 16-byte aligned and strides positive
// multiples of 8 (the wrapper checks). D is 64, 128 or 256.
extern "C" int mixq_flash_causal_attention(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float scale, void* stream) {
  const Strides qst{q_sb, q_ss, q_sh}, kst{k_sb, k_ss, k_sh},
      vst{v_sb, v_ss, v_sh}, ost{o_sb, o_ss, o_sh};
  const auto st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64:
      return launch_flash<64>(q, k, v, out, B, S, H, qst, kst, vst, ost,
                              scale, st);
    case 128:
      return launch_flash<128>(q, k, v, out, B, S, H, qst, kst, vst, ost,
                               scale, st);
    case 256:
      return launch_flash<256>(q, k, v, out, B, S, H, qst, kst, vst, ost,
                               scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
