// K14: causal flash attention for the dense prefill, bf16 in and out.
//
// Replaces the stock Pallas TPU flash_attention that
// mixq_tensorrt_llm_tpu/ops/attention.py:58-73 (causal_self_attention, MHA
// without a window) calls: _flash_attention_kernel of
// jax/experimental/pallas/ops/tpu/flash_attention.py. The function is the
// same: f32 q·kᵀ of the bf16 inputs, times `scale`, the causal mask (key <=
// row) as the stock kernel's additive -0.7·FLT_MAX, an online softmax in
// f32, p cast to bf16 before p·v (f32 accumulators), the output rounded to
// bf16 once.
//
// Layout: q, k, v and out are (B, S, H, D) bf16, read and written through
// their batch, sequence and head strides (D contiguous), so the model's
// q/k/v views go in as they are; JAX transposes to (B, H, S, D) and back.
//
// Bound on the H100: q, k and v read once and out written once is
// 8·B·S·H·D bytes against 2·B·H·D·S(S+1) causal FLOP (two products), about
// S/4 FLOP a byte: at the dense prefill's buckets up to ~1024 tokens the
// bytes bound it (3.35 TB/s), above that the bf16 tensor cores (989
// TFLOP/s). Design: both products run on the tensor cores
// (mma.sync.m16n8k16, bf16 in, f32 accumulators); the S x S logits never
// leave registers; each k/v tile is read from device memory once per q
// tile, and only the tiles at or below the diagonal are visited (the stock
// kernel's below_or_on_diag skip), the mask applied only on tiles that
// cross it.
//
// One block of 4 warps per (q tile of 64 rows, head, batch); each warp owns
// 16 query rows and keeps their logits tile, running (m, l) and 16 x D
// output accumulator in registers, in the mma fragment layouts (so a row's
// max and sum need two lane shuffles, and the logits fragments are p·v's A
// operand as they stand). K and V tiles of BK keys (64; 32 at D = 256, for
// registers) are staged in shared memory one tile at a time, rows padded
// by 8 bf16 so that the fragment loads of a warp hit distinct banks. No
// cp.async double-buffering and no wgmma/TMA yet: a later PR's work. The
// q tiles with the most keys launch first (blockIdx.x runs from the last q
// tile down). Any S >= 1: rows past S are read as zeros and not written.

#include <math.h>

#include "common.cuh"

namespace mixq {
namespace {

constexpr int kFlashThreads = 128;      // 4 warps x 16 query rows
constexpr int kBlockQ = 64;
constexpr int kPad = 8;                 // bf16 of padding per shared row
// the stock kernel's DEFAULT_MASK_VALUE, -0.7 * float32 max
constexpr float kMaskValue = -0.7f * 3.40282346638528859811704183484516925e38f;

template <int D>
struct FlashTile {
  static constexpr int kBlockK = D > 128 ? 32 : 64;
  static constexpr int kLd = D + kPad;
  static constexpr size_t kSmem =
      static_cast<size_t>(kBlockQ + 2 * kBlockK) * kLd * sizeof(__nv_bfloat16);
};

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a · b for a 16x16 bf16 A (row-major fragment), a 16x8 bf16 B
// (column-major fragment) and a 16x8 f32 C. Fragments (g = lane / 4,
// t = lane % 4): a[0] = A[g][2t..2t+1], a[1] = A[g+8][2t..], a[2] =
// A[g][2t+8..], a[3] = A[g+8][2t+8..]; b0 = B[2t..2t+1][g], b1 =
// B[2t+8..2t+9][g]; c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..].
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [row0, row0 + rows) of one (batch, head) slice into shared memory,
// 16 bytes a thread at a time; rows at or past S read as zeros
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int rows, int S) {
  constexpr int kVec = D / 8;
  for (int i = threadIdx.x; i < rows * kVec; i += kFlashThreads) {
    const int r = i / kVec, c = i % kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      v = *reinterpret_cast<const uint4*>(
          src + static_cast<long long>(row0 + r) * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * FlashTile<D>::kLd + c * 8) = v;
  }
}

struct Strides {
  long long b, s, h;
};

template <int D>
__global__ void __launch_bounds__(kFlashThreads)
    flash_causal_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out, int S, Strides qst,
                        Strides kst, Strides vst, Strides ost, float scale) {
  constexpr int BK = FlashTile<D>::kBlockK;
  constexpr int LD = FlashTile<D>::kLd;
  constexpr int NT = D / 8;    // 8-column tiles of the output
  constexpr int KT = BK / 8;   // 8-key tiles of the logits
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockQ * LD;
  __nv_bfloat16* vs = ks + BK * LD;

  const int qt = static_cast<int>(gridDim.x) - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kBlockQ;
  const int wrow = q0 + warp * 16;             // the warp's first row
  const int row_lo = wrow + g, row_hi = row_lo + 8;

  load_tile<D>(qs, q + b * qst.b + h * qst.h, qst.s, q0, kBlockQ, S);
  const __nv_bfloat16* kb = k + b * kst.b + h * kst.h;
  const __nv_bfloat16* vb = v + b * vst.b + h * vst.h;

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  // keys 0 .. min(S, q0 + 64) - 1: the diagonal tile is the last
  const int n_kt = (min(S, q0 + kBlockQ) + BK - 1) / BK;
  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * BK;
    __syncthreads();                         // the last tile's readers
    load_tile<D>(ks, kb, kst.s, k0, BK, S);
    load_tile<D>(vs, vb, vst.s, k0, BK, S);
    __syncthreads();
    if (k0 > wrow + 15) continue;            // above every row of the warp

    // logits = q · kᵀ for the warp's 16 rows x BK keys
    float s[KT][4];
#pragma unroll
    for (int n = 0; n < KT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* qr = qs + (warp * 16 + g) * LD + kk * 16 + 2 * t;
      const uint32_t a[4] = {ld32(qr), ld32(qr + 8 * LD), ld32(qr + 8),
                             ld32(qr + 8 * LD + 8)};
#pragma unroll
      for (int n = 0; n < KT; ++n) {
        const __nv_bfloat16* kr = ks + (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[n], a, ld32(kr), ld32(kr + 8));
      }
    }

    // scale, the causal mask on tiles that cross the diagonal, row max
    const bool diag = k0 + BK - 1 > wrow;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int n = 0; n < KT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        if (diag && key > (e < 2 ? row_lo : row_hi)) x = kMaskValue;
        s[n][e] = x;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFullMask, mx_lo, o_));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFullMask, mx_hi, o_));
    }
    // key 0 is in tile 0 and below every row, so m is finite from tile 0
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float al_lo = expf(m_lo - mn_lo), al_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < KT; ++n) {
      s[n][0] = expf(s[n][0] - mn_lo);
      s[n][1] = expf(s[n][1] - mn_lo);
      s[n][2] = expf(s[n][2] - mn_hi);
      s[n][3] = expf(s[n][3] - mn_hi);
      sum_lo += s[n][0] + s[n][1];
      sum_hi += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      sum_lo += __shfl_xor_sync(kFullMask, sum_lo, o_);
      sum_hi += __shfl_xor_sync(kFullMask, sum_hi, o_);
    }
    l_lo = al_lo * l_lo + sum_lo;
    l_hi = al_hi * l_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= al_lo;
      o[n][1] *= al_lo;
      o[n][2] *= al_hi;
      o[n][3] *= al_hi;
    }

    // o += bf16(p) · v: two 8-key logits tiles are one 16-key A fragment
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                             pack_f32(s[2 * kk][2], s[2 * kk][3]),
                             pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* vr = vs + (kk * 16 + 2 * t) * LD + n * 8 + g;
        mma_bf16(o[n], a, pack_bf16(vr[0], vr[LD]),
                 pack_bf16(vr[8 * LD], vr[9 * LD]));
      }
    }
  }

  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  __nv_bfloat16* ob = out + b * ost.b + h * ost.h;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    if (row_lo < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_lo * ost.s + col) =
          __floats2bfloat162_rn(o[n][0] * inv_lo, o[n][1] * inv_lo);
    if (row_hi < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row_hi * ost.s + col) =
          __floats2bfloat162_rn(o[n][2] * inv_hi, o[n][3] * inv_hi);
  }
}

template <int D>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int H, Strides qst, Strides kst, Strides vst,
                 Strides ost, float scale, cudaStream_t st) {
  const size_t smem = FlashTile<D>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      flash_causal_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_causal_kernel<D><<<grid, kFlashThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      S, qst, kst, vst, ost, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mixq

using namespace mixq;

extern "C" const char* mixq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, out (B, S, H, D) bf16 with element strides (batch, seq, head)
// each, head_dim contiguous; pointers 16-byte aligned and strides
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
