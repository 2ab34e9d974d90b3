// Weight-only GEMMs on the H100 tensor cores, bf16 x against a quantized
// weight read in place (no dequantized or re-laid-out copy of it ever
// exists in device memory), f32 sums:
//
//   K4  wo_matmul (replaces mixq_tensorrt_llm_tpu/ops/wo_matmul.py
//       _wo_kernel): out = (x @ int8 W) * scale_col, W (K, N) int8.
//   K12 wo_matmul_packed (_wo_packed_kernel): W packed int4 in
//       quant.core.pack_int4's K-half layout, int8 (K/2, N): byte (kp, n)
//       holds row kp in its low nibble and row kp + K/2 in its high one;
//       out = (x @ W) * scale_col.
//   K13 wo_matmul_packed_grouped (_wo_packed_grouped_kernel): K12's weight
//       with (K/gs, N) group scales; each group's f32 partial is scaled by
//       its group's scale before it is added in (the weights are never
//       scaled). Low-nibble row kp is in group kp / gs, its high nibble in
//       K/(2 gs) + kp / gs.
//
// Products of a bf16 value and an int8 or int4 value are exact in f32, so
// every kernel differs from its plain version only in the order of sums.
//
// Small and mid M (decode, the speculative verify): bound by bytes (one
// weight byte, or half of one, for 2·M flops), so the design keeps every
// SM streaming. wo_mma_body, one template for K4, K12 and K13:
//   - operands swapped, as TensorRT-LLM's and Marlin's weight-only decode
//     GEMMs lay them out: an mma.sync m16n8k16's 16 rows are output
//     columns, its n = 8 rows of x (MT / 8 n-tiles, MT up to 64 for K4);
//   - a block owns 128 columns (K4: the last may own 64, N % 128 == 64:
//     its copies of the other 64 arrive as zeros and their stores are
//     skipped); the weight's rows and x's matching slice
//     stream through a 4-stage ring of 16-byte cp.async.cg copies (64
//     weight rows a stage: 64 rows of K for K4, 64 packed rows, 128 of K,
//     for K12/K13);
//   - K (or K/2) is split across blocks (ops/wo_matmul.py plans it) so the
//     grid holds two blocks an SM; the splits' f32 partials are summed in
//     split order by the last block of a column tile to arrive (an atomic
//     ticket), in the same launch: fixed order, bit-equal on a repeat;
//   - a thread's 32-bit shared-memory reads of rows 2t, 2t+1, 2t+8 and
//     2t+9 of columns 4g..4g+3 feed two mma tiles: tile tau's row g + 8h
//     is column 4g + 2·tau + h of the warp's 32;
//   - int8 -> bf16 (K4): a byte permute puts the byte ^ 0x80 in the f32
//     mantissa of 2^23 (2^23 + s + 128 exactly), one subtraction leaves s,
//     and one cvt.rn.bf16x2.f32 packs a pair: exact, |s| <= 128 fits
//     bf16's 8-bit significand. int4 -> bf16 (K12/K13): nibble ^ 8 in the
//     mantissa of bf16 128.0 (0x4300), minus 136;
//   - K12/K13 take a 16-row k step as two mmas, the low nibbles against
//     x's first half and the high nibbles against its second, into two
//     sets of sums (two independent mma chains); K12 adds them at the end,
//     K13 scales each by its group's scales (read once a group from L2) at
//     each group's end. K13's splits start on group boundaries (gs % 64 ==
//     0: a group is whole ring stages).
//
// Prefill M (K4 only): bound by operations, so the tensor cores' full rate
// through wgmma, with TMA copies: wo_wgmma_kernel, a 256-column x 128-row
// output tile per block, a producer warpgroup issuing every copy and two
// consumer warpgroups of 128 columns each (setmaxnreg moves the producer's
// registers to them). Operands swapped again: out^T = W^T · x^T, the int8
// tile converted in registers (as above) is wgmma's register operand A
// and x's tile, K-major and 128-byte swizzled by TMA, its shared-memory
// operand B; x's rows are wgmma's n = 128. A 4-stage mbarrier ring of
// 64-deep k steps (two 64 x 128 int8 boxes and a 128 x 64 bf16 box, 32 KB)
// keeps the next copies in flight, and each consumer converts the next
// stage's int8 into a second set of fragments while its wgmmas on this one
// run; scale_col multiplies in the epilogue before the one cast.

#include "hopper.cuh"

namespace mixq {

enum WoMode : int { kInt8 = 0, kPacked = 1, kGrouped = 2 };

// ---------------------------------------------------------------------------
// small and mid M: mma.sync, a cp.async ring, split K (K4, K12, K13)
// ---------------------------------------------------------------------------
constexpr int kQmThreads = 256;                  // 8 warps
constexpr int kQmCols = 128;                     // output columns per block
constexpr int kQmChunk = 64;                     // weight rows per stage
constexpr int kQmStages = 4;                     // the ring of async copies
// bytes per staged weight row: 16 bytes of padding put a warp's 32-bit
// reads of rows 2t and 2t + 1 in 32 distinct banks
constexpr int kQmLdw = kQmCols + 16;
constexpr int kQmLdx = kQmChunk + 8;             // bf16 per staged x row
constexpr int kQmColGroups = kQmCols / 32;       // warps across the columns
constexpr int kQmKGroups = kQmThreads / 32 / kQmColGroups;  // and along K
constexpr int kQmWarpRows = kQmChunk / kQmKGroups;  // a chunk's rows a warp
constexpr int kQmStep = 16;                      // weight rows a k step

// One ring stage: 64 weight rows x 128 columns and x at those rows, MT rows
// of x (K12/K13: both halves, x[m][kp] and x[m][kp + K/2]).
template <int Mode, int MT>
struct QmStage {
  static constexpr int kHalves = Mode == kInt8 ? 1 : 2;
  static constexpr int kW = kQmChunk * kQmLdw;
  static constexpr int kX = MT * kQmLdx * 2;     // bytes of one half
  static constexpr int kBytes = kW + kHalves * kX;
};

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

// Byte j of two words of int8 as bf16x2 (lo's in the low half). The words
// come biased (^ 0x80808080): byte u = s + 128 in the mantissa of 2^23 is
// the f32 2^23 + 128 + s, and subtracting 2^23 + 128 leaves s exactly, an
// integer that bf16 holds exactly.
__device__ __forceinline__ float biased_s8_f32(uint32_t biased, int j) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 | j)) -
         8388736.f;
}
__device__ __forceinline__ uint32_t s8x2_bf16x2(uint32_t lo, uint32_t hi,
                                                int j) {
  return pack_f32(biased_s8_f32(lo, j), biased_s8_f32(hi, j));
}

// The A fragments of the two 16-column tiles a thread feeds from its four
// words of int8 (rows 2t, 2t+1, 2t+8, 2t+9 of columns 4g..4g+3): tile
// tau's row g is column 4g + 2·tau, its row g + 8 column 4g + 2·tau + 1.
__device__ __forceinline__ void int8_fragments(uint32_t w0, uint32_t w1,
                                               uint32_t w2, uint32_t w3,
                                               uint32_t a[2][4]) {
  const uint32_t v0 = w0 ^ 0x80808080u, v1 = w1 ^ 0x80808080u;
  const uint32_t v2 = w2 ^ 0x80808080u, v3 = w3 ^ 0x80808080u;
#pragma unroll
  for (int tau = 0; tau < 2; ++tau) {
    a[tau][0] = s8x2_bf16x2(v0, v1, 2 * tau);
    a[tau][1] = s8x2_bf16x2(v0, v1, 2 * tau + 1);
    a[tau][2] = s8x2_bf16x2(v2, v3, 2 * tau);
    a[tau][3] = s8x2_bf16x2(v2, v3, 2 * tau + 1);
  }
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

// Block (blockIdx.x: 128 columns, .y: split of the weight's rows, .z: MT
// rows of x). Warp (cg, kg) owns 32 columns and half of each chunk's rows.
// Sums: the K groups of a block in order, then (splits > 1) the last block
// of a column tile to arrive adds the splits' f32 partials in split order.
// K13 (gs_chunks: chunks a group) flushes its group partials into the sum
// at each group's end.
template <int Mode, int MT, typename OutT>
__device__ __forceinline__ void wo_mma_body(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, OutT* __restrict__ out,
    float* __restrict__ part, unsigned* __restrict__ tickets, int M, int K,
    int N, int chunks_per_split, int gs_chunks) {
  using Stage = QmStage<Mode, MT>;
  constexpr int NT = MT / 8;
  constexpr int H = Stage::kHalves;
  constexpr bool kGroups = Mode == kGrouped;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last_block;
  const int rows = Mode == kInt8 ? K : K / 2;    // weight rows
  const int n_chunks = (rows + kQmChunk - 1) / kQmChunk;
  const int tile = blockIdx.x, split = blockIdx.y, slab = blockIdx.z;
  const int splits = gridDim.y;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);
  const int n0 = tile * kQmCols, m0 = slab * MT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // 16-byte copies of x where every copy is all in range or all out (rows
  // % 8 == 0) and aligned, else one value at a time
  const bool x_vec = K % (8 * H) == 0;

  auto load_stage = [&](int c) {
    unsigned char* dst = smem + ((c - c_begin) % kQmStages) * Stage::kBytes;
    const int r0 = c * kQmChunk;
    for (int i = tid; i < kQmChunk * (kQmCols / 16); i += kQmThreads) {
      const int r = i / (kQmCols / 16), v = i % (kQmCols / 16);
      // rows past the weight's and the columns of a half last tile (N %
      // 128 == 64) arrive as zeros
      const bool in = r0 + r < rows && n0 + v * 16 < N;
      const int8_t* src =
          in ? w + static_cast<size_t>(r0 + r) * N + n0 + v * 16 : w;
      cp_async16(smem_u32(dst + r * kQmLdw + v * 16), src, in);
    }
    auto* xs = reinterpret_cast<__nv_bfloat16*>(dst + Stage::kW);
    if (x_vec) {
      for (int i = tid; i < H * MT * (kQmChunk / 8); i += kQmThreads) {
        const int half = i / (MT * (kQmChunk / 8));
        const int m = (i / (kQmChunk / 8)) % MT, j = (i % (kQmChunk / 8)) * 8;
        const bool in = m0 + m < M && r0 + j < rows;
        const __nv_bfloat16* src =
            in ? x + static_cast<size_t>(m0 + m) * K + half * rows + r0 + j
               : x;
        cp_async16(smem_u32(xs + (half * MT + m) * kQmLdx + j), src, in);
      }
    } else {
      for (int i = tid; i < H * MT * kQmChunk; i += kQmThreads) {
        const int half = i / (MT * kQmChunk);
        const int m = (i / kQmChunk) % MT, j = i % kQmChunk;
        const bool in = m0 + m < M && r0 + j < rows;
        xs[(half * MT + m) * kQmLdx + j] =
            in ? x[static_cast<size_t>(m0 + m) * K + half * rows + r0 + j]
               : __float2bfloat16(0.f);
      }
    }
  };
  for (int s = 0; s < kQmStages - 1; ++s) {
    if (c_begin + s < c_end) load_stage(c_begin + s);
    cp_async_commit();
  }

  const int cg = warp % kQmColGroups, kg = warp / kQmColGroups;
  const int col4 = n0 + cg * 32 + 4 * g;         // this thread's 4 columns
  float acc[2][NT][4], plo[2][NT][4], phi[2][NT][4];
#pragma unroll
  for (int tau = 0; tau < 2; ++tau)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[tau][nt][e] = plo[tau][nt][e] = phi[tau][nt][e] = 0.f;
  float4 s_lo = make_float4(0.f, 0.f, 0.f, 0.f), s_hi = s_lo;

  for (int c = c_begin; c < c_end; ++c) {
    cp_async_wait<kQmStages - 2>();   // chunk c has landed
    __syncthreads();                  // ... for every thread; c - 1 is read
    if (c + kQmStages - 1 < c_end) load_stage(c + kQmStages - 1);
    cp_async_commit();
    if constexpr (kGroups) {
      if (c % gs_chunks == 0 && col4 < N) {  // a group starts: its scales
        const int grp = c / gs_chunks, n_lo_groups = n_chunks / gs_chunks;
        s_lo = __ldg(reinterpret_cast<const float4*>(
            scale + static_cast<size_t>(grp) * N + col4));
        s_hi = __ldg(reinterpret_cast<const float4*>(
            scale + static_cast<size_t>(n_lo_groups + grp) * N + col4));
      }
    }
    const unsigned char* st =
        smem + ((c - c_begin) % kQmStages) * Stage::kBytes;
    const unsigned char* ws = st + cg * 32 + 4 * g;
    const auto* xs = reinterpret_cast<const __nv_bfloat16*>(st + Stage::kW);
#pragma unroll
    for (int ks = 0; ks < kQmWarpRows / kQmStep; ++ks) {
      const int r0 = kg * kQmWarpRows + ks * kQmStep;
      const unsigned char* wr = ws + (r0 + 2 * t) * kQmLdw;
      const uint32_t w0 = ld32(wr), w1 = ld32(wr + kQmLdw);
      const uint32_t w2 = ld32(wr + 8 * kQmLdw), w3 = ld32(wr + 9 * kQmLdw);
      uint32_t b[H][NT][2];
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const __nv_bfloat16* xr =
              xs + (h * MT + nt * 8 + g) * kQmLdx + r0 + 2 * t;
          b[h][nt][0] = ld32(xr);
          b[h][nt][1] = ld32(xr + 8);
        }
      if constexpr (Mode == kInt8) {
        uint32_t a[2][4];
        int8_fragments(w0, w1, w2, w3, a);
#pragma unroll
        for (int tau = 0; tau < 2; ++tau)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_16816(acc[tau][nt], a[tau], b[0][nt][0], b[0][nt][1]);
      } else {
#pragma unroll
        for (int tau = 0; tau < 2; ++tau) {
          // byte 2·tau (column row g) of the two rows' words as bytes 0
          // and 2, byte 2·tau + 1 (row g + 8) as those of the next
          const uint32_t s0 = 0x4400 + 0x1111 * 2 * tau, s1 = s0 + 0x1111;
          const uint32_t p0 = __byte_perm(w0, w1, s0);
          const uint32_t p1 = __byte_perm(w0, w1, s1);
          const uint32_t p2 = __byte_perm(w2, w3, s0);
          const uint32_t p3 = __byte_perm(w2, w3, s1);
          const uint32_t lo[4] = {nibbles_bf16x2(p0), nibbles_bf16x2(p1),
                                  nibbles_bf16x2(p2), nibbles_bf16x2(p3)};
          const uint32_t hi[4] = {
              nibbles_bf16x2(p0 >> 4), nibbles_bf16x2(p1 >> 4),
              nibbles_bf16x2(p2 >> 4), nibbles_bf16x2(p3 >> 4)};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma_16816(kGroups ? plo[tau][nt] : acc[tau][nt], lo,
                      b[0][nt][0], b[0][nt][1]);
            mma_16816(phi[tau][nt], hi, b[1][nt][0], b[1][nt][1]);
          }
        }
      }
    }
    if constexpr (kGroups) {
      if ((c + 1) % gs_chunks == 0) {   // the group ends: scale, add in
        const float sl[4] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w};
        const float sh[4] = {s_hi.x, s_hi.y, s_hi.z, s_hi.w};
#pragma unroll
        for (int tau = 0; tau < 2; ++tau)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = 2 * tau + (e >> 1);
              acc[tau][nt][e] += plo[tau][nt][e] * sl[q];
              acc[tau][nt][e] += phi[tau][nt][e] * sh[q];
              plo[tau][nt][e] = phi[tau][nt][e] = 0.f;
            }
      }
    }
  }
  if constexpr (Mode == kPacked) {     // K12's high-nibble sums
#pragma unroll
    for (int tau = 0; tau < 2; ++tau)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[tau][nt][e] += phi[tau][nt][e];
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
  // four neighbouring columns a thread at a time; K13's sums are scaled
  // already, K4's and K12's take scale_col here
  constexpr int kQuads = kQmCols / 4;
  auto add4 = [](float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  };
  auto store4 = [&](int m, int c4, float4 v) {
    if constexpr (!kGroups) {
      const float4 s = __ldg(reinterpret_cast<const float4*>(scale + n0 + c4));
      v = make_float4(v.x * s.x, v.y * s.y, v.z * s.z, v.w * s.w);
    }
    OutT* o = out + static_cast<size_t>(m0 + m) * N + n0 + c4;
    if constexpr (std::is_same<OutT, float>::value)
      *reinterpret_cast<float4*>(o) = v;
    else
      *reinterpret_cast<uint2*>(o) =
          make_uint2(pack_f32(v.x, v.y), pack_f32(v.z, v.w));
  };
  float* mine = part + (static_cast<size_t>(split) * gridDim.z + slab) * MT * N;
  for (int i = tid; i < MT * kQuads; i += kQmThreads) {
    const int m = i / kQuads, c4 = (i % kQuads) * 4;
    if (n0 + c4 >= N) continue;       // past a half last tile
    float4 v = *reinterpret_cast<const float4*>(red + m * kQmCols + c4);
#pragma unroll
    for (int q = 1; q < kQmKGroups; ++q)
      v = add4(v, *reinterpret_cast<const float4*>(
                      red + (q * MT + m) * kQmCols + c4));
    if (splits == 1) {
      if (m0 + m < M) store4(m, c4, v);
    } else {
      *reinterpret_cast<float4*>(mine + static_cast<size_t>(m) * N + n0 +
                                 c4) = v;
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
  const size_t split_stride = static_cast<size_t>(gridDim.z) * MT * N / 4;
  const float* first = part + static_cast<size_t>(slab) * MT * N;
  for (int i = tid; i < MT * kQuads; i += kQmThreads) {
    const int m = i / kQuads, c4 = (i % kQuads) * 4;
    if (m0 + m >= M || n0 + c4 >= N) continue;
    const float4* p = reinterpret_cast<const float4*>(
        first + static_cast<size_t>(m) * N + n0 + c4);
    float4 v = __ldcg(p);
#pragma unroll 8                      // loads in flight; the sum in order
    for (int s = 1; s < splits; ++s) v = add4(v, __ldcg(p + s * split_stride));
    store4(m, c4, v);
  }
  if (tid == 0) *ticket = 0u;         // ready for the next launch
}

// One kernel name a regime, so traces tell them apart: K4 at decode (MT <=
// 16) and at mid M (the verify), K12, K13. Two blocks an SM (at most 128
// registers a thread) but at 64 rows of x, which would spill.
#define MIXQ_WO_MMA_KERNEL(NAME, MODE)                                       \
  template <int MT, typename OutT>                                           \
  __global__ void __launch_bounds__(kQmThreads, MT < 64 ? 2 : 1) NAME(       \
      const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,     \
      const float* __restrict__ scale, OutT* __restrict__ out,               \
      float* __restrict__ part, unsigned* __restrict__ tickets, int M,       \
      int K, int N, int cps, int gs_chunks) {                                \
    wo_mma_body<MODE, MT, OutT>(x, w, scale, out, part, tickets, M, K, N,    \
                                cps, gs_chunks);                             \
  }
MIXQ_WO_MMA_KERNEL(wo_small_mma_kernel, kInt8)
MIXQ_WO_MMA_KERNEL(wo_mid_mma_kernel, kInt8)
MIXQ_WO_MMA_KERNEL(packed_mma_kernel, kPacked)
MIXQ_WO_MMA_KERNEL(packed_grouped_mma_kernel, kGrouped)
#undef MIXQ_WO_MMA_KERNEL

template <int Mode, int MT, typename OutT>
int launch_mma_mt(const void* x, const void* w, const void* scale, void* out,
                  void* part, void* tickets, int M, int K, int N, int splits,
                  int cps, int gs_chunks, cudaStream_t st) {
  using Kernel = void (*)(const __nv_bfloat16*, const int8_t*, const float*,
                          OutT*, float*, unsigned*, int, int, int, int, int);
  Kernel kernel;
  if constexpr (Mode == kPacked) kernel = packed_mma_kernel<MT, OutT>;
  else if constexpr (Mode == kGrouped)
    kernel = packed_grouped_mma_kernel<MT, OutT>;
  else if constexpr (MT <= 16) kernel = wo_small_mma_kernel<MT, OutT>;
  else kernel = wo_mid_mma_kernel<MT, OutT>;
  const size_t smem =
      static_cast<size_t>(kQmStages) * QmStage<Mode, MT>::kBytes;
  static_assert(2 * MT * kQmCols * 4 <= kQmStages * QmStage<Mode, MT>::kBytes,
                "the K groups' sums must fit in the ring");
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + kQmCols - 1) / kQmCols, splits, (M + MT - 1) / MT);
  kernel<<<grid, kQmThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<OutT*>(out),
      static_cast<float*>(part), static_cast<unsigned*>(tickets), M, K, N,
      cps, gs_chunks);
  return static_cast<int>(cudaGetLastError());
}

// mt is the rows of x a block (ops/wo_matmul.py: 8 or 16 for K12/K13; 8,
// 16, 24, 32, 40, 48 or 64 for K4)
template <int Mode, typename OutT>
int launch_mma(int mt, const void* x, const void* w, const void* scale,
               void* out, void* part, void* tickets, int M, int K, int N,
               int splits, int cps, int gs_chunks, cudaStream_t st) {
  const int rows = Mode == kInt8 ? K : K / 2;
  const int n_chunks = (rows + kQmChunk - 1) / kQmChunk;
  // K4 takes a half last column tile; K12 and K13 whole tiles
  if (splits < 1 || cps < 1 || N % (Mode == kInt8 ? 64 : kQmCols) ||
      static_cast<long long>(splits) * cps < n_chunks ||
      (splits - 1) * cps >= n_chunks || (splits > 1 && !part) ||
      (Mode == kGrouped &&
       (gs_chunks < 1 || n_chunks % gs_chunks || cps % gs_chunks ||
        rows % kQmChunk)))
    return static_cast<int>(cudaErrorInvalidValue);
#define MIXQ_MT(V)                                                           \
  if (mt == V)                                                               \
    return launch_mma_mt<Mode, V, OutT>(x, w, scale, out, part, tickets, M,  \
                                        K, N, splits, cps, gs_chunks, st);
  MIXQ_MT(8)
  MIXQ_MT(16)
  if constexpr (Mode == kInt8) {
    MIXQ_MT(24)
    MIXQ_MT(32)
    MIXQ_MT(40)
    MIXQ_MT(48)
    MIXQ_MT(64)
  }
#undef MIXQ_MT
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// prefill M (K4): wgmma + TMA
// ---------------------------------------------------------------------------
constexpr int kGmRows = 128;                     // rows of x a block (n)
constexpr int kGmWgCols = 128;                   // columns a consumer
constexpr int kGmCols = 2 * kGmWgCols;           // columns a block
constexpr int kGmDepth = 64;                     // k a stage
constexpr int kGmStages = 4;
constexpr int kGmConsumers = 256;
constexpr int kGmThreads = kGmConsumers + 128;   // + the producer warpgroup
constexpr int kGmConsumerRegs = 240;             // 2 x 128 x 240 + 128 x 24
constexpr int kGmProducerRegs = 24;              //   <= 64 K registers
constexpr int kGmWBytes = kGmDepth * kGmWgCols;  // a consumer's int8 box
constexpr int kGmXBytes = kGmRows * kGmDepth * 2;  // x's bf16 box
constexpr int kGmStage = 2 * kGmWBytes + kGmXBytes;
// + 1024: the swizzled boxes start on a 1024-byte boundary
constexpr size_t kGmSmem = static_cast<size_t>(kGmStages) * kGmStage + 1024;
static_assert(kGmSmem <= 232448, "over the 227 KB of shared memory");

// Block (blockIdx.x: 128 rows of x, .y: 256 columns; the row tiles of one
// column tile run side by side, so its weight is read from memory once).
// Consumer warpgroup c owns columns c·128 .. c·128 + 127 of the tile; in
// its wgmma tau (m64n128k16), warp v's row 16v + g + 8h is column 32v + 4g
// + 2·tau + h, so a thread's 32-bit reads of the swizzled int8 box are the
// same words as in wo_mma_body. Accumulator element 4j + e of wgmma tau:
// column 32v + 4g + 2·tau + (e >> 1), row of x 8j + 2t + (e & 1), so a
// thread stores 4 neighbouring columns of a row at once.
template <typename OutT>
__global__ void __launch_bounds__(kGmThreads, 1)
    wo_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const float* __restrict__ scol, OutT* __restrict__ out,
                    int M, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kGmStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = bars;
  uint64_t* empty = bars + kGmStages;
  const int m0 = blockIdx.x * kGmRows, n0 = blockIdx.y * kGmCols;
  const int n_k = (K + kGmDepth - 1) / kGmDepth;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kGmStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kGmConsumers / 32);  // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kGmConsumers) {                   // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kGmProducerRegs));
    if (tid == kGmConsumers) {
      for (int j = 0; j < n_k; ++j) {
        const int s = j % kGmStages;
        unsigned char* st = smem + s * kGmStage;
        mbar_wait(&empty[s], ((j / kGmStages) & 1) ^ 1);
        // out-of-bounds rows, columns and k arrive as zeros, and count
        mbar_expect_tx(&full[s], kGmStage);
        tma_load_2d(st, &wmap, &full[s], n0, j * kGmDepth);
        tma_load_2d(st + kGmWBytes, &wmap, &full[s], n0 + kGmWgCols,
                    j * kGmDepth);
        tma_load_2d(st + 2 * kGmWBytes, &xmap, &full[s], j * kGmDepth, m0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kGmConsumerRegs));
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the 16-byte chunk of a 128-byte box row that holds this thread's
  // columns 32·warp + 4g .. + 3, before the swizzle, and the word in it
  const int chunk = 2 * warp + (g >> 2), word = 4 * (g & 3);

  float acc[2][64];
#pragma unroll
  for (int tau = 0; tau < 2; ++tau)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[tau][i] = 0.f;

  // Stage j's A fragments: its 4 k steps' rows 2t, 2t+1, 2t+8, 2t+9 of
  // each 16, read through the 128-byte swizzle (chunk ^ row % 8).
  using Frags = uint32_t[kGmDepth / 16][2][4];
  auto convert = [&](int j, Frags& a) {
    const int s = j % kGmStages;
    mbar_wait(&full[s], (j / kGmStages) & 1);
    const unsigned char* wt = smem + s * kGmStage + wg * kGmWBytes;
#pragma unroll
    for (int kk = 0; kk < kGmDepth / 16; ++kk) {
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = kk * 16 + 2 * t + (q & 1) + 8 * (q >> 1);
        v[q] = ld32(wt + r * 128 + ((chunk ^ (r & 7)) << 4) + word);
      }
      int8_fragments(v[0], v[1], v[2], v[3], a[kk]);
    }
  };
  // Stage j multiplies with `cur` while stage j + 1 converts into `nxt`
  // (two sets of fragments: a wgmma reads its registers asynchronously).
  auto step = [&](int j, Frags& cur, Frags& nxt) {
    const int s = j % kGmStages;
    const uint32_t x_addr = smem_u32(smem + s * kGmStage + 2 * kGmWBytes);
#pragma unroll
    for (int tau = 0; tau < 2; ++tau) fence_regs<64>(acc[tau]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kGmDepth / 16; ++kk)
#pragma unroll
      for (int tau = 0; tau < 2; ++tau)
        wgmma_rs_n128<0>(acc[tau], cur[kk][tau],
                         sw128_desc(x_addr + kk * 32, 16, 1024));
    wg_commit();
    if (j + 1 < n_k) convert(j + 1, nxt);
    wg_wait_all();
#pragma unroll
    for (int tau = 0; tau < 2; ++tau) fence_regs<64>(acc[tau]);
    if (lane == 0) mbar_arrive(&empty[s]);     // this warp is done with s
  };
  Frags a0, a1;
  convert(0, a0);
  for (int j = 0; j < n_k; j += 2) {
    step(j, a0, a1);
    if (j + 1 < n_k) step(j + 1, a1, a0);
  }

  const int col = n0 + wg * kGmWgCols + 32 * warp + 4 * g;
  if (col >= N) return;
  const float4 sc = __ldg(reinterpret_cast<const float4*>(scol + col));
#pragma unroll
  for (int jn = 0; jn < kGmRows / 8; ++jn)
#pragma unroll
    for (int odd = 0; odd < 2; ++odd) {
      const int row = m0 + 8 * jn + 2 * t + odd;
      if (row >= M) continue;
      const float v[4] = {acc[0][4 * jn + odd] * sc.x,
                          acc[0][4 * jn + 2 + odd] * sc.y,
                          acc[1][4 * jn + odd] * sc.z,
                          acc[1][4 * jn + 2 + odd] * sc.w};
      OutT* o = out + static_cast<size_t>(row) * N + col;
      if constexpr (std::is_same<OutT, float>::value) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        *reinterpret_cast<uint2*>(o) =
            make_uint2(pack_f32(v[0], v[1]), pack_f32(v[2], v[3]));
      }
    }
}

template <typename OutT>
int launch_wgmma(const void* x, const void* w, const void* scol, void* out,
                 int M, int K, int N, cudaStream_t st) {
  CUtensorMap xmap, wmap;
  int e = make_map_2d(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K,
                      kGmDepth, kGmRows);
  if (!e)
    e = make_map_2d(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N,
                    kGmWgCols, kGmDepth);
  if (e) return e;
  const cudaError_t a = cudaFuncSetAttribute(
      wo_wgmma_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kGmSmem));
  if (a != cudaSuccess) return static_cast<int>(a);
  const dim3 grid((M + kGmRows - 1) / kGmRows, (N + kGmCols - 1) / kGmCols);
  wo_wgmma_kernel<OutT><<<grid, kGmThreads, kGmSmem, st>>>(
      xmap, wmap, static_cast<const float*>(scol), static_cast<OutT*>(out), M,
      K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mixq

using namespace mixq;

extern "C" const char* mixq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K4: x (M, K) bf16, w (K, N) int8, scale_col (N,) f32 -> out (M, N) of
// out_dtype. mt = 0: the wgmma GEMM (prefill); else the mma kernel with mt
// rows of x a block and K cut into `splits` ranges of chunks_per_split
// chunks of 64 rows (ops/wo_matmul.py wo_plan); with splits > 1, part
// holds splits x ceil(M/mt) x mt x N f32 partials and tickets ceil(M/mt) x
// ceil(N/128) zeroed counters, which the kernel leaves zeroed. The wrapper
// guarantees M >= 1, K % 32 == 0, N % 64 == 0 and 16-byte aligned x and w.
extern "C" int mixq_wo_matmul(const void* x, const void* w, const void* scol,
                              void* out, void* part, void* tickets, int M,
                              int K, int N, int mt, int splits,
                              int chunks_per_split, int out_dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_out_type(out_dtype, [&](auto o) {
    using OutT = typename decltype(o)::type;
    if (mt == 0) return launch_wgmma<OutT>(x, w, scol, out, M, K, N, st);
    return launch_mma<kInt8, OutT>(mt, x, w, scol, out, part, tickets, M, K,
                                   N, splits, chunks_per_split, 1, st);
  });
}

// K12: x (M, K) bf16, w (K/2, N) packed int4 (K-half layout), scale_col
// (N,) f32 -> out (M, N). mt (8 or 16) rows of x a block, K/2 cut into
// `splits` ranges of chunks_per_split chunks of 64 packed rows
// (ops/wo_matmul.py packed_plan); part and tickets as for K4. The wrapper
// guarantees M >= 1, K % 2 == 0, N % 128 == 0 and 16-byte aligned w.
extern "C" int mixq_wo_matmul_packed(const void* x, const void* w,
                                     const void* scale, void* out,
                                     void* part, void* tickets, int M, int K,
                                     int N, int mt, int splits,
                                     int chunks_per_split, int out_dtype,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_out_type(out_dtype, [&](auto o) {
    using OutT = typename decltype(o)::type;
    return launch_mma<kPacked, OutT>(mt, x, w, scale, out, part, tickets, M,
                                     K, N, splits, chunks_per_split, 1, st);
  });
}

// K13: as K12 with scale (K/group_size, N) f32 group scales; group_size %
// 64 == 0 and (K/2) % group_size == 0, and chunks_per_split a multiple of
// group_size / 64, so that every split holds whole groups
// (ops/wo_matmul.py grouped_plan). The wrapper guarantees those and
// 16-byte aligned w and scale.
extern "C" int mixq_wo_matmul_packed_grouped(
    const void* x, const void* w, const void* scale, void* out, void* part,
    void* tickets, int M, int K, int N, int group_size, int mt, int splits,
    int chunks_per_split, int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group_size <= 0 || group_size % kQmChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_out_type(out_dtype, [&](auto o) {
    using OutT = typename decltype(o)::type;
    return launch_mma<kGrouped, OutT>(mt, x, w, scale, out, part, tickets,
                                      M, K, N, splits, chunks_per_split,
                                      group_size / kQmChunk, st);
  });
}
