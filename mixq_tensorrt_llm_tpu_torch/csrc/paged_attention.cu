// K7 / K8 / K9 / K10: attention over the paged KV pool, pages read in
// place.
//
// Replaces mixq_tensorrt_llm_tpu/ops/paged_attention.py:
//   K7  _decode_kernel, s = 1 (paged_decode_attention: one query per lane)
//   K9  _decode_kernel, s > 1 (paged_verify_attention: 1..8 query rows per
//       lane at consecutive positions, the speculative verify)
//   K10 _decode_kernel, stats=True (paged_decode_attention(stats=True):
//       f32 output plus the softmax's running (m, l))
//   K11 paged_decode_attention_split (K10 over kv_splits page ranges a
//       lane, then merge_attention_stats): K7's kernel with its splits
//       inside those ranges, merged in the same launch
//   K8  _prefill_kernel (paged_prefill_attention: a chunk of C query tokens)
// in both of their modes: int8 pages with per-(token, head) scales
// (quantized=True), and unquantized bf16 or f32 pages (quantized=False).
// The page type P is a template parameter; the unquantized instantiations
// leave out the scale multiplies (where the Pallas kernels multiply by
// scale pages of ones).
//
// All walk the lane's block table, skip pages no query of the block can
// see, and keep a flash-style online softmax in f32. The int8 K scale
// multiplies the logits and the int8 V scale the probabilities, so no
// dequantized copy of a page ever exists. Positions are absolute: entry j's
// base comes from block_pos, which keeps recycled (windowed) pages right.
// A fully masked row contributes exactly 0 (the exp subtrahend is clamped
// at -0.5e30 as the Pallas kernels do), so inactive lanes (table 0,
// block_pos PAD_POS, len 1) produce 0 and never NaN.
//
// Bound on the H100: bytes for decode and verify (every visited page's K
// and V, and their scales, read once; about 2 FLOP per byte per query
// row), bytes or bf16 FLOP for the prefill. The designs:
//   K7   decode_split_kernel: each lane's table split across blocks of one
//        launch (grid Hkv x B x splits, splits from the shapes alone), a
//        2-stage ring of 1-D bulk copies (cp.async.bulk, mbarrier
//        completion), f32 CUDA-core arithmetic on 16-byte and 4-value page
//        reads, the splits merged in the same launch by the last to arrive.
//   K11  the same kernel and launch over the lanes' own tables, each split
//        inside one of the kv_splits ranges (no host-side split or merge).
//   K9, K10  verify_rows_kernel, stats_rows_kernel: one body on K7's
//        skeleton (grid, plan, ring, merge) with the rows on tensor cores:
//        mma.sync m16n8k16 bf16 for bf16 q on int8 or bf16 pages.
//   K8   prefill_wgmma_kernel: flash attention on wgmma with a producer
//        warpgroup that brings pages by bulk copies and converts them into
//        the wgmma layout; each page read once per (kv head, query tile).
//   f32 q or f32 pages (the f32 test models) take f32 CUDA-core routes by
//   dtype: K9 / K10's body in f32, and K8's prefill_kernel.
//
// Block sizes accepted: 16 <= BS <= 256, BS % 16 == 0; head_dim D a
// multiple of 32 up to 256 (the Python wrappers check this).

#include <algorithm>
#include <climits>

#include "hopper.cuh"

namespace mixq {

// 16 consecutive page values (16-byte aligned) as f32
__device__ __forceinline__ void load16(const int8_t* p, float out[16]) {
  const int4 raw = *reinterpret_cast<const int4*>(p);
  const int8_t* k8 = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(k8[i]);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float out[16]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[h];
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[8 * h + i] = __bfloat162float(b[i]);
  }
}
__device__ __forceinline__ void load16(const float* p, float out[16]) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const float4 v = reinterpret_cast<const float4*>(p)[h];
    out[4 * h] = v.x;
    out[4 * h + 1] = v.y;
    out[4 * h + 2] = v.z;
    out[4 * h + 3] = v.w;
  }
}

constexpr int kThreads = 128;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxD = 256;
constexpr int kMaxBS = 256;
constexpr int kTileQ = 16;        // K8 query tokens per block
constexpr float kClampSub = 0.5f * kNegInf;

// ---------------------------------------------------------------------------
// K7 / K11: decode_split_kernel. One block of 256 threads per (kv head h,
// lane b, split): the table's entries fall into ranges of range_pages
// entries, each cut into splits_per_range splits of pages_per_split; split
// z is split z % splits_per_range of range z / splits_per_range and owns
// its entries below MB (K7: one range of the whole table; K11: the
// kv_splits ranges of ops/paged_attention.py split_decode_plan, entries
// past MB never materialised). A split skips entries with base >= len
// (and, within a page, the ring stages that start at or past len). The G
// query heads of the kv head are its rows; each page is read once for all
// of them.
//   - A ring stage holds ST tokens of one page (K, V and, on int8 pages,
//     their scales): BS, halved until K and V fit kSplitStageKV bytes; a
//     (page, head) slab is contiguous, so thread 0 brings a stage with 2-4
//     1-D bulk copies completing on the stage's mbarrier, the next stage's
//     while the block computes this one (the first ones while q is
//     staged).
//   - logits: LPT lanes per token (8 where D's 16-byte chunks allow), each
//     on its chunks of the K row (16-byte reads; int8 converted exactly by
//     a byte permute into the mantissa of 2^23) against q in f32 from
//     shared memory, laid out so the chunks a warp reads sit in distinct
//     banks; the sums reduced across the LPT lanes by shuffles.
//   - softmax: a warp per row, decode_body's arithmetic.
//   - p·v: a thread owns 4 neighbouring dims and every TG-th token (TG =
//     1024 / D token groups), V read as 4-value vectors; its partial sums
//     live in shared memory between stages ([TG][G][D]) and are summed over
//     the token groups in a fixed order at the end.
//   - splits > 1: each split writes its unnormalized (acc, m, l) per row;
//     the last split of the (lane, head) to arrive (an atomic ticket) merges
//     them in split order with merge_attention_stats' math in f32 (big =
//     max m clamped at kClampSub; sum of acc·e^(m - big) over the sum of
//     l·e^(m - big), at least 1e-20) and casts once; an empty split reports
//     m = kNegInf, l = 0 and weighs nothing. merge_drop = 1 leaves out the
//     last split that saw a key: a fault for the negative controls only.
//     For K11 this is merge_attention_stats over the kv_splits ranges
//     (each range's splits merged the same way first gives the same sums
//     up to f32 rounding), cast once to q's dtype: no (out, m, l) parts
//     leave the launch.
// Bound on the H100 (K7 and K11 alike): bytes, every visited page's K, V
// and scales read once (0.00843 ms int8, 0.01632 ms bf16 at the smoke's 8
// lanes of 1-700 tokens, 32 heads of 128); the design reads each page
// once and merges in the launch, so K11 moves K7's bytes plus its splits'
// partials (written once, read once by the last split).
// ---------------------------------------------------------------------------
constexpr int kSplitThreads = 256;
constexpr int kSplitWarps = kSplitThreads / 32;
// a 2-stage ring of 32 KB stages measured fastest at the smoke's shapes
// against 3 and 4 stages of 16 or 32 KB (fewer blocks an SM; PERF.md)
constexpr int kSplitStages = 2;
constexpr int kSplitStageKV = 32 * 1024;  // bytes of K and V a stage

// tokens a ring stage holds: BS, halved while K and V exceed kSplitStageKV
__host__ __device__ inline int stage_tokens(int BS, int D, int page_bytes) {
  int st = BS;
  while (st % 2 == 0 && st > 8 && 2 * st * D * page_bytes > kSplitStageKV)
    st /= 2;
  return st;
}

// f32 values of q a 16-byte chunk of page values takes in shared memory:
// padded so that 8 consecutive chunks start in distinct 16-byte bank groups
template <typename P>
__host__ __device__ constexpr int q_chunk_floats() {
  constexpr int ce = 16 / static_cast<int>(sizeof(P));
  return (ce / 4) % 2 ? ce : ce + 4;
}

struct SplitLayout {
  int st, stage, q_floats, ps_floats, acc_floats, tg;
  size_t bytes;
};

template <typename P>
__host__ __device__ inline SplitLayout split_layout(int G, int D,
                                                 int BS) {
  SplitLayout L;
  const int pb = static_cast<int>(sizeof(P));
  L.st = stage_tokens(BS, D, pb);
  const int kv = L.st * D * pb;
  L.stage = (2 * kv + (kQuantPages<P> ? 8 * L.st : 0) + 127) / 128 * 128;
  L.q_floats = G * (D * pb / 16) * q_chunk_floats<P>();
  L.ps_floats = G * L.st;
  L.tg = kSplitThreads / (D / 4);
  L.acc_floats = L.tg * G * D;
  L.bytes = kSplitStages * static_cast<size_t>(L.stage) +
            sizeof(float) * static_cast<size_t>(L.q_floats + L.ps_floats +
                                                L.acc_floats + 3 * G);
  return L;
}

// 16 bytes of page values from shared memory as f32
__device__ __forceinline__ void chunk_f32(const int8_t* p, float f[16]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t ws[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                          w.z ^ 0x80808080u, w.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 16; ++i)   // 2^23 + 128 + s exactly, less 2^23 + 128
    f[i] = __uint_as_float(__byte_perm(ws[i / 4], 0x4B000000u,
                                       0x7440 | (i % 4))) - 8388736.f;
}
__device__ __forceinline__ void chunk_f32(const __nv_bfloat16* p,
                                          float f[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(ws[i] << 16);
    f[2 * i + 1] = __uint_as_float(ws[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void chunk_f32(const float* p, float f[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
// 4 neighbouring page values from shared memory as f32
__device__ __forceinline__ float4 quad_f32(const int8_t* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | i)) -
           8388736.f;
  return make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ float4 quad_f32(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xFFFF0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xFFFF0000u));
}
__device__ __forceinline__ float4 quad_f32(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// RP: rows a pass (1 for MHA; 8 under GQA, G rows in passes of 8)
template <typename T, typename P, int RP>
__global__ void __launch_bounds__(kSplitThreads)
    decode_split_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                        const P* __restrict__ vp,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ table,
                        const int* __restrict__ bpos,
                        const int* __restrict__ lens, T* __restrict__ out,
                        float* __restrict__ part,
                        unsigned* __restrict__ tickets, int Hq, int Hkv,
                        int D, int BS, int MB, int range_pages,
                        int splits_per_range, int pages_per_split,
                        float scale, int window, int sink, float softcap,
                        int merge_drop) {
  constexpr bool kQ = kQuantPages<P>;
  constexpr int kCE = 16 / static_cast<int>(sizeof(P));  // values a chunk
  constexpr int kQld = q_chunk_floats<P>();
  extern __shared__ __align__(128) unsigned char split_smem[];
  unsigned char* smem = split_smem;
  __shared__ __align__(8) uint64_t full[kSplitStages];
  __shared__ bool last_block;
  const int G = Hq / Hkv;
  const SplitLayout L = split_layout<P>(G, D, BS);
  const int ST = L.st, TG = L.tg, NG = D / 4;
  const int kv_bytes = ST * D * static_cast<int>(sizeof(P));
  const int nc = D / kCE;                      // chunks of a page row
  const int qrow = nc * kQld;                  // floats of a q row
  float* qs = reinterpret_cast<float*>(smem + kSplitStages * L.stage);
  float* ps = qs + L.q_floats;                 // [G][ST]
  float* accs = ps + L.ps_floats;              // [TG][G][D]
  float* m_s = accs + L.acc_floats;
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = lens[b];
  const int* brow = bpos + static_cast<size_t>(b) * MB;
  const int* trow = table + static_cast<size_t>(b) * MB;
  const int zr = split / splits_per_range;
  const int r1 = min(MB, (zr + 1) * range_pages);
  const int j0 = min(r1, zr * range_pages + (split - zr * splits_per_range) *
                                               pages_per_split);
  const int j1 = min(r1, j0 + pages_per_split);
  // the (entry, stage of the page) units this split visits, in order: a
  // page whose base is below len, and its stages that start below len
  auto first_page = [&](int j) {
    while (j < j1 && brow[j] >= len) ++j;
    return j;
  };
  auto advance = [&](int& j, int& sub) {
    if (++sub * ST >= BS || brow[j] + sub * ST >= len) {
      j = first_page(j + 1);
      sub = 0;
    }
  };
  auto issue = [&](int j, int sub, int stage) {
    const size_t tok0 =
        (static_cast<size_t>(trow[j]) * Hkv + h) * BS + sub * ST;
    unsigned char* st = smem + stage * L.stage;
    mbar_expect_tx(&full[stage], 2 * kv_bytes + (kQ ? 8 * ST : 0));
    bulk_load(st, kp + tok0 * D, kv_bytes, &full[stage]);
    bulk_load(st + kv_bytes, vp + tok0 * D, kv_bytes, &full[stage]);
    if constexpr (kQ) {
      bulk_load(st + 2 * kv_bytes, ks + tok0, 4 * ST, &full[stage]);
      bulk_load(st + 2 * kv_bytes + 4 * ST, vs + tok0, 4 * ST, &full[stage]);
    }
  };
  int j = first_page(j0), sub = 0;
  int ja = j, suba = 0;                        // the next unit to copy
  if (tid == 0) {
    for (int s = 0; s < kSplitStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the first stages' copies fly while q is staged
  for (int s = 0; s < kSplitStages - 1 && ja < j1; ++s) {
    if (tid == 0) issue(ja, suba, s);
    advance(ja, suba);
  }

  // a split with no key to visit (past len, or a K11 range past MB)
  // stages nothing and reports acc 0, m kNegInf, l 0
  const bool visits = j < j1;
  const T* qb = q + (static_cast<size_t>(b) * Hq + h * G) * D;
  for (int i = tid; visits && i < G * D; i += kSplitThreads) {
    const int r = i / D, d = i - r * D;
    qs[r * qrow + (d / kCE) * kQld + d % kCE] = to_f(qb[i]) * scale;
  }
  for (int i = tid; visits && i < L.acc_floats; i += kSplitThreads)
    accs[i] = 0.f;
  for (int r = tid; r < G; r += kSplitThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  // logits: LPT lanes a token, TPW tokens a warp
  const int lpt = nc % 8 == 0 ? 8 : nc % 4 == 0 ? 4 : 2;
  const int tpw = 32 / lpt, sl = lane % lpt, tw = lane / lpt;
  // p·v: 4 dims gi*4.. and tokens tg, tg + TG, ...
  const int gi = tid % NG, tg = tid / NG;

  for (int it = 0; j < j1; ++it) {
    // stage (it - 1) % kSplitStages was freed at the end of the last unit
    if (ja < j1) {
      if (tid == 0) issue(ja, suba, (it + kSplitStages - 1) % kSplitStages);
      advance(ja, suba);
    }
    const int stage = it % kSplitStages;
    mbar_wait(&full[stage], (it / kSplitStages) & 1);
    const unsigned char* st = smem + stage * L.stage;
    const P* kst = reinterpret_cast<const P*>(st);
    const P* vst = reinterpret_cast<const P*>(st + kv_bytes);
    const float* kss = reinterpret_cast<const float*>(st + 2 * kv_bytes);
    const float* vss = kss + ST;
    const int base = brow[j] + sub * ST;

    for (int t0 = warp * tpw; t0 < ST; t0 += kSplitWarps * tpw) {
      const int t = t0 + tw, tl = min(t, ST - 1);
      const P* krow = kst + static_cast<size_t>(tl) * D;
      for (int r0 = 0; r0 < G; r0 += RP) {
        float s[RP];
#pragma unroll
        for (int r = 0; r < RP; ++r) s[r] = 0.f;
        for (int c = sl; c < nc; c += lpt) {
          float kf[kCE];
          chunk_f32(krow + c * kCE, kf);
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            if (r0 + r >= G) break;
            const float* qc = qs + (r0 + r) * qrow + c * kQld;
#pragma unroll
            for (int i = 0; i < kCE; i += 4) {
              const float4 qq = *reinterpret_cast<const float4*>(qc + i);
              s[r] += qq.x * kf[i] + qq.y * kf[i + 1] + qq.z * kf[i + 2] +
                      qq.w * kf[i + 3];
            }
          }
        }
#pragma unroll
        for (int r = 0; r < RP; ++r)
          for (int o = lpt / 2; o > 0; o >>= 1)
            s[r] += __shfl_xor_sync(kFullMask, s[r], o);
        if (sl == 0 && t < ST) {
          const int pos = base + t;
          // the query sits at len - 1, so the causal mask keeps pos < len
          const bool keep = keep_position(pos, len - 1, window, sink);
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            if (r0 + r >= G) break;
            float v = s[r];
            if constexpr (kQ) v *= kss[t];
            if (softcap != 0.f) v = tanhf(v / softcap) * softcap;
            ps[(r0 + r) * ST + t] = keep ? v : kNegInf;
          }
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < G; r += kSplitWarps) {
      float mx = kNegInf;
      for (int t = lane; t < ST; t += 32) mx = fmaxf(mx, ps[r * ST + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float sub_m = fmaxf(m_new, kClampSub);
      float sum = 0.f;
      for (int t = lane; t < ST; t += 32) {
        const float p = expf(ps[r * ST + t] - sub_m);
        sum += p;
        ps[r * ST + t] = kQ ? p * vss[t] : p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v over this thread's tokens
    if (tg < TG) {
      for (int r0 = 0; r0 < G; r0 += RP) {
        float4 a[RP];
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          if (r0 + r >= G) break;
          const float al = a_s[r0 + r];
          const float4 v = *reinterpret_cast<const float4*>(
              accs + (tg * G + r0 + r) * D + 4 * gi);
          a[r] = make_float4(v.x * al, v.y * al, v.z * al, v.w * al);
        }
        for (int t = tg; t < ST; t += TG) {
          const float4 v = quad_f32(vst + static_cast<size_t>(t) * D + 4 * gi);
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            if (r0 + r >= G) break;
            const float p = ps[(r0 + r) * ST + t];
            a[r].x += p * v.x;
            a[r].y += p * v.y;
            a[r].z += p * v.z;
            a[r].w += p * v.w;
          }
        }
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          if (r0 + r >= G) break;
          *reinterpret_cast<float4*>(accs + (tg * G + r0 + r) * D + 4 * gi) =
              a[r];
        }
      }
    }
    __syncthreads();                           // the stage is free again
    advance(j, sub);
  }

  // the token groups' sums, in order
  auto summed = [&](int r, int d) {
    float a = 0.f;
    for (int g = 0; visits && g < TG; ++g) a += accs[(g * G + r) * D + d];
    return a;
  };
  const size_t row0 = (static_cast<size_t>(b) * Hq + h * G) * D;
  if (splits == 1) {
    for (int i = tid; i < G * D; i += kSplitThreads) {
      const int r = i / D;
      store_f(out + row0 + i, summed(r, i - r * D) / fmaxf(l_s[r], 1e-20f));
    }
    return;
  }
  const int pitch = D + 2;                     // acc[D], m, l a row
  const size_t slab = static_cast<size_t>(G) * pitch;
  float* parts = part + (static_cast<size_t>(b) * Hkv + h) * splits * slab;
  float* mine = parts + split * slab;
  for (int i = tid; i < G * D; i += kSplitThreads) {
    const int r = i / D, d = i - r * D;
    mine[r * pitch + d] = summed(r, d);
  }
  for (int r = tid; r < G; r += kSplitThreads) {
    mine[r * pitch + D] = m_s[r];
    mine[r * pitch + D + 1] = l_s[r];
  }
  __threadfence();
  __syncthreads();
  unsigned* ticket = tickets + static_cast<size_t>(b) * Hkv + h;
  if (tid == 0) last_block = atomicAdd(ticket, 1u) == splits - 1u;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int i = tid; i < G * D; i += kSplitThreads) {
    const int r = i / D, d = i - r * D;
    const float* pr = parts + r * pitch;
    float big = kNegInf;
    int drop = -1;
    for (int z = 0; z < splits; ++z) {
      big = fmaxf(big, __ldcg(pr + z * slab + D));
      if (merge_drop && __ldcg(pr + z * slab + D + 1) > 0.f) drop = z;
    }
    big = fmaxf(big, kClampSub);
    float num = 0.f, den = 0.f;
    for (int z = 0; z < splits; ++z) {
      if (z == drop) continue;
      const float e = expf(__ldcg(pr + z * slab + D) - big);
      num += __ldcg(pr + z * slab + d) * e;
      den += __ldcg(pr + z * slab + D + 1) * e;
    }
    store_f(out + row0 + i, num / fmaxf(den, 1e-20f));
  }
  if (tid == 0) *ticket = 0u;                  // ready for the next launch
}

// ---------------------------------------------------------------------------
// K9 / K10: verify_rows_kernel and stats_rows_kernel, two modes of one body
// (decode_rows_body), as they are modes of one Pallas kernel; the third,
// K7, is decode_split_kernel above, whose skeleton this body shares:
//   - grid Hkv x B x (row groups x splits): a block of 4 or 8 warps owns up
//     to 16 rows a warp of one (kv head h, lane b) and the split's range
//     of table entries (ops/paged_attention.py rows_plan, from the shapes
//     alone; 4 warps, one block a (lane, kv head) at the smoke's MHA
//     shapes: measured faster than 8 warps or more splits);
//   - a 2-stage ring of 1-D bulk copies of ST tokens of one page (K, V and
//     on int8 pages their scales), mbarrier completion, the next stage's
//     copies in flight while the block computes this one (4 stages
//     measured no faster);
//   - splits > 1: each split writes its unnormalized (acc, m, l) a row, and
//     the last split of the (lane, head, row group) to arrive merges them
//     in split order with merge_attention_stats' f32 math.
// Rows: row r = s * G + g (query row s, query head g of the kv head's
// group) reads q[b, s, h * G + g] and sits at absolute position qpos0 + s:
//   K9  verify_rows_kernel  qpos0 = qstart[b], S = 1..8 (the speculative
//                           verify's gamma + 1 rows); out in q's dtype
//   K10 stats_rows_kernel   S = 1, qpos0 = len - 1 (the decode query); out
//                           in f32, plus every row's merged (m, l): m the
//                           largest logit, l the sum of exp(logit - m); a
//                           row that saw no key gives out 0, m kNegInf, l 0
// A key is kept for a row if pos < len and the causal / window / sink mask
// keeps it: a K9 row past len - 1 (a short draft prefill's padding row)
// never sees a page's unwritten tail.
//
// Arithmetic. A block's rows are m-tiles of 16; warp w owns m-tile w % MTP
// and the 16-token chunks tq, tq + NTG, ... of each stage (tq = w / MTP,
// NTG = warps / MTP), with its own online-softmax state (m, l and the
// 16 x D output sums in registers, mma.sync's accumulator layout: thread
// (g, t) holds rows g and g + 8). At the end every warp writes its state
// to shared memory and all threads merge each row's warps in warp order,
// so the result does not depend on timing, and K9 at S = 1 is K10
// rounded to q's dtype, bit for bit: the same code up to the final store.
//   - bf16 q on int8 or bf16 pages (every serving path): logits and p·v on
//     mma.sync m16n8k16 bf16 tiles, f32 accumulators. The head dim is
//     permuted inside each 32-wide group (the same permutation for q and
//     K, so the dot product is unchanged): thread t's k values 2t, 2t + 1,
//     2t + 8, 2t + 9 of k-step kk are dims 8t + 4kk .. + 3, so it reads K
//     as 8 contiguous values per row and group. q is staged once as
//     fragments. For p·v, n-tile j's column g is dim g * D/8 + j, so a
//     thread reads V rows 2t, 2t + 1, 2t + 8, 2t + 9 as D/8 contiguous
//     values. int8 page values become bf16 exactly (the f32 byte-permute
//     trick, then the top halves: an 8-bit integer needs no more than
//     bf16's 8 significant bits). The K scale multiplies the logit
//     columns; the V scale the probabilities before they are split into
//     bf16 hi and lo parts for p·v (two mma over the same V fragments):
//     no dequantized page is ever stored.
//   - f32 q or f32 pages (the f32 test models): the same layout and state,
//     f32 arithmetic on CUDA cores (an explicit route by dtype).
// Bound on the H100: bytes (every visited page's K and V, and scales, read
// once); a 16-row m-tile costs one mma whatever S * G <= 16, so the
// verify's rows cost K7's arithmetic, not S times it.
// ---------------------------------------------------------------------------
constexpr int kRowsMaxThreads = 256;       // 4 or 8 warps a block
constexpr int kRowsStages = 2;
constexpr int kRowsStageKV = 32 * 1024;    // bytes of K and V a stage, at most
constexpr float kLog2e = 1.4426950408889634f;

// tokens a ring stage holds: the largest multiple of 16 (a p·v k-step)
// that divides BS and whose K and V fit kRowsStageKV; 16 at least
__host__ __device__ inline int rows_stage_tokens(int BS, int D, int pb) {
  for (int st = BS; st > 16; st -= 16)
    if (BS % st == 0 && 2 * st * D * pb <= kRowsStageKV) return st;
  return 16;
}

struct RowsLayout {
  int st, stage, mtp, ntg, slot_floats, q_bytes;
  size_t ring, bytes;
};

// rows: the rows of the largest row group (min(R, 16 x warps))
template <typename P, bool kMma>
__host__ __device__ inline RowsLayout rows_layout(int rows, int D, int BS,
                                                  int warps) {
  RowsLayout L;
  const int pb = static_cast<int>(sizeof(P));
  L.st = rows_stage_tokens(BS, D, pb);
  L.stage = (2 * L.st * D * pb + (kQuantPages<P> ? 8 * L.st : 0) + 127) /
            128 * 128;
  const int mt = (rows + 15) / 16;
  L.mtp = mt > 4 ? 8 : mt > 2 ? 4 : mt;
  L.ntg = warps / L.mtp;
  // a merge slot: one warp's state, (D/2 sums + m, l of 2 rows) x 32
  // lanes; every warp has one
  L.slot_floats = 32 * (D / 2 + 4);
  // q: mma fragments (16 bytes a lane, k-step and m-tile), or f32 rows
  L.q_bytes = kMma ? L.mtp * (D / 16) * 32 * 16 : L.mtp * 16 * D * 4;
  L.ring = static_cast<size_t>(kRowsStages) * L.stage;
  const size_t merge =
      sizeof(float) * static_cast<size_t>(warps) * L.slot_floats;
  // q follows the ring; the merge slots reuse both once the pages are done
  L.bytes = L.ring + L.q_bytes > merge ? L.ring + L.q_bytes : merge;
  return L;
}

// d += a · b, m16n8k16, bf16 in, f32 accumulators (g = lane / 4, t = lane
// % 4): a[0] = A[g][2t..], a[1] = A[g+8][2t..], a[2] = A[g][2t+8..], a[3]
// = A[g+8][2t+8..]; b0 = B[2t..2t+1][g], b1 = B[2t+8..][g]; d[0..1] =
// D[g][2t..2t+1], d[2..3] = D[g+8][2t..].
__device__ __forceinline__ void mma_bf16_16816(float d[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte j of a word of int8 biased by 0x80808080, as f32: 2^23 + 128 + s
// less 2^23 + 128, exactly
__device__ __forceinline__ float biased_byte_f32(uint32_t biased, int j) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 | j)) -
         8388736.f;
}
// two f32 that hold bf16 values exactly (integers |s| <= 256) as bf16x2,
// lo in the low half: their top halves
__device__ __forceinline__ uint32_t exact_bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
// bytes j of two int8 words (biased) as bf16x2, lo's in the low half
__device__ __forceinline__ uint32_t s8pair_bf16x2(uint32_t lo, uint32_t hi,
                                                  int j) {
  return exact_bf16x2(biased_byte_f32(lo, j), biased_byte_f32(hi, j));
}

// (a, b) as bf16x2 hi plus a bf16x2 lo of what hi leaves (lo's in the low
// halves): a p·v product over hi and lo together carries 16 bits of each
// probability, where hi alone (8) would move a bf16 output by an ulp now
// and then
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  hi = pack_f32(a, b);
  lo = pack_f32(a - __uint_as_float(hi << 16),
                b - __uint_as_float(hi & 0xFFFF0000u));
}

// The B fragments (K^T: k = head dim, n = token) of k-steps 2 grp and
// 2 grp + 1 for one token row: 8 contiguous page values of the group
// (dims 32 grp + 8t ..) -> b[kk][0..1]
__device__ __forceinline__ void k_fragments(const int8_t* p, uint32_t b[2][2]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const uint32_t ws[2] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u};
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    b[kk][0] = exact_bf16x2(biased_byte_f32(ws[kk], 0),
                            biased_byte_f32(ws[kk], 1));
    b[kk][1] = exact_bf16x2(biased_byte_f32(ws[kk], 2),
                            biased_byte_f32(ws[kk], 3));
  }
}
__device__ __forceinline__ void k_fragments(const __nv_bfloat16* p,
                                            uint32_t b[2][2]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  b[0][0] = w.x;
  b[0][1] = w.y;
  b[1][0] = w.z;
  b[1][1] = w.w;
}

// the head-dim permutation of the mma route: k-step ks, thread t -> the
// first of the 4 dims of its k values 2t, 2t + 1, 2t + 8, 2t + 9
__device__ __forceinline__ int perm_dim(int ks, int t) {
  return 32 * (ks / 2) + 8 * t + 4 * (ks % 2);
}

template <typename T, typename P, typename O, int DMAX>
__device__ __forceinline__ void decode_rows_body(
    const T* __restrict__ q, const P* __restrict__ kp,
    const P* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ table,
    const int* __restrict__ bpos, const int* __restrict__ lens,
    const int* __restrict__ qstart, O* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ part, unsigned* __restrict__ tickets, int S, int Hq,
    int Hkv, int D, int BS, int MB, int pages_per_split, int splits,
    float scale, int window, int sink, float softcap) {
  constexpr bool kQ = kQuantPages<P>;
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value &&
                        !std::is_same<P, float>::value;
  constexpr int NJX = DMAX / 8;                // n-tiles of p·v, at most
  extern __shared__ __align__(128) unsigned char rows_smem[];
  unsigned char* smem = rows_smem;
  __shared__ __align__(8) uint64_t full[kRowsStages];
  __shared__ bool last_block;
  const int G = Hq / Hkv, R = S * G;
  const int nthr = blockDim.x, rows_max = nthr / 2;  // 16 rows a warp
  const RowsLayout L =
      rows_layout<P, kMma>(min(R, rows_max), D, BS, nthr / 32);
  const int ST = L.st, NJ = D / 8;
  const int kv_bytes = ST * D * static_cast<int>(sizeof(P));
  unsigned char* qbuf = smem + L.ring;

  const int h = blockIdx.x, b = blockIdx.y;
  const int rg = blockIdx.z / splits, split = blockIdx.z % splits;
  const int r0 = rg * rows_max, rows = min(rows_max, R - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % L.mtp, tq = warp / L.mtp;
  const bool active = mt * 16 < rows;
  const int len = lens[b];
  const int qpos0 = qstart != nullptr ? qstart[b] : len - 1;
  const int* brow = bpos + static_cast<size_t>(b) * MB;
  const int* trow = table + static_cast<size_t>(b) * MB;
  const int j1 = min(MB, (split + 1) * pages_per_split);
  // q's (and out's) offset of group row i (< rows)
  auto q_off = [&](int i) {
    const int r = r0 + i, s = r / G;
    return ((static_cast<size_t>(b) * S + s) * Hq + h * G + r - s * G) * D;
  };

  // the ring, as K7's: (entry, stage of the page) units of this split
  auto first_page = [&](int j) {
    while (j < j1 && brow[j] >= len) ++j;
    return j;
  };
  auto advance = [&](int& j, int& sub) {
    if (++sub * ST >= BS || brow[j] + sub * ST >= len) {
      j = first_page(j + 1);
      sub = 0;
    }
  };
  auto issue = [&](int j, int sub, int stage) {
    const size_t tok0 =
        (static_cast<size_t>(trow[j]) * Hkv + h) * BS + sub * ST;
    unsigned char* st = smem + stage * L.stage;
    mbar_expect_tx(&full[stage], 2 * kv_bytes + (kQ ? 8 * ST : 0));
    bulk_load(st, kp + tok0 * D, kv_bytes, &full[stage]);
    bulk_load(st + kv_bytes, vp + tok0 * D, kv_bytes, &full[stage]);
    if constexpr (kQ) {
      bulk_load(st + 2 * kv_bytes, ks + tok0, 4 * ST, &full[stage]);
      bulk_load(st + 2 * kv_bytes + 4 * ST, vs + tok0, 4 * ST, &full[stage]);
    }
  };
  int j = first_page(split * pages_per_split), sub = 0;
  int ja = j, suba = 0;                        // the next unit to copy
  if (tid == 0) {
    for (int s = 0; s < kRowsStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int s = 0; s < kRowsStages - 1 && ja < j1; ++s) {
    if (tid == 0) issue(ja, suba, s);
    advance(ja, suba);
  }

  // q, staged while the first copies fly
  if constexpr (kMma) {
    uint4* qf = reinterpret_cast<uint4*>(qbuf);   // [mtp][D/16][32 lanes]
    const int nks = D / 16;
    for (int i = tid; i < L.mtp * nks * 32; i += nthr) {
      const int ln = i % 32, kstep = (i / 32) % nks, m = i / (32 * nks);
      const int d0 = perm_dim(kstep, ln & 3);
      uint32_t w[2][2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = m * 16 + (ln >> 2) + 8 * hr;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (row < rows) {
          const T* qr = q + q_off(row) + d0;
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = to_f(qr[e]);
        }
        w[hr][0] = pack_f32(v[0], v[1]);     // bf16 values: exact
        w[hr][1] = pack_f32(v[2], v[3]);
      }
      qf[i] = make_uint4(w[0][0], w[1][0], w[0][1], w[1][1]);
    }
  } else {
    float* qs = reinterpret_cast<float*>(qbuf);  // [mtp * 16][D]
    for (int i = tid; i < L.mtp * 16 * D; i += nthr) {
      const int row = i / D, d = i - row * D;
      qs[i] = row < rows ? to_f(q[q_off(row) + d]) : 0.f;
    }
  }
  __syncthreads();

  // this thread's two rows (g and g + 8 of its m-tile): valid, position
  bool ok[2];
  int qp[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = mt * 16 + g + 8 * hr;
    ok[hr] = row < rows;
    qp[hr] = qpos0 + (r0 + row) / G;
  }
  float acc[NJX][4];
#pragma unroll
  for (int jn = 0; jn < NJX; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jn][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  for (int it = 0; j < j1; ++it) {
    // stage (it - 1) % kRowsStages was freed at the end of the last unit
    if (ja < j1) {
      if (tid == 0) issue(ja, suba, (it + kRowsStages - 1) % kRowsStages);
      advance(ja, suba);
    }
    const int stage = it % kRowsStages;
    mbar_wait(&full[stage], (it / kRowsStages) & 1);
    const unsigned char* st = smem + stage * L.stage;
    const P* kst = reinterpret_cast<const P*>(st);
    const P* vst = reinterpret_cast<const P*>(st + kv_bytes);
    const float* kss = reinterpret_cast<const float*>(st + 2 * kv_bytes);
    const float* vss = kss + ST;
    const int base = brow[j] + sub * ST;

    for (int c = tq; active && c < ST / 16; c += L.ntg) {
      const int tok0 = 16 * c;
      if (base + tok0 >= len) break;           // the chunks past len
      // logits: 16 rows x 16 tokens (n-tiles of tokens 0-7 and 8-15)
      float cs[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) cs[nt][e] = 0.f;
      if constexpr (kMma) {
        const uint4* qf = reinterpret_cast<const uint4*>(qbuf) +
                          mt * (D / 16) * 32 + lane;
        for (int grp = 0; grp < D / 32; ++grp) {
          uint32_t kb[2][2][2];                // [n-tile][kk][b0, b1]
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            k_fragments(kst + static_cast<size_t>(tok0 + 8 * nt + g) * D +
                            32 * grp + 8 * t,
                        kb[nt]);
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const uint4 a4 = qf[(2 * grp + kk) * 32];
            const uint32_t a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
              mma_bf16_16816(cs[nt], a, kb[nt][kk][0], kb[nt][kk][1]);
          }
        }
      } else {
        const float* qs = reinterpret_cast<const float*>(qbuf) +
                          static_cast<size_t>(mt) * 16 * D;
        constexpr int kCE = 16 / static_cast<int>(sizeof(P));
        for (int d0 = 0; d0 < D; d0 += kCE) {
          float kf[2][2][kCE];                 // [n-tile][column pair]
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              chunk_f32(kst + static_cast<size_t>(tok0 + 8 * nt + 2 * t + e) *
                                  D + d0,
                        kf[nt][e]);
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const float* qr = qs + (g + 8 * hr) * D + d0;
#pragma unroll
            for (int i = 0; i < kCE; ++i) {
              const float qv = qr[i];
#pragma unroll
              for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                  cs[nt][2 * hr + e] += qv * kf[nt][e][i];
            }
          }
        }
      }

      // scale, K scale, softcap, masks; the online softmax of each row
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tk = tok0 + 8 * nt + 2 * t + (e & 1), hr = e >> 1;
          const int pos = base + tk;
          float x = cs[nt][e] * scale;
          if constexpr (kQ) x *= kss[tk];
          if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
          const bool keep = ok[hr] && pos < len &&
                            keep_position(pos, qp[hr], window, sink);
          x = keep ? x : kNegInf;
          cs[nt][e] = x;
          mx[hr] = fmaxf(mx[hr], x);
        }
      float p[2][4];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFullMask, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFullMask, mx[hr], 2));
        const float m_new = fmaxf(m_r[hr], mx[hr]);
        const float sub_m = fmaxf(m_new, kClampSub);
        const float alpha = exp2f((m_r[hr] - m_new) * kLog2e);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pe = exp2f((cs[nt][2 * hr + e] - sub_m) * kLog2e);
            sum += pe;
            p[nt][2 * hr + e] =
                kQ ? pe * vss[tok0 + 8 * nt + 2 * t + e] : pe;
          }
        m_r[hr] = m_new;
        l_r[hr] = l_r[hr] * alpha + sum;
#pragma unroll
        for (int jn = 0; jn < NJX; ++jn) {
          acc[jn][2 * hr] *= alpha;
          acc[jn][2 * hr + 1] *= alpha;
        }
      }

      // acc += p · v over the chunk's 16 tokens
      if constexpr (kMma) {
        uint32_t a[4], al[4];                  // p's hi and lo parts
        split_bf16x2(p[0][0], p[0][1], a[0], al[0]);
        split_bf16x2(p[0][2], p[0][3], a[1], al[1]);
        split_bf16x2(p[1][0], p[1][1], a[2], al[2]);
        split_bf16x2(p[1][2], p[1][3], a[3], al[3]);
        const P* v0 = vst + static_cast<size_t>(tok0 + 2 * t) * D + g * NJ;
        const P* v1 = v0 + D;
        const P* v8 = v0 + 8 * static_cast<size_t>(D);
        const P* v9 = v8 + D;
        if constexpr (kQ) {
#pragma unroll
          for (int w = 0; w < NJX / 4; ++w) {
            if (w >= NJ / 4) break;
            const uint32_t x0 = ld32(v0 + 4 * w) ^ 0x80808080u;
            const uint32_t x1 = ld32(v1 + 4 * w) ^ 0x80808080u;
            const uint32_t x8 = ld32(v8 + 4 * w) ^ 0x80808080u;
            const uint32_t x9 = ld32(v9 + 4 * w) ^ 0x80808080u;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const uint32_t b0 = s8pair_bf16x2(x0, x1, i);
              const uint32_t b1 = s8pair_bf16x2(x8, x9, i);
              mma_bf16_16816(acc[4 * w + i], a, b0, b1);
              mma_bf16_16816(acc[4 * w + i], al, b0, b1);
            }
          }
        } else {
#pragma unroll
          for (int w = 0; w < NJX / 2; ++w) {
            if (w >= NJ / 2) break;
            const uint32_t x0 = ld32(v0 + 2 * w), x1 = ld32(v1 + 2 * w);
            const uint32_t x8 = ld32(v8 + 2 * w), x9 = ld32(v9 + 2 * w);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const uint32_t sel = i ? 0x7632 : 0x5410;
              const uint32_t b0 = __byte_perm(x0, x1, sel);
              const uint32_t b1 = __byte_perm(x8, x9, sel);
              mma_bf16_16816(acc[2 * w + i], a, b0, b1);
              mma_bf16_16816(acc[2 * w + i], al, b0, b1);
            }
          }
        }
      } else {
        // every token's p of this thread's rows, from the quad's lanes
        float pr[2][16];
#pragma unroll
        for (int src = 0; src < 4; ++src)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              pr[e >> 1][8 * nt + 2 * src + (e & 1)] = __shfl_sync(
                  kFullMask, p[nt][e], (lane & ~3) | src);
        for (int tk = 0; tk < 16; ++tk) {
          const P* vr = vst + static_cast<size_t>(tok0 + tk) * D + 2 * t * NJ;
#pragma unroll
          for (int jn = 0; jn < NJX; ++jn) {
            if (jn >= NJ) break;
            const float va = to_f(vr[jn]), vb = to_f(vr[NJ + jn]);
            acc[jn][0] += pr[0][tk] * va;
            acc[jn][1] += pr[0][tk] * vb;
            acc[jn][2] += pr[1][tk] * va;
            acc[jn][3] += pr[1][tk] * vb;
          }
        }
      }
    }
    __syncthreads();                           // the stage is free again
    advance(j, sub);
  }

  // every warp's state into its slot (the ring's and q's memory hold the
  // slots now), then all threads merge the warps of each row's m-tile over
  // (row, dim) in warp order; a state that saw no key weighs nothing
  float* slots = reinterpret_cast<float*>(smem);
  {
    float* sl = slots + warp * L.slot_floats + lane;
#pragma unroll
    for (int jn = 0; jn < NJX; ++jn) {
      if (jn >= NJ) break;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sl[(hr * NJ * 2 + 2 * jn + e) * 32] = acc[jn][2 * hr + e];
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      sl[(D / 2 + hr) * 32] = m_r[hr];
      sl[(D / 2 + 2 + hr) * 32] = l_r[hr];
    }
  }
  __syncthreads();
  const int pitch = D + 2;
  const size_t slab = static_cast<size_t>(R) * pitch;
  float* parts = part + (static_cast<size_t>(b) * Hkv + h) * splits * slab;
  for (int i = tid; i < rows * D; i += nthr) {
    const int row = i / D, d = i - row * D;
    const int m = row / 16, gr = row % 8, hr = (row / 8) % 2;
    const int tt = d / NJ / 2, e = d / NJ % 2, jn = d % NJ;
    const float* sl0 = slots + m * L.slot_floats;
    const int a_at = (hr * NJ * 2 + 2 * jn + e) * 32 + 4 * gr + tt;
    const int m_at = (D / 2 + hr) * 32 + 4 * gr;
    const int l_at = (D / 2 + 2 + hr) * 32 + 4 * gr;
    float big = kNegInf;
    for (int w = 0; w < L.ntg; ++w)
      big = fmaxf(big, sl0[w * L.mtp * L.slot_floats + m_at]);
    const float bigc = fmaxf(big, kClampSub);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < L.ntg; ++w) {
      const float* sl = sl0 + w * L.mtp * L.slot_floats;
      const float ew = exp2f((sl[m_at] - bigc) * kLog2e);
      num += sl[a_at] * ew;
      den += ((sl[l_at] + sl[l_at + 1]) + (sl[l_at + 2] + sl[l_at + 3])) * ew;
    }
    if (splits == 1) {
      store_f(out + q_off(row) + d, num / fmaxf(den, 1e-20f));
      if (m_out != nullptr && d == 0) {
        m_out[q_off(row) / D] = big;
        l_out[q_off(row) / D] = den;
      }
    } else {
      // this split's unnormalized (acc, m, l) a row
      float* pr = parts + split * slab + static_cast<size_t>(r0 + row) * pitch;
      pr[d] = num;
      if (d == 0) {
        pr[D] = big;
        pr[D + 1] = den;
      }
    }
  }
  if (splits == 1) return;
  // the last split of the (lane, head, row group) to arrive merges the
  // splits in order
  __threadfence();
  __syncthreads();
  const int groups = gridDim.z / splits;
  unsigned* ticket = tickets + (static_cast<size_t>(b) * Hkv + h) * groups +
                     rg;
  if (tid == 0) last_block = atomicAdd(ticket, 1u) == splits - 1u;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int i = tid; i < rows * D; i += nthr) {
    const int row = i / D, d = i - row * D;
    const float* pr = parts + static_cast<size_t>(r0 + row) * pitch;
    float big = kNegInf;
    for (int z = 0; z < splits; ++z)
      big = fmaxf(big, __ldcg(pr + z * slab + D));
    const float bigc = fmaxf(big, kClampSub);
    float num = 0.f, den = 0.f;
    for (int z = 0; z < splits; ++z) {
      const float e = exp2f((__ldcg(pr + z * slab + D) - bigc) * kLog2e);
      num += __ldcg(pr + z * slab + d) * e;
      den += __ldcg(pr + z * slab + D + 1) * e;
    }
    store_f(out + q_off(row) + d, num / fmaxf(den, 1e-20f));
    if (m_out != nullptr && d == 0) {
      m_out[q_off(row) / D] = big;
      l_out[q_off(row) / D] = den;
    }
  }
  if (tid == 0) *ticket = 0u;                  // ready for the next launch
}

template <typename T, typename P, int DMAX>
__global__ void __launch_bounds__(kRowsMaxThreads, 1)
    verify_rows_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                       const P* __restrict__ vp, const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ table,
                       const int* __restrict__ bpos,
                       const int* __restrict__ lens,
                       const int* __restrict__ qstart, T* __restrict__ out,
                       float* __restrict__ part,
                       unsigned* __restrict__ tickets, int S, int Hq, int Hkv,
                       int D, int BS, int MB, int pages_per_split, int splits,
                       float scale, int window, int sink, float softcap) {
  decode_rows_body<T, P, T, DMAX>(q, kp, vp, ks, vs, table, bpos, lens,
                                  qstart, out, nullptr, nullptr, part,
                                  tickets, S, Hq, Hkv, D, BS, MB,
                                  pages_per_split, splits, scale, window,
                                  sink, softcap);
}

template <typename T, typename P, int DMAX>
__global__ void __launch_bounds__(kRowsMaxThreads, 1)
    stats_rows_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                      const P* __restrict__ vp, const float* __restrict__ ks,
                      const float* __restrict__ vs,
                      const int* __restrict__ table,
                      const int* __restrict__ bpos,
                      const int* __restrict__ lens, float* __restrict__ out,
                      float* __restrict__ m_out, float* __restrict__ l_out,
                      float* __restrict__ part,
                      unsigned* __restrict__ tickets, int Hq, int Hkv, int D,
                      int BS, int MB, int pages_per_split, int splits,
                      float scale, int window, int sink, float softcap) {
  decode_rows_body<T, P, float, DMAX>(q, kp, vp, ks, vs, table, bpos, lens,
                                      nullptr, out, m_out, l_out, part,
                                      tickets, 1, Hq, Hkv, D, BS, MB,
                                      pages_per_split, splits, scale, window,
                                      sink, softcap);
}

// ---------------------------------------------------------------------------
// K8's f32 route (f32 q or f32 pages, the f32 test models): one block of
// 128 threads per (query tile of kTileQ tokens, query head hq, lane b),
// f32 arithmetic on CUDA cores. Rows past C are padding and are not
// written; rows past the prompt are computed (don't-care, finite).
// ---------------------------------------------------------------------------
template <typename T, typename P>
__global__ void prefill_kernel(const T* __restrict__ q,
                               const P* __restrict__ kp,
                               const P* __restrict__ vp,
                               const float* __restrict__ ks,
                               const float* __restrict__ vs,
                               const int* __restrict__ table,
                               const int* __restrict__ bpos,
                               const int* __restrict__ qstart,
                               const int* __restrict__ lens,
                               T* __restrict__ out, int C, int Hq, int Hkv,
                               int D, int BS, int MB, float scale, int window,
                               int sink, float softcap) {
  __shared__ __align__(16) float qs[kTileQ][kMaxD];
  __shared__ float ps[kTileQ][kMaxBS];
  __shared__ float m_s[kTileQ], l_s[kTileQ], a_s[kTileQ];

  const int tile0 = blockIdx.x * kTileQ, hq = blockIdx.y, b = blockIdx.z;
  const int h = hq / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = min(kTileQ, C - tile0);

  for (int i = tid; i < kTileQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    qs[r][d] = r < rows
        ? to_f(q[((static_cast<size_t>(b) * C + tile0 + r) * Hq + hq) * D + d])
              * scale
        : 0.f;
  }
  if (tid < kTileQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxD / kThreads][kTileQ];
#pragma unroll
  for (int di = 0; di < kMaxD / kThreads; ++di)
#pragma unroll
    for (int r = 0; r < kTileQ; ++r) acc[di][r] = 0.f;
  __syncthreads();

  const int len = lens[b];
  const int q0 = qstart[b] + tile0;            // absolute position of row 0
  const int q_last = q0 + rows - 1;
  for (int j = 0; j < MB; ++j) {
    const int base = bpos[b * MB + j];
    // pages past the tile's last position, or past the written length,
    // contribute nothing (paged_attention.py:331); uniform across the block
    if (base > q_last || base >= len) continue;
    const size_t prow = static_cast<size_t>(table[b * MB + j]) * Hkv + h;
    const P* kpage = kp + prow * BS * D;
    const P* vpage = vp + prow * BS * D;
    const float* kscale = ks + (kQuantPages<P> ? prow * BS : 0);
    const float* vscale = vs + (kQuantPages<P> ? prow * BS : 0);

    // logits: one thread per page token, all kTileQ rows, 16 values of K
    // at a time against float4 reads of the q tile
    for (int t = tid; t < BS; t += kThreads) {
      float s[kTileQ];
#pragma unroll
      for (int r = 0; r < kTileQ; ++r) s[r] = 0.f;
      const P* krow = kpage + static_cast<size_t>(t) * D;
      for (int d0 = 0; d0 < D; d0 += 16) {
        float kf[16];
        load16(krow + d0, kf);
#pragma unroll
        for (int r = 0; r < kTileQ; ++r) {
          const float4* qv = reinterpret_cast<const float4*>(&qs[r][d0]);
#pragma unroll
          for (int i4 = 0; i4 < 4; ++i4) {
            const float4 qq = qv[i4];
            s[r] += qq.x * kf[4 * i4] + qq.y * kf[4 * i4 + 1] +
                    qq.z * kf[4 * i4 + 2] + qq.w * kf[4 * i4 + 3];
          }
        }
      }
      const int pos = base + t;
      float kst = 1.f;
      if constexpr (kQuantPages<P>) kst = kscale[t];
#pragma unroll
      for (int r = 0; r < kTileQ; ++r) {
        float v = s[r];
        if constexpr (kQuantPages<P>) v *= kst;
        if (softcap != 0.f) v = tanhf(v / softcap) * softcap;
        const bool keep = pos < len && keep_position(pos, q0 + r, window, sink);
        ps[r][t] = keep ? v : kNegInf;
      }
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < kTileQ; r += kWarpsPerBlock) {
      float mx = kNegInf;
      for (int t = lane; t < BS; t += 32) mx = fmaxf(mx, ps[r][t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float sub = fmaxf(m_new, kClampSub);
      float sum = 0.f;
      for (int t = lane; t < BS; t += 32) {
        const float p = expf(ps[r][t] - sub);
        sum += p;
        if constexpr (kQuantPages<P>)
          ps[r][t] = p * vscale[t];
        else
          ps[r][t] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v: thread owns head_dim columns d, all rows
#pragma unroll
    for (int di = 0; di < kMaxD / kThreads; ++di) {
      const int d = tid + di * kThreads;
      if (d >= D) continue;
#pragma unroll
      for (int r = 0; r < kTileQ; ++r) acc[di][r] *= a_s[r];
      for (int t = 0; t < BS; ++t) {
        const float vf = to_f(vpage[static_cast<size_t>(t) * D + d]);
#pragma unroll
        for (int r = 0; r < kTileQ; ++r) acc[di][r] += ps[r][t] * vf;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int di = 0; di < kMaxD / kThreads; ++di) {
    const int d = tid + di * kThreads;
    if (d >= D) continue;
    for (int r = 0; r < rows; ++r)
      store_f(out + ((static_cast<size_t>(b) * C + tile0 + r) * Hq + hq) * D + d,
              acc[di][r] / fmaxf(l_s[r], 1e-20f));
  }
}

// ---------------------------------------------------------------------------
// K8: prefill_wgmma_kernel, the chunked prefill on tensor cores (bf16 q,
// int8 or bf16 pages). FlashAttention-3's shape as in K14
// (flash_attention.cu), with the page walk added.
//   - Block: 128 query rows of one (lane b, kv head h, query tile): the G
//     query heads' rows of TQ = 128 / G tokens, head-major as in the JAX
//     kernel (row r = gl * TQ + i: query head hgi * GB + gl of the kv
//     head, token tile * TQ + i; G > 128 splits the heads over HG groups
//     of GB). Each page is read once per (kv head, tile), not once per
//     query head. Two consumer warpgroups own 64 rows each; a producer
//     warpgroup brings and converts the pages; setmaxnreg moves registers
//     to the consumers.
//   - Page walk: the lane's table entries whose base (block_pos) is at most
//     the tile's last position and below len (paged_attention.py:331),
//     cut into 16-token granules (only those below min(len, last + 1));
//     kBK / 16 granules make a unit of kBK keys (64; 32 at D > 128), from
//     one page or several. One thread of the producer warpgroup copies a
//     unit's K, V (and int8 scales) into a 2-stage raw ring with 1-D bulk
//     copies (a (page, head) slab is contiguous; 3-4 stages measured no
//     faster) and writes each slot's absolute position (empty slots:
//     INT_MAX, masked).
//   - The producer warpgroup converts a raw unit into the wgmma layout of a
//     second 2-stage ring: bf16 keys x head dim in 64-column boxes with the
//     128-byte swizzle (int8 pages to bf16 exactly; bf16 pages moved as
//     they are), zeros in empty slots. The consumers' K-major descriptor
//     reads it for q·kᵀ, the MN-major one for p·v, as K14 reads its TMA
//     tiles. The conversion runs beside the consumers' products.
//   - Consumers: s = q·kᵀ on wgmma m64n{kBK}k16 (both operands in shared
//     memory; q staged once, swizzled), times scale and the K scale of each
//     key; softcap; the masks by absolute position (causal, window, sink,
//     pos < len); the online softmax in f32 with kClampSub; the V scale on
//     the probabilities, which stay in registers as bf16 hi and lo parts
//     (16 bits of each: bf16 alone moves a bf16 output by an ulp now and
//     then) for p·v on wgmma m64n{DP}k16, twice (DP: the head dim rounded
//     up to 64, 128 or 256). O stays in f32 registers; rows past C are not
//     written.
// Bound on the H100: the pages (read once per tile and kv head) against
// 4 * Hq * D * (query, key) pairs of bf16 FLOP.
// ---------------------------------------------------------------------------
constexpr int kPfRows = 128;               // query rows a block
constexpr int kPfConsumers = 256;
constexpr int kPfThreads = kPfConsumers + 128;
// registers a thread after setmaxnreg: 2 x 128 x 216 + 128 x 72 <= 64 K;
// the producer's table walk and conversion spilled at 40 and 56
constexpr int kPfConsumerRegs = 216;
constexpr int kPfProducerRegs = 72;
constexpr int kPfStages = 2;               // each ring's

template <int DP>
struct PfCfg {
  static constexpr int kBK = DP > 128 ? 32 : 64;   // keys a unit
  static constexpr int kGran = kBK / 16;            // granules a unit
  static constexpr int kQBytes = kPfRows * DP * 2;
  static constexpr int kTile = kBK * DP * 2;        // a converted K or V tile
};

// bytes of a raw unit: kBK slots of K and V (and, int8, two scales)
__host__ __device__ inline int pf_raw_bytes(int bk, int D, int pb,
                                            bool quant) {
  return (2 * bk * D * pb + (quant ? 8 * bk : 0) + 127) / 128 * 128;
}

template <int DP>
inline size_t pf_smem(int D, int pb, bool quant) {
  using Cfg = PfCfg<DP>;
  return 1024 + static_cast<size_t>(Cfg::kQBytes) +
         2 * kPfStages * static_cast<size_t>(Cfg::kTile) +
         kPfStages * static_cast<size_t>(pf_raw_bytes(Cfg::kBK, D, pb, quant));
}

// 8 page values (row-major, 8 or 16 bytes) as 8 bf16 (16 bytes)
__device__ __forceinline__ uint4 bf16x8(const int8_t* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const uint32_t a = w.x ^ 0x80808080u, b = w.y ^ 0x80808080u;
  return make_uint4(
      exact_bf16x2(biased_byte_f32(a, 0), biased_byte_f32(a, 1)),
      exact_bf16x2(biased_byte_f32(a, 2), biased_byte_f32(a, 3)),
      exact_bf16x2(biased_byte_f32(b, 0), biased_byte_f32(b, 1)),
      exact_bf16x2(biased_byte_f32(b, 2), biased_byte_f32(b, 3)));
}
__device__ __forceinline__ uint4 bf16x8(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <int BK>
__device__ __forceinline__ void pf_wgmma_ss(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
  if constexpr (BK == 32) wgmma_ss_n32(d, da, db, scale_d);
  else wgmma_ss_n64(d, da, db, scale_d);
}
template <int DP>
__device__ __forceinline__ void pf_wgmma_rs(float* d, const uint32_t* a,
                                            uint64_t db) {
  if constexpr (DP == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (DP == 128) wgmma_rs_n128<1>(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// Accumulator layout of wgmma m64nN (a thread of a warpgroup; w = warp in
// the warpgroup, g = lane / 4, t = lane % 4): element 4j + e is row
// w·16 + g + 8·(e >> 1), column 8j + 2t + (e & 1).
template <typename P, int DP>
__global__ void __launch_bounds__(kPfThreads, 1)
    prefill_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                         const P* __restrict__ kp, const P* __restrict__ vp,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const int* __restrict__ table,
                         const int* __restrict__ bpos,
                         const int* __restrict__ qstart,
                         const int* __restrict__ lens,
                         __nv_bfloat16* __restrict__ out, int C, int Hq,
                         int Hkv, int D, int BS, int MB, float scale,
                         int window, int sink, float softcap, int TQ, int GB,
                         int HG) {
  using Cfg = PfCfg<DP>;
  constexpr int BK = Cfg::kBK;
  constexpr int NS = BK / 2;             // logits registers a thread
  constexpr int NO = DP / 2;             // output registers a thread
  constexpr bool kQ = kQuantPages<P>;
  constexpr int pb = static_cast<int>(sizeof(P));
  extern __shared__ unsigned char pf_smem_raw[];
  __shared__ __align__(8) uint64_t raw_full[kPfStages], cvt_full[kPfStages],
      cvt_empty[kPfStages];
  __shared__ int raw_pos[kPfStages][BK], raw_n[kPfStages];
  __shared__ int cvt_pos[kPfStages][BK];
  __shared__ float cvt_ks[kPfStages][BK], cvt_vs[kPfStages][BK];
  __shared__ int n_units_s;
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(pf_smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;
  unsigned char* cvt = qs + Cfg::kQBytes;      // stage s: K, V tiles
  unsigned char* raw = cvt + 2 * kPfStages * Cfg::kTile;
  const int raw_bytes = pf_raw_bytes(BK, D, pb, kQ);

  const int G = Hq / Hkv;
  const int n_tiles = gridDim.x / HG;
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / HG;
  const int hgi = blockIdx.x % HG;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int len = lens[b], q0 = qstart[b];
  const int tok_first = tile * TQ, ntok = min(TQ, C - tok_first);
  // keys at positions below vis_end: below len and at most the tile's last
  const int vis_end = min(len, q0 + tok_first + ntok);
  const int* brow = bpos + static_cast<size_t>(b) * MB;
  const int* trow = table + static_cast<size_t>(b) * MB;
  // granules (16 tokens) of table entry j that a row of the tile may see
  auto granules = [&](int base) {
    return base < vis_end ? (min(BS, vis_end - base) + 15) / 16 : 0;
  };

  if (tid == kPfConsumers) {
    for (int s = 0; s < kPfStages; ++s) {
      mbar_init(&raw_full[s], 1);
      mbar_init(&cvt_full[s], 4);              // lane 0 of each producer warp
      mbar_init(&cvt_empty[s], kPfConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid / 32 == kPfConsumers / 32) {         // the walk's warp: granules
    int total = 0;
    for (int j = tid - kPfConsumers; j < MB; j += 32)
      total += granules(brow[j]);
    total = __reduce_add_sync(kFullMask, total);
    if (tid == kPfConsumers) n_units_s = (total + Cfg::kGran - 1) / Cfg::kGran;
  }
  __syncthreads();
  const int n_units = n_units_s;

  if (tid >= kPfConsumers) {                   // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kPfProducerRegs));
    const int ptid = tid - kPfConsumers, lane = tid & 31;
    // The walk (warp 0 of the producer warpgroup, all lanes): lane i holds
    // table entry jb + i of the batch of 32 the cursor (cj, cg) is in (its
    // granules and first pool row), read once for the batch; the unit's
    // runs come from shuffles.
    int cj = 0, cg = 0, jb = -32, my_ng = 0, my_row = 0, my_base = 0;
    auto entry = [&](int j, int& ng, int& row, int& base) {
      if (j < jb || j >= jb + 32) {            // another batch
        jb = j & ~31;
        const int e = jb + lane;
        my_base = e < MB ? brow[e] : INT_MAX;
        my_ng = e < MB ? granules(my_base) : 0;
        my_row = e < MB ? trow[e] : 0;
      }
      ng = __shfl_sync(kFullMask, my_ng, j - jb);
      row = __shfl_sync(kFullMask, my_row, j - jb);
      base = __shfl_sync(kFullMask, my_base, j - jb);
    };
    // the next unit into raw stage s: its slots' positions first (the
    // arrive publishes them), then the copies: a run of granules of one
    // page is one copy each of K, V (and the scales), issued by lane 0
    auto issue = [&](int s) {
      int n = 0, j = cj, c = cg;
      while (n < Cfg::kGran && j < MB) {
        int ng, row, base;
        entry(j, ng, row, base);
        if (c >= ng) {
          ++j;
          c = 0;
          continue;
        }
        const int take = min(Cfg::kGran - n, ng - c);
        for (int i = lane; i < 16 * take; i += 32)
          raw_pos[s][16 * n + i] = base + 16 * c + i;
        n += take;
        c += take;
      }
      for (int i = 16 * n + lane; i < BK; i += 32) raw_pos[s][i] = INT_MAX;
      __syncwarp();
      unsigned char* st = raw + s * raw_bytes;
      if (lane == 0) {
        raw_n[s] = n;
        mbar_expect_tx(&raw_full[s], 16 * n * (2 * D * pb + (kQ ? 8 : 0)));
      }
      for (int done = 0; done < n;) {
        int ng, row, base;
        entry(cj, ng, row, base);
        if (cg >= ng) {
          ++cj;
          cg = 0;
          continue;
        }
        const int take = min(n - done, ng - cg);
        if (lane == 0) {
          const size_t tok =
              (static_cast<size_t>(row) * Hkv + h) * BS + 16 * cg;
          const int slot = 16 * done;
          const unsigned kvb = 16 * take * D * pb;
          bulk_load(st + slot * D * pb, kp + tok * D, kvb, &raw_full[s]);
          bulk_load(st + (BK + slot) * D * pb, vp + tok * D, kvb,
                    &raw_full[s]);
          if constexpr (kQ) {
            bulk_load(st + 2 * BK * D + 4 * slot, ks + tok, 64 * take,
                      &raw_full[s]);
            bulk_load(st + 2 * BK * D + 4 * (BK + slot), vs + tok, 64 * take,
                      &raw_full[s]);
          }
        }
        done += take;
        cg += take;
      }
    };
    const bool walker = ptid < 32;
    if (walker && n_units > 0) issue(0);
    for (int u = 0; u < n_units; ++u) {
      const int s = u % kPfStages;
      const unsigned ph = (u / kPfStages) & 1;
      // raw stage (u + 1) % 2 was last read while converting unit u - 1
      if (walker && u + 1 < n_units) issue((u + 1) % kPfStages);
      mbar_wait(&raw_full[s], ph);
      mbar_wait(&cvt_empty[s], ph ^ 1);
      const unsigned char* st = raw + s * raw_bytes;
      const P* rk = reinterpret_cast<const P*>(st);
      const P* rv = reinterpret_cast<const P*>(st + BK * D * pb);
      const float* rks = reinterpret_cast<const float*>(st + 2 * BK * D * pb);
      unsigned char* ck = cvt + 2 * s * Cfg::kTile;
      unsigned char* cv = ck + Cfg::kTile;
      const int filled = 16 * raw_n[s], nc = D / 8;
      for (int i = ptid; i < BK * nc; i += 128) {
        const int k = i / nc, c = i - k * nc;
        const int dst = (c / 8) * BK * 128 + k * 128 + (((c % 8) ^ (k % 8)) << 4);
        uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
        if (k < filled) {
          kv = bf16x8(rk + k * D + 8 * c);
          vv = bf16x8(rv + k * D + 8 * c);
        }
        *reinterpret_cast<uint4*>(ck + dst) = kv;
        *reinterpret_cast<uint4*>(cv + dst) = vv;
      }
      for (int k = ptid; k < BK; k += 128) {
        cvt_pos[s][k] = raw_pos[s][k];
        if constexpr (kQ) {
          cvt_ks[s][k] = k < filled ? rks[k] : 0.f;
          cvt_vs[s][k] = k < filled ? rks[BK + k] : 0.f;
        }
      }
      fence_proxy_async();                     // the tiles, for wgmma
      __syncwarp();
      if (lane == 0) mbar_arrive(&cvt_full[s]);
      named_sync(2, 128);                      // raw stage s is free
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kPfConsumerRegs));
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // q's rows, swizzled as a 128-byte-swizzle TMA box would lay them out
  for (int i = tid; i < kPfRows * (DP / 8); i += kPfConsumers) {
    const int r = i / (DP / 8), c = i % (DP / 8);
    const int gl = r / TQ, ti = r - gl * TQ, gq = hgi * GB + gl;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gl < GB && gq < G && ti < ntok && 8 * c < D)
      v = *reinterpret_cast<const uint4*>(
          q + ((static_cast<size_t>(b) * C + tok_first + ti) * Hq + h * G +
               gq) * D + 8 * c);
    *reinterpret_cast<uint4*>(qs + (c / 8) * kPfRows * 128 + r * 128 +
                              (((c % 8) ^ (r % 8)) << 4)) = v;
  }
  fence_proxy_async();
  named_sync(1, kPfConsumers);

  // this thread's rows (g and g + 8 of its warp's 16): valid, position
  bool ok[2];
  int qp[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = wg * 64 + warp * 16 + g + 8 * hr;
    const int gl = r / TQ, ti = r - gl * TQ;
    ok[hr] = gl < GB && hgi * GB + gl < G && ti < ntok;
    qp[hr] = q0 + tok_first + ti;
  }
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const uint32_t q_addr = smem_u32(qs) + wg * 64 * 128;
  const int nk = D / 16;

  for (int u = 0; u < n_units; ++u) {
    const int s = u % kPfStages;
    mbar_wait(&cvt_full[s], (u / kPfStages) & 1);
    const uint32_t k_addr = smem_u32(cvt + 2 * s * Cfg::kTile);
    const uint32_t v_addr = k_addr + Cfg::kTile;

    // logits = q · kᵀ: 64 rows x BK keys
    float sc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    fence_regs<NS>(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      if (kk >= nk) break;
      const uint32_t col = (kk % 4) * 32;      // bytes into the box row
      pf_wgmma_ss<BK>(sc,
                      sw128_desc(q_addr + (kk / 4) * kPfRows * 128 + col, 16,
                                 1024),
                      sw128_desc(k_addr + (kk / 4) * BK * 128 + col, 16,
                                 1024),
                      kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs<NS>(sc);

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int jn = 0; jn < BK / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int slot = jn * 8 + 2 * t + (e & 1), hr = e >> 1;
        const int pos = cvt_pos[s][slot];
        float x = sc[4 * jn + e] * scale;
        if constexpr (kQ) x *= cvt_ks[s][slot];
        if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
        const bool keep = ok[hr] && pos < len &&
                          keep_position(pos, qp[hr], window, sink);
        x = keep ? x : kNegInf;
        sc[4 * jn + e] = x;
        mx[hr] = fmaxf(mx[hr], x);
      }
    float al[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFullMask, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFullMask, mx[hr], 2));
      const float m_new = fmaxf(m_r[hr], mx[hr]);
      al[hr] = exp2f((m_r[hr] - m_new) * kLog2e);
      m_r[hr] = m_new;
    }
    const float sub[2] = {fmaxf(m_r[0], kClampSub), fmaxf(m_r[1], kClampSub)};
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int jn = 0; jn < BK / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const float p = exp2f((sc[4 * jn + e] - sub[hr]) * kLog2e);
        sum[hr] += p;
        if constexpr (kQ) sc[4 * jn + e] = p * cvt_vs[s][jn * 8 + 2 * t + (e & 1)];
        else sc[4 * jn + e] = p;
      }
    l_r[0] = l_r[0] * al[0] + sum[0];
    l_r[1] = l_r[1] * al[1] + sum[1];
#pragma unroll
    for (int i = 0; i < NO; i += 4) {
      o[i] *= al[0];
      o[i + 1] *= al[0];
      o[i + 2] *= al[1];
      o[i + 3] *= al[1];
    }
    uint32_t pa[BK / 16][4], pl[BK / 16][4];  // p's hi and lo parts
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_bf16x2(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1], pa[kk][i],
                     pl[kk][i]);

    // o += (p · v scale) · v over hi and lo: v (keys x DP) an MN-major B
    fence_regs<NO>(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = sw128_desc(v_addr + kk * 16 * 128, BK * 128, 1024);
      pf_wgmma_rs<DP>(o, pa[kk], dv);
      pf_wgmma_rs<DP>(o, pl[kk], dv);
    }
    wg_commit();
    wg_wait_all();
    fence_regs<NO>(o);
    if (lane == 0) mbar_arrive(&cvt_empty[s]);  // this warp is done with s
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l_r[hr] += __shfl_xor_sync(kFullMask, l_r[hr], 1);
    l_r[hr] += __shfl_xor_sync(kFullMask, l_r[hr], 2);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (!ok[hr]) continue;
    const int r = wg * 64 + warp * 16 + g + 8 * hr;
    const int gl = r / TQ, ti = r - gl * TQ;
    __nv_bfloat16* orow =
        out + ((static_cast<size_t>(b) * C + tok_first + ti) * Hq + h * G +
               hgi * GB + gl) * D;
    const float den = fmaxf(l_r[hr], 1e-20f);
#pragma unroll
    for (int jn = 0; jn < DP / 8; ++jn) {
      const int col = jn * 8 + 2 * t;
      if (col >= D) break;
      *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
          o[4 * jn + 2 * hr] / den, o[4 * jn + 2 * hr + 1] / den);
    }
  }
}

template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T, typename P>
int launch_decode_split(const void* q, const void* kp, const void* vp,
                        const void* ks, const void* vs, const void* table,
                        const void* bpos, const void* lens, void* out,
                        void* part, void* tickets, int B, int Hq, int Hkv,
                        int D, int BS, int MB, int splits, int range_pages,
                        int splits_per_range, int pages_per_split,
                        float scale, int window, int sink, float softcap,
                        int merge_drop, cudaStream_t st) {
  if (splits < 1 || pages_per_split < 1 || splits_per_range < 1 ||
      splits % splits_per_range ||
      static_cast<long long>(splits_per_range) * pages_per_split <
          range_pages ||
      static_cast<long long>(splits / splits_per_range) * range_pages < MB ||
      (splits > 1 && (!part || !tickets)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = split_layout<P>(Hq / Hkv, D, BS).bytes;
  auto kernel = Hq == Hkv ? decode_split_kernel<T, P, 1>
                          : decode_split_kernel<T, P, 8>;
  if (int e = allow_smem(kernel, smem)) return e;
  kernel<<<dim3(Hkv, B, splits), kSplitThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const P*>(kp),
      static_cast<const P*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(bpos), static_cast<const int*>(lens),
      static_cast<T*>(out), static_cast<float*>(part),
      static_cast<unsigned*>(tickets), Hq, Hkv, D, BS, MB, range_pages,
      splits_per_range, pages_per_split, scale, window, sink, softcap,
      merge_drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P, int DMAX>
int launch_rows_d(const void* q, const void* kp, const void* vp,
                  const void* ks, const void* vs, const void* table,
                  const void* bpos, const void* lens, const void* qstart,
                  void* out, void* m, void* l, void* part, void* tickets,
                  dim3 grid, size_t smem, int S, int Hq, int Hkv, int D,
                  int BS, int MB, int pps, int splits, int warps,
                  float scale, int window, int sink, float softcap,
                  cudaStream_t st) {
  const auto* kq = static_cast<const T*>(q);
  const auto* kk = static_cast<const P*>(kp);
  const auto* kv = static_cast<const P*>(vp);
  const auto* fks = static_cast<const float*>(ks);
  const auto* fvs = static_cast<const float*>(vs);
  const auto* it = static_cast<const int*>(table);
  const auto* ib = static_cast<const int*>(bpos);
  const auto* il = static_cast<const int*>(lens);
  auto* fp = static_cast<float*>(part);
  auto* tk = static_cast<unsigned*>(tickets);
  if (m == nullptr) {                          // K9
    auto kernel = verify_rows_kernel<T, P, DMAX>;
    if (int e = allow_smem(kernel, smem)) return e;
    kernel<<<grid, 32 * warps, smem, st>>>(
        kq, kk, kv, fks, fvs, it, ib, il, static_cast<const int*>(qstart),
        static_cast<T*>(out), fp, tk, S, Hq, Hkv, D, BS, MB, pps, splits,
        scale, window, sink, softcap);
  } else {                                     // K10
    auto kernel = stats_rows_kernel<T, P, DMAX>;
    if (int e = allow_smem(kernel, smem)) return e;
    kernel<<<grid, 32 * warps, smem, st>>>(
        kq, kk, kv, fks, fvs, it, ib, il, static_cast<float*>(out),
        static_cast<float*>(m), static_cast<float*>(l), fp, tk, Hq, Hkv, D,
        BS, MB, pps, splits, scale, window, sink, softcap);
  }
  return static_cast<int>(cudaGetLastError());
}

// K9 (m == nullptr) or K10 over `groups` row groups x `splits` splits of
// pages_per_split table entries (ops/paged_attention.py rows_plan)
template <typename T, typename P>
int launch_rows(const void* q, const void* kp, const void* vp,
                const void* ks, const void* vs, const void* table,
                const void* bpos, const void* lens, const void* qstart,
                void* out, void* m, void* l, void* part, void* tickets,
                int B, int S, int Hq, int Hkv, int D, int BS, int MB,
                int groups, int splits, int pps, int warps, float scale,
                int window, int sink, float softcap, cudaStream_t st) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value &&
                        !std::is_same<P, float>::value;
  const int R = S * (Hq / Hkv);
  if (splits < 1 || pps < 1 || static_cast<long long>(splits) * pps < MB ||
      (warps != 4 && warps != 8) || groups != (R + 16 * warps - 1) /
                                                  (16 * warps) ||
      (splits > 1 && (!part || !tickets)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      rows_layout<P, kMma>(std::min(R, 16 * warps), D, BS, warps).bytes;
  const dim3 grid(Hkv, B, groups * splits);
#define MIXQ_ROWS(DMAX)                                                     \
  launch_rows_d<T, P, DMAX>(q, kp, vp, ks, vs, table, bpos, lens, qstart,   \
                            out, m, l, part, tickets, grid, smem, S, Hq,    \
                            Hkv, D, BS, MB, pps, splits, warps, scale,      \
                            window, sink, softcap, st)
  if constexpr (kMma) {
    if (D <= 64) return MIXQ_ROWS(64);
    if (D <= 128) return MIXQ_ROWS(128);
  }
  return MIXQ_ROWS(256);
#undef MIXQ_ROWS
}

template <typename P, int DP>
int launch_prefill_wgmma(const void* q, const void* kp, const void* vp,
                         const void* ks, const void* vs, const void* table,
                         const void* bpos, const void* qstart,
                         const void* lens, void* out, int B, int C, int Hq,
                         int Hkv, int D, int BS, int MB, float scale,
                         int window, int sink, float softcap,
                         cudaStream_t st) {
  const int G = Hq / Hkv;
  const int HG = (G + kPfRows - 1) / kPfRows, GB = (G + HG - 1) / HG;
  const int TQ = kPfRows / GB, n_tiles = (C + TQ - 1) / TQ;
  const size_t smem = pf_smem<DP>(D, sizeof(P), kQuantPages<P>);
  auto kernel = prefill_wgmma_kernel<P, DP>;
  const cudaError_t a = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (a != cudaSuccess) return static_cast<int>(a);
  kernel<<<dim3(n_tiles * HG, Hkv, B), kPfThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const P*>(kp),
      static_cast<const P*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(bpos), static_cast<const int*>(qstart),
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(out), C, Hq,
      Hkv, D, BS, MB, scale, window, sink, softcap, TQ, GB, HG);
  return static_cast<int>(cudaGetLastError());
}

// K8: bf16 q on int8 or bf16 pages on tensor cores (prefill_wgmma_kernel),
// f32 q or f32 pages on CUDA cores (prefill_kernel)
template <typename T, typename P>
int launch_prefill(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* table,
                   const void* bpos, const void* qstart, const void* lens,
                   void* out, int B, int C, int Hq, int Hkv, int D, int BS,
                   int MB, float scale, int window, int sink, float softcap,
                   cudaStream_t st) {
  if (B < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (std::is_same<T, __nv_bfloat16>::value &&
                !std::is_same<P, float>::value) {
#define MIXQ_PF(DP)                                                         \
  launch_prefill_wgmma<P, DP>(q, kp, vp, ks, vs, table, bpos, qstart, lens, \
                              out, B, C, Hq, Hkv, D, BS, MB, scale, window, \
                              sink, softcap, st)
    if (D <= 64) return MIXQ_PF(64);
    if (D <= 128) return MIXQ_PF(128);
    return MIXQ_PF(256);
#undef MIXQ_PF
  } else {
    dim3 grid((C + kTileQ - 1) / kTileQ, Hq, B);
    prefill_kernel<T, P><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(q), static_cast<const P*>(kp),
        static_cast<const P*>(vp), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(table),
        static_cast<const int*>(bpos), static_cast<const int*>(qstart),
        static_cast<const int*>(lens), static_cast<T*>(out), C, Hq, Hkv, D,
        BS, MB, scale, window, sink, softcap);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace mixq

using namespace mixq;

extern "C" const char* mixq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K7 and K11: q/out (B, Hq, D) of `dtype`; pages (NP, Hkv, BS, D) of
// `page_dtype`: int8 with scales (NP, Hkv, BS) f32, or bf16/f32 with null
// scales; table/bpos (B, MB) int32; lens (B,) int32. Each lane's MB
// entries fall into ranges of range_pages entries, each cut into
// splits_per_range splits of pages_per_split, `splits` in all
// (ops/paged_attention.py decode_plan for K7: one range;
// split_decode_plan for K11: kv_splits ranges); with splits > 1, part
// holds B x Hkv x splits x (Hq/Hkv) x (D + 2) f32 partials and tickets B x
// Hkv zeroed counters, which the kernel leaves zeroed. merge_drop: 0, or 1
// for the negative controls' fault (the last split that saw a key left
// out).
extern "C" int mixq_paged_decode_attention(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* table, const void* bpos, const void* lens,
    void* out, void* part, void* tickets, int B, int Hq, int Hkv, int D,
    int BS, int MB, int splits, int range_pages, int splits_per_range,
    int pages_per_split, float scale, int window, int sink, float softcap,
    int merge_drop, int dtype, int page_dtype, void* stream) {
  return with_page_types(dtype, page_dtype, [&](auto t, auto p) {
    return launch_decode_split<typename decltype(t)::type,
                               typename decltype(p)::type>(
        q, kp, vp, ks, vs, table, bpos, lens, out, part, tickets, B, Hq, Hkv,
        D, BS, MB, splits, range_pages, splits_per_range, pages_per_split,
        scale, window, sink, softcap, merge_drop,
        static_cast<cudaStream_t>(stream));
  });
}

// K9: q/out (B, S, Hq, D) of `dtype`, lane b's row s at position
// qstart[b] + s; qstart (B,) int32; the plan (ops/paged_attention.py
// rows_plan): `groups` row groups of up to 128 of the S x Hq/Hkv rows,
// each lane's MB entries cut into `splits` ranges of pages_per_split; with
// splits > 1, part holds B x Hkv x splits x S·Hq/Hkv x (D + 2) f32
// partials and tickets B x Hkv x groups zeroed counters, left zeroed;
// blocks of `warps` (4 or 8) warps. Pages, table, bpos, lens as K7.
extern "C" int mixq_paged_verify_attention(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* table, const void* bpos, const void* lens,
    const void* qstart, void* out, void* part, void* tickets, int B, int S,
    int Hq, int Hkv, int D, int BS, int MB, int groups, int splits,
    int pages_per_split, int warps, float scale, int window, int sink,
    float softcap, int dtype, int page_dtype, void* stream) {
  return with_page_types(dtype, page_dtype, [&](auto t, auto p) {
    return launch_rows<typename decltype(t)::type,
                       typename decltype(p)::type>(
        q, kp, vp, ks, vs, table, bpos, lens, qstart, out, nullptr, nullptr,
        part, tickets, B, S, Hq, Hkv, D, BS, MB, groups, splits,
        pages_per_split, warps, scale, window, sink, softcap,
        static_cast<cudaStream_t>(stream));
  });
}

// K10: q (B, Hq, D) of `dtype`; out (B, Hq, D) and m, l (B, Hq) f32; the
// plan and the rest as K9 at S = 1.
extern "C" int mixq_paged_decode_attention_stats(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* table, const void* bpos, const void* lens,
    void* out, void* m, void* l, void* part, void* tickets, int B, int Hq,
    int Hkv, int D, int BS, int MB, int groups, int splits,
    int pages_per_split, int warps, float scale, int window, int sink,
    float softcap, int dtype, int page_dtype, void* stream) {
  return with_page_types(dtype, page_dtype, [&](auto t, auto p) {
    return launch_rows<typename decltype(t)::type,
                       typename decltype(p)::type>(
        q, kp, vp, ks, vs, table, bpos, lens, nullptr, out, m, l, part,
        tickets, B, 1, Hq, Hkv, D, BS, MB, groups, splits, pages_per_split,
        warps, scale, window, sink, softcap,
        static_cast<cudaStream_t>(stream));
  });
}

// K8: q/out (B, C, Hq, D) of `dtype` (bf16 q: 16-byte aligned); qstart /
// lens (B,) int32; rest as decode.
extern "C" int mixq_paged_prefill_attention(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* table, const void* bpos, const void* qstart,
    const void* lens, void* out, int B, int C, int Hq, int Hkv, int D,
    int BS, int MB, float scale, int window, int sink, float softcap,
    int dtype, int page_dtype, void* stream) {
  return with_page_types(dtype, page_dtype, [&](auto t, auto p) {
    return launch_prefill<typename decltype(t)::type,
                          typename decltype(p)::type>(
        q, kp, vp, ks, vs, table, bpos, qstart, lens, out, B, C, Hq, Hkv, D,
        BS, MB, scale, window, sink, softcap,
        static_cast<cudaStream_t>(stream));
  });
}
