// K7 / K8 / K9 / K10: attention over the paged KV pool, pages read in
// place.
//
// Replaces mixq_tensorrt_llm_tpu/ops/paged_attention.py:
//   K7  _decode_kernel, s = 1 (paged_decode_attention: one query per lane)
//   K9  _decode_kernel, s > 1 (paged_verify_attention: 2..8 query rows per
//       lane at consecutive positions, the speculative verify)
//   K10 _decode_kernel, stats=True (paged_decode_attention(stats=True):
//       f32 output plus the softmax's running (m, l); K11,
//       paged_decode_attention_split, runs it over page splits and merges
//       the parts in ops/paged_attention.py)
//   K8  _prefill_kernel (paged_prefill_attention: a chunk of C query tokens)
// in both of their modes: int8 pages with per-(token, head) scales
// (quantized=True), and unquantized bf16 or f32 pages (quantized=False).
// The page type P is a template parameter; the unquantized instantiations
// leave out the scale multiplies (where the Pallas kernels multiply by
// scale pages of ones), and the int8 ones are the code of the int8-only
// kernels they replace.
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
// Bound on the H100: bytes for decode and verify (every visited page's
// int8 K and V plus their scales are read once; about 2 FLOP per byte per
// query row). K7, decode_split_kernel, is designed against them: each
// lane's table is split across blocks of one launch (grid Hkv x B x
// splits, splits from the shapes alone), a block streams its pages through
// a 2-stage ring of 1-D bulk copies (cp.async.bulk, mbarrier completion)
// while it computes the previous one, reads K and V as 16-byte and 4-value
// vectors, and the last split of a (lane, KV head) to arrive merges the
// splits' (m, l, acc) in split order in the same launch. K9, K10
// (decode_body) and K8 are the first versions: one block per (lane, KV
// head) or per query tile, scalar page reads, f32 CUDA-core arithmetic
// (tensor cores are not used). Design against the bytes there: pages are
// read as int8 straight from device memory, each page once per block, with
// consecutive threads on consecutive bytes of a row.
//
// Block sizes accepted: 16 <= BS <= 256, BS % 16 == 0; head_dim D a
// multiple of 32 up to 256 (the Python wrappers check this).

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
// K9 / K10: two modes of the decode kernel, one body, as they are modes of
// one Pallas kernel (its third, K7, is decode_split_kernel below). One
// block per (kv head h, lane b). Its rows are the S x G pairs (query row
// s, query head g of the kv head's group): row r = s * G + g reads
// q[b, s, h * G + g] and sits at absolute position qpos0 + s.
//   K9  verify_kernel        S query rows from qpos0 = qstart[b]
//                            (speculative verify: gamma + 1 rows)
//   K10 decode_stats_kernel  S = 1 at compile time, qpos0 = len - 1: the
//                            decode query, its normalized output in f32
//                            and the running (m, l) of every row, for an
//                            exact merge with attention over other keys
//                            (K11)
// Every visited page is read once per block for all S * G rows: that is
// K9's point over K8's 16-row tiles. A row's arithmetic is the same
// whatever the other rows do: a page fully masked for one row but visited
// for another gives that row logits of kNegInf, so alpha = exp(0) = 1 and
// p = 0, and the row's m, l and acc do not change; at S = 1 K9 is K10
// rounded to q's dtype, bit for bit. Dynamic shared memory, R = S * G
// rows: q (R x D), probs (R x BS), acc (R x D), m/l/alpha (R each).
// ---------------------------------------------------------------------------
template <typename T, typename P, typename O, bool kVerify>
__device__ __forceinline__ void decode_body(
    float* smem, const T* __restrict__ q, const P* __restrict__ kp,
    const P* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ table,
    const int* __restrict__ bpos, const int* __restrict__ lens,
    const int* __restrict__ qstart, O* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int S_arg, int Hq,
    int Hkv, int D, int BS, int MB, float scale, int window, int sink,
    float softcap) {
  const int G = Hq / Hkv;
  const int S = kVerify ? S_arg : 1;
  const int R = S * G;
  float* qs = smem;                 // R*D
  float* ps = qs + R * D;           // R*BS
  float* acc = ps + R * BS;         // R*D
  float* m_s = acc + R * D;         // R
  float* l_s = m_s + R;             // R
  float* a_s = l_s + R;             // R

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // row r's q and out lie at row0 + r * D, plus (Hq - G) * D per draft row
  // before it (the other kv heads' query heads)
  const size_t row0 = (static_cast<size_t>(b) * S * Hq + h * G) * D;
  const T* qb = q + row0;
  for (int i = tid; i < R * D; i += kThreads) {
    size_t src = i;
    if constexpr (kVerify)
      src += static_cast<size_t>(i / (G * D)) * (Hq - G) * D;
    qs[i] = to_f(qb[src]) * scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int len = lens[b];
  int qpos0 = len - 1;
  if constexpr (kVerify) qpos0 = qstart[b];
  const int nd = D / 32;
  for (int j = 0; j < MB; ++j) {
    const int base = bpos[b * MB + j];
    if (base >= len) continue;                 // uniform across the block
    const size_t prow = static_cast<size_t>(table[b * MB + j]) * Hkv + h;
    const P* kpage = kp + prow * BS * D;
    const P* vpage = vp + prow * BS * D;
    const float* kscale = ks + (kQuantPages<P> ? prow * BS : 0);
    const float* vscale = vs + (kQuantPages<P> ? prow * BS : 0);

    // logits: one warp per token, lanes across head_dim
    for (int t = warp; t < BS; t += kWarpsPerBlock) {
      float kreg[kMaxD / 32];
      const P* krow = kpage + static_cast<size_t>(t) * D;
#pragma unroll
      for (int i = 0; i < kMaxD / 32; ++i)
        kreg[i] = i < nd ? to_f(krow[i * 32 + lane]) : 0.f;
      const int pos = base + t;
      float kst = 1.f;
      if constexpr (kQuantPages<P>) kst = kscale[t];
      for (int s = 0; s < S; ++s) {
        // K7's rows sit at len - 1, so its causal mask keeps pos < len;
        // a K9 row past len - 1 (a short draft prefill's padding rows)
        // must not see the page's unwritten tail either
        const bool keep = (!kVerify || pos < len) &&
                          keep_position(pos, qpos0 + s, window, sink);
        for (int g = 0; g < G; ++g) {
          const int r = s * G + g;
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < kMaxD / 32; ++i)
            if (i < nd) part += qs[r * D + i * 32 + lane] * kreg[i];
          part = warp_sum(part);
          if (lane == 0) {
            float v = part;
            if constexpr (kQuantPages<P>) v *= kst;
            if (softcap != 0.f) v = tanhf(v / softcap) * softcap;
            ps[r * BS + t] = keep ? v : kNegInf;
          }
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < R; r += kWarpsPerBlock) {
      float mx = kNegInf;
      for (int t = lane; t < BS; t += 32) mx = fmaxf(mx, ps[r * BS + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float sub = fmaxf(m_new, kClampSub);
      float sum = 0.f;
      for (int t = lane; t < BS; t += 32) {
        const float p = expf(ps[r * BS + t] - sub);
        sum += p;
        if constexpr (kQuantPages<P>)
          ps[r * BS + t] = p * vscale[t];
        else
          ps[r * BS + t] = p;
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

    // acc = acc * alpha + p @ v, threads across (row, head_dim)
    for (int i = tid; i < R * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const float* pr = ps + r * BS;
      float a = acc[i] * a_s[r];
      for (int t = 0; t < BS; ++t)
        a += pr[t] * to_f(vpage[static_cast<size_t>(t) * D + d]);
      acc[i] = a;
    }
    __syncthreads();
  }

  O* ob = out + row0;
  for (int i = tid; i < R * D; i += kThreads) {
    size_t dst = i;
    if constexpr (kVerify)
      dst += static_cast<size_t>(i / (G * D)) * (Hq - G) * D;
    store_f(ob + dst, acc[i] / fmaxf(l_s[i / D], 1e-20f));
  }
  // K10: a row that saw no key keeps m = kNegInf and l = 0 (its output is
  // 0), so merge_attention_stats gives it no weight
  if (m_out != nullptr) {
    for (int r = tid; r < R; r += kThreads) {
      const size_t o = (static_cast<size_t>(b) * S + r / G) * Hq + h * G +
                       r % G;
      m_out[o] = m_s[r];
      l_out[o] = l_s[r];
    }
  }
}

template <typename T, typename P>
__global__ void verify_kernel(const T* __restrict__ q,
                              const P* __restrict__ kp,
                              const P* __restrict__ vp,
                              const float* __restrict__ ks,
                              const float* __restrict__ vs,
                              const int* __restrict__ table,
                              const int* __restrict__ bpos,
                              const int* __restrict__ lens,
                              const int* __restrict__ qstart,
                              T* __restrict__ out, int S, int Hq, int Hkv,
                              int D, int BS, int MB, float scale, int window,
                              int sink, float softcap) {
  extern __shared__ float smem[];
  decode_body<T, P, T, true>(smem, q, kp, vp, ks, vs, table, bpos, lens,
                             qstart, out, nullptr, nullptr, S, Hq, Hkv, D, BS,
                             MB, scale, window, sink, softcap);
}

template <typename T, typename P>
__global__ void decode_stats_kernel(const T* __restrict__ q,
                                    const P* __restrict__ kp,
                                    const P* __restrict__ vp,
                                    const float* __restrict__ ks,
                                    const float* __restrict__ vs,
                                    const int* __restrict__ table,
                                    const int* __restrict__ bpos,
                                    const int* __restrict__ lens,
                                    float* __restrict__ out,
                                    float* __restrict__ m_out,
                                    float* __restrict__ l_out, int Hq,
                                    int Hkv, int D, int BS, int MB,
                                    float scale, int window, int sink,
                                    float softcap) {
  extern __shared__ float smem[];
  decode_body<T, P, float, false>(smem, q, kp, vp, ks, vs, table, bpos, lens,
                                  nullptr, out, m_out, l_out, 1, Hq, Hkv, D,
                                  BS, MB, scale, window, sink, softcap);
}

// ---------------------------------------------------------------------------
// K8: chunked prefill. One block per (query tile of kTileQ tokens, query
// head hq, lane b). Rows past C are padding and are not written; rows past
// the prompt are computed (don't-care, finite). Under GQA the G query heads
// of a KV head each read its pages, G reads in all; while the f32
// arithmetic limits this kernel that costs nothing measurable (PERF.md).
// Giving a block G * kTileQ rows of one KV head is the fix once it is
// bound by bytes.
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
// K7: decode_split_kernel. One block of 256 threads per (kv head h, lane b,
// split): split z owns the table entries z * pages_per_split .. + pages
// - 1 and skips those with base >= len (and, within a page, the ring
// stages that start at or past len). The G query heads of the kv head are
// its rows; each page is read once for all of them.
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
                        int D, int BS, int MB, int pages_per_split,
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
  const int j1 = min(MB, (split + 1) * pages_per_split);
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
  int j = first_page(split * pages_per_split), sub = 0;
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

  const T* qb = q + (static_cast<size_t>(b) * Hq + h * G) * D;
  for (int i = tid; i < G * D; i += kSplitThreads) {
    const int r = i / D, d = i - r * D;
    qs[r * qrow + (d / kCE) * kQld + d % kCE] = to_f(qb[i]) * scale;
  }
  for (int i = tid; i < L.acc_floats; i += kSplitThreads) accs[i] = 0.f;
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
    for (int g = 0; g < TG; ++g) a += accs[(g * G + r) * D + d];
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

// the decode kernels' dynamic shared memory for R = S * G rows; above
// 48 KB a kernel must opt in (the wrappers refuse what exceeds 227 KB)
inline size_t decode_smem(int R, int D, int BS) {
  return static_cast<size_t>(2 * R * D + R * BS + 3 * R) * sizeof(float);
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
                        int D, int BS, int MB, int splits,
                        int pages_per_split, float scale, int window,
                        int sink, float softcap, int merge_drop,
                        cudaStream_t st) {
  if (splits < 1 || pages_per_split < 1 ||
      static_cast<long long>(splits) * pages_per_split < MB ||
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
      static_cast<unsigned*>(tickets), Hq, Hkv, D, BS, MB, pages_per_split,
      scale, window, sink, softcap, merge_drop);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int launch_verify(const void* q, const void* kp, const void* vp,
                  const void* ks, const void* vs, const void* table,
                  const void* bpos, const void* lens, const void* qstart,
                  void* out, int B, int S, int Hq, int Hkv, int D, int BS,
                  int MB, float scale, int window, int sink, float softcap,
                  cudaStream_t st) {
  const size_t smem = decode_smem(S * (Hq / Hkv), D, BS);
  if (int e = allow_smem(verify_kernel<T, P>, smem)) return e;
  verify_kernel<T, P><<<dim3(Hkv, B), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const P*>(kp),
      static_cast<const P*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(bpos), static_cast<const int*>(lens),
      static_cast<const int*>(qstart), static_cast<T*>(out), S, Hq, Hkv, D,
      BS, MB, scale, window, sink, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int launch_decode_stats(const void* q, const void* kp, const void* vp,
                        const void* ks, const void* vs, const void* table,
                        const void* bpos, const void* lens, void* out,
                        void* m, void* l, int B, int Hq, int Hkv, int D,
                        int BS, int MB, float scale, int window, int sink,
                        float softcap, cudaStream_t st) {
  const size_t smem = decode_smem(Hq / Hkv, D, BS);
  if (int e = allow_smem(decode_stats_kernel<T, P>, smem)) return e;
  decode_stats_kernel<T, P><<<dim3(Hkv, B), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const P*>(kp),
      static_cast<const P*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(bpos), static_cast<const int*>(lens),
      static_cast<float*>(out), static_cast<float*>(m),
      static_cast<float*>(l), Hq, Hkv, D, BS, MB, scale, window, sink,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int launch_prefill(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* table,
                   const void* bpos, const void* qstart, const void* lens,
                   void* out, int B, int C, int Hq, int Hkv, int D, int BS,
                   int MB, float scale, int window, int sink, float softcap,
                   cudaStream_t st) {
  dim3 grid((C + kTileQ - 1) / kTileQ, Hq, B);
  prefill_kernel<T, P><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const P*>(kp),
      static_cast<const P*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(bpos), static_cast<const int*>(qstart),
      static_cast<const int*>(lens), static_cast<T*>(out), C, Hq, Hkv, D, BS,
      MB, scale, window, sink, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mixq

using namespace mixq;

extern "C" const char* mixq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K7: q/out (B, Hq, D) of `dtype`; pages (NP, Hkv, BS, D) of
// `page_dtype`: int8 with scales (NP, Hkv, BS) f32, or bf16/f32 with null
// scales; table/bpos (B, MB) int32; lens (B,) int32. Each lane's MB
// entries cut into `splits` ranges of pages_per_split
// (ops/paged_attention.py decode_plan); with splits > 1, part holds B x
// Hkv x splits x (Hq/Hkv) x (D + 2) f32 partials and tickets B x Hkv
// zeroed counters, which the kernel leaves zeroed. merge_drop: 0, or 1 for
// the negative controls' fault (the last split that saw a key left out).
extern "C" int mixq_paged_decode_attention(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* table, const void* bpos, const void* lens,
    void* out, void* part, void* tickets, int B, int Hq, int Hkv, int D,
    int BS, int MB, int splits, int pages_per_split, float scale,
    int window, int sink, float softcap, int merge_drop, int dtype,
    int page_dtype, void* stream) {
  return with_page_types(dtype, page_dtype, [&](auto t, auto p) {
    return launch_decode_split<typename decltype(t)::type,
                               typename decltype(p)::type>(
        q, kp, vp, ks, vs, table, bpos, lens, out, part, tickets, B, Hq, Hkv,
        D, BS, MB, splits, pages_per_split, scale, window, sink, softcap,
        merge_drop, static_cast<cudaStream_t>(stream));
  });
}

// K9: q/out (B, S, Hq, D) of `dtype`, lane b's row s at position
// qstart[b] + s; qstart (B,) int32; rest as decode.
extern "C" int mixq_paged_verify_attention(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* table, const void* bpos, const void* lens,
    const void* qstart, void* out, int B, int S, int Hq, int Hkv, int D,
    int BS, int MB, float scale, int window, int sink, float softcap,
    int dtype, int page_dtype, void* stream) {
  return with_page_types(dtype, page_dtype, [&](auto t, auto p) {
    return launch_verify<typename decltype(t)::type,
                         typename decltype(p)::type>(
        q, kp, vp, ks, vs, table, bpos, lens, qstart, out, B, S, Hq, Hkv, D,
        BS, MB, scale, window, sink, softcap,
        static_cast<cudaStream_t>(stream));
  });
}

// K10: q (B, Hq, D) of `dtype`; out (B, Hq, D) and m, l (B, Hq) f32; rest
// as decode.
extern "C" int mixq_paged_decode_attention_stats(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* table, const void* bpos, const void* lens,
    void* out, void* m, void* l, int B, int Hq, int Hkv, int D, int BS,
    int MB, float scale, int window, int sink, float softcap, int dtype,
    int page_dtype, void* stream) {
  return with_page_types(dtype, page_dtype, [&](auto t, auto p) {
    return launch_decode_stats<typename decltype(t)::type,
                               typename decltype(p)::type>(
        q, kp, vp, ks, vs, table, bpos, lens, out, m, l, B, Hq, Hkv, D, BS,
        MB, scale, window, sink, softcap, static_cast<cudaStream_t>(stream));
  });
}

// q/out (B, C, Hq, D) of `dtype`; qstart/lens (B,) int32; rest as decode.
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
