// K7 / K8: attention over the paged KV pool, pages read in place.
//
// Replaces mixq_tensorrt_llm_tpu/ops/paged_attention.py:
//   K7  _decode_kernel  (paged_decode_attention: one query token per lane)
//   K8  _prefill_kernel (paged_prefill_attention: a chunk of C query tokens)
// in both of their modes: int8 pages with per-(token, head) scales
// (quantized=True), and unquantized bf16 or f32 pages (quantized=False).
// The page type P is a template parameter; the unquantized instantiations
// leave out the scale multiplies (where the Pallas kernels multiply by
// scale pages of ones), and the int8 ones are the code of the int8-only
// kernels they replace.
//
// Both walk the lane's block table, skip pages no query of the block can
// see, and keep a flash-style online softmax in f32. The int8 K scale
// multiplies the logits and the int8 V scale the probabilities, so no
// dequantized copy of a page ever exists. Positions are absolute: entry j's
// base comes from block_pos, which keeps recycled (windowed) pages right.
// A fully masked row contributes exactly 0 (the exp subtrahend is clamped
// at -0.5e30 as the Pallas kernels do), so inactive lanes (table 0,
// block_pos PAD_POS, len 1) produce 0 and never NaN.
//
// Bound on the H100: bytes for decode (every visited page's int8 K and V
// plus their scales are read once; about 2 FLOP per byte), and for long
// prefill chunks the f32 CUDA-core arithmetic of this first version
// (tensor cores via wgmma come in a later PR). Design against the bytes:
// pages are read as int8 straight from device memory, each page once per
// block, with consecutive threads on consecutive bytes of a row.
//
// Block sizes accepted: 16 <= BS <= 256, BS % 16 == 0; head_dim D a
// multiple of 32 up to 256 (the Python wrappers check this).

#include "common.cuh"

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
// K7: decode. One block per (lane b, kv head h); its G = Hq/Hkv query heads
// are the rows. Dynamic shared memory: q (G x D), probs (G x BS),
// acc (G x D), m/l/alpha (G each).
// ---------------------------------------------------------------------------
template <typename T, typename P>
__global__ void decode_kernel(const T* __restrict__ q,
                              const P* __restrict__ kp,
                              const P* __restrict__ vp,
                              const float* __restrict__ ks,
                              const float* __restrict__ vs,
                              const int* __restrict__ table,
                              const int* __restrict__ bpos,
                              const int* __restrict__ lens,
                              T* __restrict__ out, int Hq, int Hkv, int D,
                              int BS, int MB, float scale, int window,
                              int sink, float softcap) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  float* qs = smem;                 // G*D
  float* ps = qs + G * D;           // G*BS
  float* acc = ps + G * BS;         // G*D
  float* m_s = acc + G * D;         // G
  float* l_s = m_s + G;             // G
  float* a_s = l_s + G;             // G

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* qb = q + (static_cast<size_t>(b) * Hq + h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = to_f(qb[i]) * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int len = lens[b], qpos = len - 1;
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
      const bool keep = keep_position(pos, qpos, window, sink);
      float kst = 1.f;
      if constexpr (kQuantPages<P>) kst = kscale[t];
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxD / 32; ++i)
          if (i < nd) part += qs[g * D + i * 32 + lane] * kreg[i];
        part = warp_sum(part);
        if (lane == 0) {
          float v = part;
          if constexpr (kQuantPages<P>) v *= kst;
          if (softcap != 0.f) v = tanhf(v / softcap) * softcap;
          ps[g * BS + t] = keep ? v : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int g = warp; g < G; g += kWarpsPerBlock) {
      float mx = kNegInf;
      for (int t = lane; t < BS; t += 32) mx = fmaxf(mx, ps[g * BS + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float sub = fmaxf(m_new, kClampSub);
      float sum = 0.f;
      for (int t = lane; t < BS; t += 32) {
        const float p = expf(ps[g * BS + t] - sub);
        sum += p;
        if constexpr (kQuantPages<P>)
          ps[g * BS + t] = p * vscale[t];
        else
          ps[g * BS + t] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + sum;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v, threads across (row, head_dim)
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      const float* pg = ps + g * BS;
      float a = acc[i] * a_s[g];
      for (int t = 0; t < BS; ++t)
        a += pg[t] * to_f(vpage[static_cast<size_t>(t) * D + d]);
      acc[i] = a;
    }
    __syncthreads();
  }

  T* ob = out + (static_cast<size_t>(b) * Hq + h * G) * D;
  for (int i = tid; i < G * D; i += kThreads)
    store_f(ob + i, acc[i] / fmaxf(l_s[i / D], 1e-20f));
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

template <typename T, typename P>
int launch_decode(const void* q, const void* kp, const void* vp,
                  const void* ks, const void* vs, const void* table,
                  const void* bpos, const void* lens, void* out, int B,
                  int Hq, int Hkv, int D, int BS, int MB, float scale,
                  int window, int sink, float softcap, cudaStream_t st) {
  const int G = Hq / Hkv;
  const size_t smem = (static_cast<size_t>(2 * G * D + G * BS + 3 * G)) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_kernel<T, P><<<dim3(Hkv, B), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const P*>(kp),
      static_cast<const P*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(bpos), static_cast<const int*>(lens),
      static_cast<T*>(out), Hq, Hkv, D, BS, MB, scale, window, sink, softcap);
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

// q/out (B, Hq, D) of `dtype`; pages (NP, Hkv, BS, D) of `page_dtype`:
// int8 with scales (NP, Hkv, BS) f32, or bf16/f32 with null scales;
// table/bpos (B, MB) int32; lens (B,) int32.
extern "C" int mixq_paged_decode_attention(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* table, const void* bpos, const void* lens,
    void* out, int B, int Hq, int Hkv, int D, int BS, int MB, float scale,
    int window, int sink, float softcap, int dtype, int page_dtype,
    void* stream) {
  return with_page_types(dtype, page_dtype, [&](auto t, auto p) {
    return launch_decode<typename decltype(t)::type,
                         typename decltype(p)::type>(
        q, kp, vp, ks, vs, table, bpos, lens, out, B, Hq, Hkv, D, BS, MB,
        scale, window, sink, softcap, static_cast<cudaStream_t>(stream));
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
