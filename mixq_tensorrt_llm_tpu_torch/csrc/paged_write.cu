// K5 / K6: in-place int8 paged-KV writes with the quantization fused in;
// K5p / K6p: the same writes into unquantized (bf16 or f32) pools.
//
// Replaces mixq_tensorrt_llm_tpu/ops/paged_write.py:
//   K5  _write_kernel_quant  (paged_write_token, one token per lane)
//   K6  _chunk_kernel_quant  (paged_write_chunk, page-aligned prefill chunk)
//   K5p _write_kernel_plain  (paged_write_token on an unquantized pool)
//   K6p _chunk_kernel_plain  (paged_write_chunk on an unquantized pool)
// The Pallas kernels read-modify-write whole pages and take K/V already
// quantized outside the kernel. Here each warp quantizes one (token, head)
// row of head_dim values and stores only that row and its scale in place:
// a CUDA kernel can write a few bytes of a page without copying the rest.
//
// Bound on the H100: bytes. Per (token, head) row the work is D reads of
// the new value, one absmax, D divisions, and D int8 + 4 scale bytes
// written; no arithmetic intensity to speak of. The design moves each byte
// once (no page RMW, no quantized staging copy in device memory).
//
// Quantization is bit-identical to quant/core.py quantize_kv: scale =
// max(absmax / 127, 1e-8) with an exact IEEE division (__fdiv_rn), q =
// clip(rint(x / scale), -127, 127) with the exact division again and
// round-half-even (rintf). nvcc must not be given --use_fast_math.
//
// K5p / K6p are the same kernels instantiated for a bf16 or f32 page type:
// they cast each value to it (__float2bfloat16 rounds to nearest even, as
// PyTorch's .to(bfloat16) does) and store it; nothing else differs, so
// their pages are bit-equal to the plain version's too.
//
// Masked lanes and dropped tokens target trash row 0; several warps may
// race on it, and row 0's contents are garbage by contract.

#include "common.cuh"

namespace mixq {

constexpr int kWarps = 4;

// One warp stores `src` (D values) as the page row `dst`: for int8 pages
// (K5, K6) quantized, with its scale in `*sdst`; for bf16 or f32 pages
// (K5p, K6p) cast to P, and `sdst` unused.
template <typename T, typename P>
__device__ __forceinline__ void warp_store_row(const T* src, int D, P* dst,
                                               float* sdst, int lane) {
  if constexpr (kQuantPages<P>) {
    float amax = 0.f;
    for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(to_f(src[d])));
    amax = warp_max(amax);
    const float scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
    for (int d = lane; d < D; d += 32) {
      float q = rintf(__fdiv_rn(to_f(src[d]), scale));
      q = fminf(fmaxf(q, -127.f), 127.f);
      dst[d] = static_cast<int8_t>(q);
    }
    if (lane == 0) *sdst = scale;
  } else {
    for (int d = lane; d < D; d += 32) store_f(dst + d, to_f(src[d]));
  }
}

// K5 / K5p: rows are (lane b, head h, k-or-v); one warp per row. The scale
// pools are null for unquantized pages.
template <typename T, typename P>
__global__ void write_token_kernel(P* __restrict__ kpool,
                                   P* __restrict__ vpool,
                                   float* __restrict__ kscale,
                                   float* __restrict__ vscale,
                                   const int* __restrict__ pg,
                                   const int* __restrict__ off,
                                   const T* __restrict__ nk,
                                   const T* __restrict__ nv, int B, int H,
                                   int BS, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= B * H * 2) return;
  const int which = row % 2, h = (row / 2) % H, b = row / (2 * H);
  const T* src = (which ? nv : nk) + (static_cast<size_t>(b) * H + h) * D;
  const size_t slot = (static_cast<size_t>(pg[b]) * H + h) * BS + off[b];
  warp_store_row(src, D, (which ? vpool : kpool) + slot * D,
                 kQuantPages<P> ? (which ? vscale : kscale) + slot : nullptr,
                 lane);
}

// K6 / K6p: one block per (lane b, slab, head h, k-or-v). The slab's page
// is the max of its BS block ids (paged_write.py:201); a token lands only
// if that page is real (> 0), its own block id is that page, and its
// in-page offset equals its slot in the slab (paged_write.py:202-204).
template <typename T, typename P>
__global__ void write_chunk_kernel(P* __restrict__ kpool,
                                   P* __restrict__ vpool,
                                   float* __restrict__ kscale,
                                   float* __restrict__ vscale,
                                   const int* __restrict__ blk,
                                   const int* __restrict__ off,
                                   const T* __restrict__ nk,
                                   const T* __restrict__ nv, int S, int H,
                                   int BS, int D) {
  __shared__ int warp_pg[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ns = S / BS;
  const int b = blockIdx.x / ns, slab = blockIdx.x % ns;
  const int h = blockIdx.y, which = blockIdx.z;
  const int* sblk = blk + static_cast<size_t>(b) * S + slab * BS;
  const int* soff = off + static_cast<size_t>(b) * S + slab * BS;

  int m = 0;
  for (int t = threadIdx.x; t < BS; t += blockDim.x) m = max(m, sblk[t]);
  m = warp_max_int(m);
  if (lane == 0) warp_pg[warp] = m;
  __syncthreads();
  int page = warp_pg[0];
  for (int w = 1; w < kWarps; ++w) page = max(page, warp_pg[w]);
  if (page <= 0) return;

  P* pool = which ? vpool : kpool;
  float* spool = which ? vscale : kscale;
  const T* src = which ? nv : nk;
  const size_t row0 = (static_cast<size_t>(page) * H + h) * BS;
  for (int t = warp; t < BS; t += kWarps) {
    if (sblk[t] != page || soff[t] != t) continue;   // warp-uniform
    const size_t s = static_cast<size_t>(b) * S + slab * BS + t;
    warp_store_row(src + (s * H + h) * D, D, pool + (row0 + t) * D,
                   kQuantPages<P> ? spool + row0 + t : nullptr, lane);
  }
}

template <typename T, typename P>
int launch_token(void* kpool, void* vpool, void* kscale, void* vscale,
                 const void* pg, const void* off, const void* nk,
                 const void* nv, int B, int H, int BS, int D,
                 cudaStream_t st) {
  const int rows = B * H * 2;
  write_token_kernel<T, P><<<(rows + kWarps - 1) / kWarps, 32 * kWarps, 0,
                             st>>>(
      static_cast<P*>(kpool), static_cast<P*>(vpool),
      static_cast<float*>(kscale), static_cast<float*>(vscale),
      static_cast<const int*>(pg), static_cast<const int*>(off),
      static_cast<const T*>(nk), static_cast<const T*>(nv), B, H, BS, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int launch_chunk(void* kpool, void* vpool, void* kscale, void* vscale,
                 const void* blk, const void* off, const void* nk,
                 const void* nv, int B, int S, int H, int BS, int D,
                 cudaStream_t st) {
  write_chunk_kernel<T, P><<<dim3(B * (S / BS), H, 2), 32 * kWarps, 0, st>>>(
      static_cast<P*>(kpool), static_cast<P*>(vpool),
      static_cast<float*>(kscale), static_cast<float*>(vscale),
      static_cast<const int*>(blk), static_cast<const int*>(off),
      static_cast<const T*>(nk), static_cast<const T*>(nv), S, H, BS, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mixq

using namespace mixq;

extern "C" const char* mixq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K5 / K5p: new_k/new_v (B, H, D) of `dtype` into pools (NP, H, BS, D) of
// `page_dtype`, in place at page pg[b], slot off[b]; int8 pools come with
// scales (NP, H, BS) f32, the others pass null scales.
extern "C" int mixq_paged_write_token(void* kpool, void* vpool, void* kscale,
                                      void* vscale, const void* pg,
                                      const void* off, const void* nk,
                                      const void* nv, int B, int H, int BS,
                                      int D, int dtype, int page_dtype,
                                      void* stream) {
  return with_page_types(dtype, page_dtype, [&](auto t, auto p) {
    return launch_token<typename decltype(t)::type,
                        typename decltype(p)::type>(
        kpool, vpool, kscale, vscale, pg, off, nk, nv, B, H, BS, D,
        static_cast<cudaStream_t>(stream));
  });
}

// K6 / K6p: new_k/new_v (B, S, H, D) of `dtype`, blk/off (B, S) int32,
// S % BS == 0; pools and scales as K5's.
extern "C" int mixq_paged_write_chunk(void* kpool, void* vpool, void* kscale,
                                      void* vscale, const void* blk,
                                      const void* off, const void* nk,
                                      const void* nv, int B, int S, int H,
                                      int BS, int D, int dtype,
                                      int page_dtype, void* stream) {
  return with_page_types(dtype, page_dtype, [&](auto t, auto p) {
    return launch_chunk<typename decltype(t)::type,
                        typename decltype(p)::type>(
        kpool, vpool, kscale, vscale, blk, off, nk, nv, B, S, H, BS, D,
        static_cast<cudaStream_t>(stream));
  });
}
