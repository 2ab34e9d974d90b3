// K5 / K6: in-place int8 paged-KV writes with the quantization fused in;
// K5p / K6p: the same writes into unquantized (bf16 or f32) pools.
//
// Replaces mixq_tensorrt_llm_tpu/ops/paged_write.py:
//   K5  _write_kernel_quant  (paged_write_token, one token per lane)
//   K6  _chunk_kernel_quant  (paged_write_chunk, page-aligned prefill chunk)
//   K5p _write_kernel_plain  (paged_write_token on an unquantized pool)
//   K6p _chunk_kernel_plain  (paged_write_chunk on an unquantized pool)
// and, inside the same launch, what runtime/kv_cache.py paged_write does
// around them: locating each token's page row and slot from the layer's
// block table (_locate), the valid mask, and the S <= 8 columns that the
// JAX package writes with one kernel call each. The Pallas kernels
// read-modify-write whole pages and take K/V quantized outside the
// kernel; here a lane group quantizes one (token, head) row of head_dim
// values and stores only that row and its scale in place.
//
// One launch per kv_cache.paged_write call, on every route:
//   write_token_kernel (S <= 8, or S not a multiple of the block size):
//     every row of every token; the lane group that writes a row locates
//     its token (the lane's table row read across the group's lanes, the
//     first match by a ballot) while the row's values are on their way.
//   write_chunk_kernel (S % BS == 0, S > 8): each block locates its slab's
//     BS tokens once into shared memory and takes the slab's page as their
//     max (the drop rule of paged_write.py:199-207: a token lands only if
//     that page is > 0, its own page is that page and its slot is its index
//     in the slab); dropped tokens are not read. Blocks a slab and rows a
//     block come from ops/paged_write.py write_plan (shapes only, no
//     readback), so the smoke's 4 x 256-token chunk fills the SMs.
// Token order does not matter: valid tokens own distinct slots, and a
// token located on the trash page 0 is not written at all (row 0's
// contents are garbage by contract).
//
// Rows: G lanes (a power of two dividing 32) own a row; with 16-byte
// aligned rows (VEC = 8) lane l holds values [8l, 8l + 8): one 16-byte
// load of bf16 and one 8-byte int8 store (G = 16 at D = 128: two rows a
// warp, four in flight a lane group in K6). Unaligned rows (tiny test
// models, odd views) take VEC = 1, the same kernels with scalar loads.
// New K and V are read through their strides (V is a view into the qkv
// projection's output and is not copied), and so are the index tensors
// (the draft prefill's positions are arange(S) expanded over the lanes).
//
// Bound on the H100: bytes. Per (token, head) row the work is D reads of
// the new value, one absmax, D quantizations, and D int8 + 4 scale bytes
// written. A decode step's K5 moves a few hundred KB: its time is the
// launch, one round trip to memory (every load of a row issued at once)
// and the dependent instructions of the lookup and the quantization.
// Quantization is bit-identical to quant/core.py quantize_kv:
// scale = max(absmax / 127, 1e-8) with an exact IEEE division
// (__fdiv_rn, once a row), q = clip(rint(x / scale), -127, 127) through
// common.cuh's qcode (a multiply and two fmas that round as the division
// does, ties to even). nvcc must not be given --use_fast_math.
//
// K5p / K6p are the same kernels instantiated for a bf16 or f32 page type:
// they cast each value to it (round to nearest even, as PyTorch's
// .to(bfloat16) does) and store it, so their pages are bit-equal to the
// plain version's too.

#include <climits>

#include "common.cuh"

namespace mixq {

constexpr int kTokenThreads = 128;
constexpr int kChunkThreads = 256;
constexpr int kChunkRows = 4;        // rows a lane group holds in flight (K6)
constexpr int kChunkBlocksPerSM = 4;
constexpr int kMaxBlockSize = 1024;  // tokens a page (K6's shared slab)
constexpr int kTableChunk = 4;       // table entries K6's lane loads at once

// An index tensor read through its element strides, as the caller hands
// it over (the draft prefill's positions are arange(S) expanded over the
// lanes: a lane stride of 0); p is null where it is not given. The
// strides are 32-bit (an index tensor is far below 2^31 elements), so a
// lookup's address is one 32-bit multiply-add on its dependent chain.
template <typename I>
struct Strided2 {
  const I* p;
  int s0, s1;
  __device__ __forceinline__ I operator()(int i, int j) const {
    return p[i * s0 + j * s1];
  }
  __device__ __forceinline__ const I* row(int i) const { return p + i * s0; }
};

// Where each token goes: given (pg, off: a page row and slot a token), or
// located here from the layer's block table as runtime/kv_cache.py
// _locate does.
struct WriteIndex {
  Strided2<int> pg;         // (B, S) page rows, or null: locate
  Strided2<int> off;        // (B, S) slots, with pg
  Strided2<int> table;      // (B, MB) global page rows
  Strided2<int> bpos;       // (B, MB) base positions, or null: identity
  Strided2<int> wpos;       // (B, S) absolute positions
  Strided2<uint8_t> valid;  // (B, S) bool, or null
  Strided2<int> kvlen;      // (B,): a position at or past it is invalid
  int S, MB, BS;
};

// new K (w = 0) and V (w = 1), (B, S, H, D) read through their strides
// (selected, not indexed: an indexed parameter array goes to local memory)
template <typename T>
struct NewRows {
  const T *k, *v;
  long long ksb, kss, ksh, vsb, vss, vsh;
  __device__ __forceinline__ const T* row(int w, int b, int s, int h) const {
    return w ? v + b * vsb + s * vss + h * vsh
             : k + b * ksb + s * kss + h * ksh;
  }
};

// K and V pools (NP, H, BS, D) and their scales (NP, H, BS); null scales
// for unquantized pools
template <typename P>
struct Pages {
  P *k, *v;
  float *ks, *vs;
  __device__ __forceinline__ P* pool(int w) const { return w ? v : k; }
  __device__ __forceinline__ float* scale(int w) const { return w ? vs : ks; }
};

// The rules of runtime/kv_cache.py _locate. torch's // and % floor where
// C's / and % truncate: a negative position (or PAD_POS, 2^30) gets the
// plain version's slot, always in [0, BS). With block_pos a token's page
// is that of the first entry whose base is the position's page base, page
// 0 when none is; without, that of the clamped entry wp // BS. Invalid
// tokens go to page 0.
struct Position {
  int q, slot;      // floor(wp / BS) and the in-page slot
  long long base;   // q * BS: the block_pos entry to find
  __device__ __forceinline__ Position(int wp, int BS) {
    if ((BS & (BS - 1)) == 0) {    // a power of two: shifts floor as // does
      const int lg = __ffs(BS) - 1;
      q = wp >> lg;
      slot = wp & (BS - 1);
    } else {
      q = wp / BS;
      slot = wp - q * BS;
      if (slot < 0) {
        slot += BS;
        --q;
      }
    }
    base = static_cast<long long>(q) * BS;
  }
  // whether table entry e (block_pos value pv) is the token's
  __device__ __forceinline__ bool entry(int e, int pv, bool bpos,
                                        int MB) const {
    return bpos ? e < MB && pv == base : e == min(max(q, 0), MB - 1);
  }
};

__device__ __forceinline__ bool invalid_token(const WriteIndex& ix, int b,
                                              int s, int wp) {
  return (ix.valid.p && !ix.valid(b, s)) ||
         (ix.kvlen.p && wp >= ix.kvlen(b, 0));
}

// (page row, slot) of token (b, s), by one thread (K6: a token a thread).
// The lane's table (and block_pos) row is read kTableChunk entries at a
// time, every load issued before the first compare.
__device__ __forceinline__ void locate(const WriteIndex& ix, int b, int s,
                                       int& page, int& slot) {
  if (ix.pg.p) {
    page = ix.pg(b, s);
    slot = ix.off(b, s);
    return;
  }
  const bool bp = ix.bpos.p != nullptr;
  const int* trow = ix.table.row(b);
  const int* prow = ix.bpos.row(b);
  const int ts = ix.table.s1, ps = ix.bpos.s1;
  const int wp = ix.wpos(b, s);
  const Position p(wp, ix.BS);
  slot = p.slot;
  bool hit = false;
  page = 0;
  for (int c = 0; c < ix.MB && !hit; c += kTableChunk) {
    int tv[kTableChunk], pv[kTableChunk];
#pragma unroll
    for (int i = 0; i < kTableChunk; ++i) {
      const bool in = c + i < ix.MB;
      tv[i] = in ? trow[(c + i) * ts] : 0;
      pv[i] = in && bp ? prow[(c + i) * ps] : 0;
    }
#pragma unroll
    for (int i = 0; i < kTableChunk; ++i) {
      if (!hit && p.entry(c + i, pv[i], bp, ix.MB)) {
        hit = true;
        page = tv[i];
      }
    }
  }
  if (invalid_token(ix, b, s, wp)) page = 0;
}

// (page row, slot) of token (b, s), by the G lanes of a row's group (K5):
// lane l reads entries l, l + G, ... of the lane's table (and block_pos)
// row beside the position, none waiting on it, so a table of up to G
// entries costs one round trip to memory; the first entry that matches is
// the group's lowest lane in a ballot, and its page comes by a shuffle.
// Every lane of the group calls it.
__device__ __forceinline__ void locate_group(const WriteIndex& ix, int b,
                                             int s, int l, int G,
                                             unsigned gmask, int& page,
                                             int& slot) {
  if (ix.pg.p) {
    page = ix.pg(b, s);
    slot = ix.off(b, s);
    return;
  }
  const bool bp = ix.bpos.p != nullptr;
  const int* trow = ix.table.row(b);
  const int* prow = ix.bpos.row(b);
  const int ts = ix.table.s1, ps = ix.bpos.s1;
  const int wp = ix.wpos(b, s);
  int tv = l < ix.MB ? trow[l * ts] : 0;
  int pv = bp && l < ix.MB ? prow[l * ps] : 0;
  const bool invalid = invalid_token(ix, b, s, wp);
  const Position p(wp, ix.BS);
  slot = p.slot;
  page = 0;
  for (int c = 0; c < ix.MB; c += G) {     // every branch group-uniform
    if (c > 0) {
      tv = c + l < ix.MB ? trow[(c + l) * ts] : 0;
      pv = bp && c + l < ix.MB ? prow[(c + l) * ps] : 0;
    }
    const unsigned hits =
        __ballot_sync(gmask, p.entry(c + l, pv, bp, ix.MB)) & gmask;
    if (hits) {
      page = __shfl_sync(gmask, tv, __ffs(hits) - 1);
      break;
    }
  }
  if (invalid) page = 0;
}

// the lanes of this lane's group of G (a power of two dividing 32)
__device__ __forceinline__ unsigned group_mask(int G, int lane) {
  return G == 32 ? kFullMask : ((1u << G) - 1u) << (lane & ~(G - 1));
}

// this lane's values of a row, 0 past D: [8l, 8l + 8) (VEC = 8, 16-byte
// aligned) or l, l + G, ..., l + 7G (VEC = 1)
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ src, int D,
                                         int l, int G, float y[8]) {
  if constexpr (VEC == 8) {
    if (8 * l < D) {
      Chunk<T> c;
      c.load(src + 8 * l);
      c.get(y);
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t) y[t] = 0.f;
    }
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int d = l + t * G;
      y[t] = d < D ? to_f(src[d]) : 0.f;
    }
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float y[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store8(float* p, const float y[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(y[0], y[1], y[2], y[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(y[4], y[5], y[6], y[7]);
}

// The group stores its row: for int8 pages (K5, K6) quantized, with its
// scale in *sdst; for bf16 or f32 pages (K5p, K6p) cast to P (sdst is not
// touched). Every lane of the group calls it.
template <typename P, int VEC>
__device__ __forceinline__ void store_row(P* __restrict__ dst, float* sdst,
                                          const float y[8], int D, int l,
                                          int G, unsigned gmask) {
  if constexpr (kQuantPages<P>) {
    float m = 0.f;
#pragma unroll
    for (int t = 0; t < 8; ++t) m = fmaxf(m, fabsf(y[t]));
    // non-negative floats order as their bits: one redux over the group
    const float amax =
        __uint_as_float(__reduce_max_sync(gmask, __float_as_uint(m)));
    const float scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
    const float rcp = __frcp_rn(scale);
    if constexpr (VEC == 8) {
      if (8 * l < D)
        *reinterpret_cast<uint2*>(dst + 8 * l) = quant8(y, scale, rcp);
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int d = l + t * G;
        if (d < D)
          dst[d] = static_cast<int8_t>(
              static_cast<uint8_t>(qcode(y[t], scale, rcp)));
      }
    }
    if (l == 0) *sdst = scale;
  } else if constexpr (VEC == 8) {
    if (8 * l < D) store8(dst + 8 * l, y);
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int d = l + t * G;
      if (d < D) store_f(dst + d, y[t]);
    }
  }
}

// K5 / K5p: rows r = ((w * H + h) * B * S + token), a lane group a row,
// the grid walking the rows. A row is read before its token is located
// (a token on the trash page is read and not written), so the launch
// waits on memory once: the K5 launch is its latency, not its bytes.
template <typename T, typename P, int VEC>
__global__ void __launch_bounds__(kTokenThreads)
    write_token_kernel(Pages<P> pages, NewRows<T> src, WriteIndex ix, int B,
                       int H, int D, int G) {
  const int lane = threadIdx.x & 31, l = lane & (G - 1);
  const unsigned gmask = group_mask(G, lane);
  const int gpb = kTokenThreads / G;
  const int nt = B * ix.S, rows = nt * 2 * H;
  for (int r = blockIdx.x * gpb + threadIdx.x / G; r < rows;
       r += gridDim.x * gpb) {                     // uniform in a group
    const int tok = r % nt, hw = r / nt, h = hw % H, w = hw / H;
    const int b = tok / ix.S, s = tok % ix.S;
    float y[8];               // loaded while the token is located: one trip
    load_row<T, VEC>(src.row(w, b, s, h), D, l, G, y);
    int page, slot;
    locate_group(ix, b, s, l, G, gmask, page, slot);
    if (page == 0) continue;
    const size_t at = (static_cast<size_t>(page) * H + h) * ix.BS + slot;
    store_row<P, VEC>(pages.pool(w) + at * D, pages.scale(w) + at, y, D, l,
                      G, gmask);
  }
}

// K6 / K6p: per_slab blocks a (lane, slab); block `part` writes rows
// [part * per, (part + 1) * per) of the slab's r = ((w * H + h) * BS + t),
// kChunkRows rows a lane group loaded before the first is stored.
template <typename T, typename P, int VEC>
__global__ void __launch_bounds__(kChunkThreads, kChunkBlocksPerSM)
    write_chunk_kernel(Pages<P> pages, NewRows<T> src, WriteIndex ix, int H,
                       int D, int G, int per_slab) {
  __shared__ int s_page[kMaxBlockSize], s_slot[kMaxBlockSize];
  __shared__ int red[kChunkThreads / 32];
  const int BS = ix.BS, ns = ix.S / BS;
  const int unit = blockIdx.x / per_slab, part = blockIdx.x % per_slab;
  const int b = unit / ns, s0 = (unit % ns) * BS;
  const int lane = threadIdx.x & 31;

  int m = INT_MIN;
  for (int t = threadIdx.x; t < BS; t += kChunkThreads) {
    int pg, sl;
    locate(ix, b, s0 + t, pg, sl);
    s_page[t] = pg;
    s_slot[t] = sl;
    m = max(m, pg);
  }
  m = __reduce_max_sync(kFullMask, m);
  if (lane == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  int page = red[0];
#pragma unroll
  for (int i = 1; i < kChunkThreads / 32; ++i) page = max(page, red[i]);
  if (page <= 0) return;                           // the slab is dropped

  const int l = lane & (G - 1), grp = threadIdx.x / G;
  const unsigned gmask = group_mask(G, lane);
  const int gpb = kChunkThreads / G, rows = BS * 2 * H;
  const int per = (rows + per_slab - 1) / per_slab;
  const int lo = part * per, hi = min(rows, lo + per);
  for (int base = lo; base < hi; base += gpb * kChunkRows) {
    float y[kChunkRows][8];
    bool live[kChunkRows];
#pragma unroll
    for (int i = 0; i < kChunkRows; ++i) {         // every load in flight
      const int r = base + i * gpb + grp;
      const int t = r % BS, hw = r / BS;
      live[i] = r < hi && s_page[t] == page && s_slot[t] == t;
      if (live[i]) load_row<T, VEC>(src.row(hw / H, b, s0 + t, hw % H), D,
                                    l, G, y[i]);
    }
#pragma unroll
    for (int i = 0; i < kChunkRows; ++i) {         // live is group-uniform
      if (!live[i]) continue;
      const int r = base + i * gpb + grp;
      const int t = r % BS, hw = r / BS, h = hw % H, w = hw / H;
      const size_t at = (static_cast<size_t>(page) * H + h) * BS + t;
      store_row<P, VEC>(pages.pool(w) + at * D, pages.scale(w) + at, y[i],
                        D, l, G, gmask);
    }
  }
}

template <typename T, typename P>
int launch(const Pages<P>& pages, const NewRows<T>& src,
           const WriteIndex& ix, int B, int H, int D, int G, int vec,
           int chunk, int grid, int per_slab, cudaStream_t st) {
  if (chunk && vec == 8)
    write_chunk_kernel<T, P, 8><<<grid, kChunkThreads, 0, st>>>(
        pages, src, ix, H, D, G, per_slab);
  else if (chunk)
    write_chunk_kernel<T, P, 1><<<grid, kChunkThreads, 0, st>>>(
        pages, src, ix, H, D, G, per_slab);
  else if (vec == 8)
    write_token_kernel<T, P, 8><<<grid, kTokenThreads, 0, st>>>(
        pages, src, ix, B, H, D, G);
  else
    write_token_kernel<T, P, 1><<<grid, kTokenThreads, 0, st>>>(
        pages, src, ix, B, H, D, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mixq

using namespace mixq;

extern "C" const char* mixq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K5 / K6 (int8 pools, with f32 scales) and K5p / K6p (bf16 or f32 pools,
// null scales): new K/V (B, S, H, D) of `dtype`, element strides k_s* /
// v_s* for lane, token and head (the last dimension contiguous), into
// pools (NP, H, BS, D) of `page_dtype`, in place. Each token's page row and
// slot are pg/off (B, S) int32 when pg is not null; otherwise they are
// located from table (B, MB) int32 global page rows, bpos (B, MB) int32
// base positions or null, wpos (B, S) int32 positions, valid (B, S) bool
// or null and kvlen (B,) int32 or null. ix_strides holds two int32 element
// strides of each index tensor, in the order pg, off, table, bpos, wpos,
// valid, kvlen (0 for an absent one, and for kvlen's second). chunk = 1:
// K6's route (S % BS == 0, grid = B * S / BS * per_slab); 0: K5's. group,
// vec and grid come from ops/paged_write.py write_plan.
extern "C" int mixq_paged_write(
    void* kpool, void* vpool, void* kscale, void* vscale, const void* pg,
    const void* off, const void* table, const void* bpos, const void* wpos,
    const void* valid, const void* kvlen, const void* nk, const void* nv,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, const int* ix_strides, int B,
    int S, int MB, int H, int BS, int D, int group, int vec, int chunk,
    int grid, int per_slab, int dtype, int page_dtype, void* stream) {
  const bool shapes_ok =
      group >= 1 && group <= 32 && (group & (group - 1)) == 0 &&
      (vec == 1 || vec == 8) && D >= 1 && D <= 8 * group && grid >= 1 &&
      ix_strides != nullptr &&
      (pg ? off != nullptr : (table && wpos && MB >= 1)) &&
      (!chunk || (S % BS == 0 && BS <= kMaxBlockSize && per_slab >= 1 &&
                  grid == B * (S / BS) * per_slab));
  if (!shapes_ok) return static_cast<int>(cudaErrorInvalidValue);
  const int* x = ix_strides;
  const WriteIndex ix{{static_cast<const int*>(pg), x[0], x[1]},
                      {static_cast<const int*>(off), x[2], x[3]},
                      {static_cast<const int*>(table), x[4], x[5]},
                      {static_cast<const int*>(bpos), x[6], x[7]},
                      {static_cast<const int*>(wpos), x[8], x[9]},
                      {static_cast<const uint8_t*>(valid), x[10], x[11]},
                      {static_cast<const int*>(kvlen), x[12], x[13]},
                      S,
                      MB,
                      BS};
  return with_page_types(dtype, page_dtype, [&](auto t, auto p) {
    using T = typename decltype(t)::type;
    using P = typename decltype(p)::type;
    const Pages<P> pages{static_cast<P*>(kpool), static_cast<P*>(vpool),
                         static_cast<float*>(kscale),
                         static_cast<float*>(vscale)};
    const NewRows<T> src{static_cast<const T*>(nk),
                         static_cast<const T*>(nv),
                         k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
    return launch<T, P>(pages, src, ix, B, H, D, group, vec, chunk, grid,
                        per_slab, static_cast<cudaStream_t>(stream));
  });
}
