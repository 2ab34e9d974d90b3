// K1: fused RMSNorm -> outlier split -> per-token int8 quantization.
//
// Replaces mixq_tensorrt_llm_tpu/ops/norm_quant.py _norm_quant_kernel
// (rmsnorm_quant_split, and quant_split without the norm). For each row
// a block computes:
//
//   1. sum of squares in f32 (fixed-order reduction: warp shuffles, then
//      the warps' sums in warp order);
//   2. x * rsqrt(mean + eps) * gamma, kept in f32 (the TPU kernel does not
//      round the normed row to bf16 either);
//   3. x_out[j] = bf16(row[fp_ind[j]]): a direct gather where the TPU
//      kernel contracts with a one-hot matrix on the MXU. That product
//      picks exactly one term per output, so the two agree bit for bit;
//   4. the outlier channels are set to 0 (flags built from fp_ind;
//      out-of-range entries are ignored);
//   5. scale = max(absmax / 127, 1e-8) by true division (__fdiv_rn);
//      q = clip(rint(x / scale), -127, 127), round half to even, the
//      quotient's rounding exactly that of __fdiv_rn (qcode).
//
// Bound on the H100: bytes. Per row it reads K values and writes K int8,
// 4 scale bytes and ko bf16; a few flops per byte. Three things stand
// between the kernel and that bound, and the design answers each:
//   - the row's dependent chain: every input of a row is requested in one
//     round trip to device memory, then two barriers (sum of squares,
//     absmax: warp shuffles plus one shared-memory exchange each), then
//     the stores;
//   - waves of blocks that all load, then all compute: the grid is one
//     wave of the blocks the SMs hold, each block walks rows z, z + grid,
//     ... and the next row's values are in flight while it computes this
//     one; gamma and the outlier flags are fetched once a block;
//   - instructions: an IEEE division a value (a ~20-instruction sequence
//     with a branch) took more instruction time at 1024 x 4096 than the
//     bytes take, so the division is a multiply and two fmas that round
//     as it does (qcode), the code is read off the float's bits, the absmax is
//     one redux.sync a warp, and the normed values stay in registers
//     between the two reductions: about a dozen instructions a value.
// The kernels:
//   norm_quant_regs_kernel (K <= 16384, every width the models use): the
//     row lives in registers, loaded with 16-byte loads, neighbouring
//     threads on neighbouring chunks of 8 values. The outlier flags are a
//     bit array in shared memory, set by atomicOr from fp_ind, read as one
//     byte per chunk; a flagged value goes to a shared-memory slot at its
//     channel and is zeroed in the registers, and x_out is gathered from
//     those slots. Threads per row and chunks per thread come from
//     ops/norm_quant.py norm_quant_plan.
//   norm_quant_smem_kernel (16384 < K <= 32768): the row staged in shared
//     memory as f32, in a layout where a warp's 16-byte accesses are
//     conflict-free (a chunk's values 0-3 at 4c, 4-7 at K/2 + 4c); the
//     same reductions, flags and gather.
// nvcc must not be given --use_fast_math (steps 2 and 5 rely on IEEE
// division and rounding).

#include <algorithm>

#include "common.cuh"

namespace mixq {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxChunks = 4;        // chunks of 8 values a register thread
constexpr int kSmemMax = 232448;     // bytes of shared memory a block may use

// every thread gets the block's sum of v, the warps' sums added in warp
// order; `red` holds a float per warp
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  float r = red[0];
  for (int i = 1; i < nw; ++i) r += red[i];
  return r;
}

// every thread gets the block's max of v >= 0: non-negative floats order
// as their bits do, so one redux.sync a warp; `red` holds a word per warp
__device__ __forceinline__ float block_max(float v, unsigned* red) {
  const unsigned u = __reduce_max_sync(kFullMask, __float_as_uint(v));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = u;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  unsigned r = red[0];
  for (int i = 1; i < nw; ++i) r = max(r, red[i]);
  return __uint_as_float(r);
}

// the normed value: x * inv * gamma rounded as the plain version does
template <bool NORM>
__device__ __forceinline__ float normed(float x, float inv, float g) {
  return NORM ? __fmul_rn(__fmul_rn(x, inv), g) : x;
}

// flags: a bit per channel, zeroed then set from fp_ind; ind_s keeps
// fp_ind for the gather. i0 is this thread's first entry, already loaded.
// Leaves a barrier to the caller before the flags are read.
__device__ __forceinline__ void set_flags(unsigned* flags, int* ind_s,
                                          const int* __restrict__ fp_ind,
                                          int i0, int K, int ko) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int w = tid; w < (K + 31) / 32; w += nt) flags[w] = 0u;
  __syncthreads();
  for (int j = tid; j < ko; j += nt) {
    const int i = j == tid ? i0 : fp_ind[j];
    ind_s[j] = i;
    if (i >= 0 && i < K) atomicOr(&flags[i >> 5], 1u << (i & 31));
  }
}

// the 8 flag bits of chunk c (channels 8c .. 8c + 7)
__device__ __forceinline__ unsigned chunk_flags(const unsigned* flags,
                                                int c) {
  return (flags[c >> 2] >> ((c & 3) * 8)) & 0xFFu;
}

// x_out[j] = bf16(vals[slot(fp_ind[j])]), 0 for an index out of range
template <typename Slot>
__device__ __forceinline__ void gather_outliers(
    const float* vals, const int* ind_s, __nv_bfloat16* __restrict__ xo,
    int K, int ko, Slot slot) {
  for (int j = threadIdx.x; j < ko; j += blockDim.x) {
    const int i = ind_s[j];
    xo[j] = __float2bfloat16(i >= 0 && i < K ? vals[slot(i)] : 0.f);
  }
}

// dynamic shared memory of both kernels: K floats (the register kernel's
// outlier slots, the other's row), the flag words, ko indices
inline size_t nq_smem(int K, int ko) {
  return sizeof(float) * static_cast<size_t>(K) +
         sizeof(unsigned) * static_cast<size_t>((K + 31) / 32) +
         sizeof(int) * static_cast<size_t>(ko);
}

// grid <= M blocks; block z takes rows z, z + grid, ... (one wave of the
// blocks the SMs hold: gamma and the flags are fetched once a block, and
// the next row's values are in flight while this row is computed)
template <typename T, bool NORM, int CPT>
__global__ void __launch_bounds__(kMaxThreads)
    norm_quant_regs_kernel(const T* __restrict__ x,
                           const float* __restrict__ gamma,
                           const int* __restrict__ fp_ind,
                           int8_t* __restrict__ qx, float* __restrict__ srow,
                           __nv_bfloat16* __restrict__ xout, int M, int K,
                           int ko, float eps) {
  extern __shared__ __align__(16) float nq_regs_smem[];
  float* xv = nq_regs_smem;                   // the outliers' normed values
  unsigned* flags = reinterpret_cast<unsigned*>(xv + K);
  int* ind_s = reinterpret_cast<int*>(flags + (K + 31) / 32);
  __shared__ float red_s[kMaxWarps];
  __shared__ unsigned red_m[kMaxWarps];
  const int tid = threadIdx.x, nt = blockDim.x, nc = K / 8;
  auto load_row = [&](Chunk<T>* xc, size_t row) {
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      if (tid + i * nt < nc) xc[i].load(x + row * K + 8 * (tid + i * nt));
  };

  // one round trip: the first row, gamma, the first outlier index
  Chunk<T> cur[CPT], nxt[CPT];
  float4 g[CPT][2];
  load_row(cur, blockIdx.x);
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = tid + i * nt;
    if (NORM && c < nc) {
      g[i][0] = reinterpret_cast<const float4*>(gamma + 8 * c)[0];
      g[i][1] = reinterpret_cast<const float4*>(gamma + 8 * c)[1];
    } else {
      g[i][0] = g[i][1] = make_float4(1.f, 1.f, 1.f, 1.f);
    }
  }
  const int i0 = tid < ko ? fp_ind[tid] : -1;
  set_flags(flags, ind_s, fp_ind, i0, K, ko);

  for (int row = blockIdx.x; row < M; row += gridDim.x) {
    const int next = row + gridDim.x;
    if (next < M) load_row(nxt, next);
    // barrier 1: the flags are set (first row), the last row's gather done
    float inv = 1.f;
    if (NORM) {
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        if (tid + i * nt < nc) {
          float f[8];
          cur[i].get(f);
#pragma unroll
          for (int t = 0; t < 8; ++t) ss += f[t] * f[t];
        }
      }
      ss = block_sum(ss, red_s);
      inv = __frsqrt_rn(
          __fadd_rn(__fdiv_rn(ss, static_cast<float>(K)), eps));
    } else {
      __syncthreads();
    }

    // normed values, kept: the flagged ones to their slots and zeroed,
    // the rest's absmax
    float y[CPT][8];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = tid + i * nt;
      if (c < nc) {
        float f[8];
        cur[i].get(f);
        const float gv[8] = {g[i][0].x, g[i][0].y, g[i][0].z, g[i][0].w,
                             g[i][1].x, g[i][1].y, g[i][1].z, g[i][1].w};
#pragma unroll
        for (int t = 0; t < 8; ++t) y[i][t] = normed<NORM>(f[t], inv, gv[t]);
        const unsigned fl = chunk_flags(flags, c);
        if (fl) {                            // about 1 chunk in 5 at 7B
#pragma unroll
          for (int t = 0; t < 8; ++t)
            if (fl >> t & 1u) xv[8 * c + t] = y[i][t];
#pragma unroll
          for (int t = 0; t < 8; ++t) y[i][t] = fl >> t & 1u ? 0.f : y[i][t];
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) amax = fmaxf(amax, fabsf(y[i][t]));
      }
    }
    amax = block_max(amax, red_m);  // barrier 2: slots are set
    const float scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
    const float rcp = __frcp_rn(scale);
    if (tid == 0) srow[row] = scale;
    gather_outliers(xv, ind_s, xout + static_cast<size_t>(row) * ko, K, ko,
                    [](int i) { return i; });

    int8_t* qr = qx + static_cast<size_t>(row) * K;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = tid + i * nt;
      if (c < nc)
        *reinterpret_cast<uint2*>(qr + 8 * c) = quant8(y[i], scale, rcp);
    }
#pragma unroll
    for (int i = 0; i < CPT; ++i) cur[i] = nxt[i];
  }
}

// grid <= M blocks walking the rows as norm_quant_regs_kernel's do, the
// row staged in shared memory
template <typename T, bool NORM>
__global__ void __launch_bounds__(kMaxThreads)
    norm_quant_smem_kernel(const T* __restrict__ x,
                           const float* __restrict__ gamma,
                           const int* __restrict__ fp_ind,
                           int8_t* __restrict__ qx, float* __restrict__ srow,
                           __nv_bfloat16* __restrict__ xout, int M, int K,
                           int ko, float eps) {
  extern __shared__ __align__(16) float nq_row_smem[];
  float* xs = nq_row_smem;            // the row: chunk c at 4c, K/2 + 4c
  unsigned* flags = reinterpret_cast<unsigned*>(xs + K);
  int* ind_s = reinterpret_cast<int*>(flags + (K + 31) / 32);
  __shared__ float red_s[kMaxWarps];
  __shared__ unsigned red_m[kMaxWarps];
  const int tid = threadIdx.x, nt = blockDim.x, nc = K / 8, half = K / 2;
  auto lo = [&](int c) { return reinterpret_cast<float4*>(xs + 4 * c); };
  auto hi = [&](int c) {
    return reinterpret_cast<float4*>(xs + half + 4 * c);
  };

  const int i0 = tid < ko ? fp_ind[tid] : -1;
  set_flags(flags, ind_s, fp_ind, i0, K, ko);
  for (size_t row = blockIdx.x; row < static_cast<size_t>(M);
       row += gridDim.x) {
    float ss = 0.f;
    for (int c = tid; c < nc; c += nt) {
      Chunk<T> xc;
      xc.load(x + row * K + 8 * c);
      float f[8];
      xc.get(f);
#pragma unroll
      for (int t = 0; t < 8; ++t) ss += f[t] * f[t];
      *lo(c) = make_float4(f[0], f[1], f[2], f[3]);
      *hi(c) = make_float4(f[4], f[5], f[6], f[7]);
    }
    float inv = 1.f;
    if (NORM) {
      ss = block_sum(ss, red_s);   // barrier: the flags are set
      inv = __frsqrt_rn(
          __fadd_rn(__fdiv_rn(ss, static_cast<float>(K)), eps));
    } else {
      __syncthreads();
    }

    // normed in place (each thread its own chunks); absmax without the
    // outliers
    float amax = 0.f;
    for (int c = tid; c < nc; c += nt) {
      float4 a = *lo(c), b = *hi(c);
      if (NORM) {
        const float4 g0 = reinterpret_cast<const float4*>(gamma + 8 * c)[0];
        const float4 g1 = reinterpret_cast<const float4*>(gamma + 8 * c)[1];
        a = make_float4(normed<true>(a.x, inv, g0.x),
                        normed<true>(a.y, inv, g0.y),
                        normed<true>(a.z, inv, g0.z),
                        normed<true>(a.w, inv, g0.w));
        b = make_float4(normed<true>(b.x, inv, g1.x),
                        normed<true>(b.y, inv, g1.y),
                        normed<true>(b.z, inv, g1.z),
                        normed<true>(b.w, inv, g1.w));
        *lo(c) = a;
        *hi(c) = b;
      }
      const unsigned fl = chunk_flags(flags, c);
      const float y[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (!(fl >> t & 1u)) amax = fmaxf(amax, fabsf(y[t]));
    }
    amax = block_max(amax, red_m);  // barrier: the row is normed
    const float scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
    const float rcp = __frcp_rn(scale);
    if (tid == 0) srow[row] = scale;
    gather_outliers(xs, ind_s, xout + row * ko, K, ko, [half](int i) {
      const int c = i >> 3, t = i & 7;
      return (t < 4 ? 0 : half) + 4 * c + (t & 3);
    });

    int8_t* qr = qx + row * K;
    for (int c = tid; c < nc; c += nt) {
      const float4 a = *lo(c), b = *hi(c);
      const unsigned fl = chunk_flags(flags, c);
      float y[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (fl >> t & 1u) y[t] = 0.f;
      *reinterpret_cast<uint2*>(qr + 8 * c) = quant8(y, scale, rcp);
    }
    __syncthreads();                         // the row's slots are free
  }
}

// blocks of `kernel` the card holds at once (the last answer cached: the
// main path asks for the same kernel, block and shared memory every call)
template <typename Kern>
int resident_blocks(Kern kernel, int threads, size_t smem) {
  static int dev_sms[64];
  static const void* last_kernel = nullptr;
  static int last_threads = -1, last_per = 0;
  static size_t last_smem = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (dev_sms[dev] == 0 &&
      cudaDeviceGetAttribute(&dev_sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 0;
  const void* k = reinterpret_cast<const void*>(kernel);
  if (k != last_kernel || threads != last_threads || smem != last_smem) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&last_per, kernel,
                                                      threads, smem) !=
        cudaSuccess)
      return 0;
    last_kernel = k;
    last_threads = threads;
    last_smem = smem;
  }
  return last_per * dev_sms[dev];
}

template <typename T, bool NORM>
int launch(const void* x, const void* gamma, const void* fp_ind, void* qx,
           void* srow, void* xout, int M, int K, int ko, float eps,
           int threads, int cpt, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const float* gt = static_cast<const float*>(gamma);
  const int* it = static_cast<const int*>(fp_ind);
  int8_t* qt = static_cast<int8_t*>(qx);
  float* st_ = static_cast<float*>(srow);
  __nv_bfloat16* ot = static_cast<__nv_bfloat16*>(xout);
  const size_t smem = nq_smem(K, ko);
  auto run = [&](auto kernel) {
    if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int blocks = resident_blocks(kernel, threads, smem);
    if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    kernel<<<std::min(M, blocks), threads, smem, st>>>(xt, gt, it, qt, st_,
                                                       ot, M, K, ko, eps);
    return static_cast<int>(cudaGetLastError());
  };
  switch (cpt) {
    case 0: return run(norm_quant_smem_kernel<T, NORM>);
    case 1: return run(norm_quant_regs_kernel<T, NORM, 1>);
    case 2: return run(norm_quant_regs_kernel<T, NORM, 2>);
    case 3: return run(norm_quant_regs_kernel<T, NORM, 3>);
    case 4: return run(norm_quant_regs_kernel<T, NORM, 4>);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace mixq

using namespace mixq;

extern "C" const char* mixq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (M, K) of `dtype`, gamma (K,) f32 (read only when do_norm), fp_ind (ko,)
// int32 -> q_x (M, K) int8, scale_row (M,) f32, x_out (M, ko) bf16. The
// wrapper guarantees M >= 1, K % 8 == 0, K <= 32768, 16-byte aligned x and
// gamma. The plan (ops/norm_quant.py norm_quant_plan): `threads` a row (a
// multiple of 32, at most 512); chunks_per_thread 1-4 takes the register
// kernel, whose threads must cover the row's K / 8 chunks, and 0 the
// shared-memory kernel.
extern "C" int mixq_norm_quant_split(const void* x, const void* gamma,
                                     const void* fp_ind, void* qx, void* srow,
                                     void* xout, int M, int K, int ko,
                                     float eps, int do_norm, int dtype,
                                     int threads, int chunks_per_thread,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cpt = chunks_per_thread;
  if (threads < 32 || threads > kMaxThreads || threads % 32 || cpt < 0 ||
      cpt > kMaxChunks ||
      (cpt > 0 && static_cast<long long>(cpt) * threads * 8 < K))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16)
    return do_norm ? launch<__nv_bfloat16, true>(x, gamma, fp_ind, qx, srow,
                                                 xout, M, K, ko, eps, threads,
                                                 cpt, st)
                   : launch<__nv_bfloat16, false>(x, gamma, fp_ind, qx, srow,
                                                  xout, M, K, ko, eps,
                                                  threads, cpt, st);
  if (dtype == kF32)
    return do_norm ? launch<float, true>(x, gamma, fp_ind, qx, srow, xout, M,
                                         K, ko, eps, threads, cpt, st)
                   : launch<float, false>(x, gamma, fp_ind, qx, srow, xout, M,
                                          K, ko, eps, threads, cpt, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
