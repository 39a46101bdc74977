// Shared device code of the port's resampling kernels (sm_90a): the hash
// RNG, the flush to zero, the deterministic block reductions, the mbarriers
// and bulk copies of the kernels' shared-memory rings, the fused step's
// statistics prelude, and the attribute query of the contract checks.
// The CUDA twin of repro_torch/kernels/common.py; included by every source
// under kernels/*/csrc/.  kernels/build.py hashes this header into the name
// of every library that includes it, so an edit here rebuilds them all.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

#define NT 256
#define CHUNK 256
#define GOLDEN 0x9E3779B9u
#define FLT_MIN_NORMAL 1.17549435e-38f

__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < FLT_MIN_NORMAL ? copysignf(0.0f, x) : x;
}

// Plane words (DESIGN.md §14): the weight planes move as float,
// __nv_bfloat16 or __half; every value the arithmetic reads is upcast to
// f32 first, so selection, the hash, the uniforms and the step's statistics
// stay f32.  plane_f32 is the exact upcast (a bf16 subnormal stays an f32
// subnormal, which the -ftz=true products and compares of a sweep flush);
// load_plane, the load helper, upcasts and flushes; to_plane rounds an f32
// to the nearest plane word, ties to even, as torch's .to(dtype) does.
__device__ __forceinline__ float plane_f32(float x) { return x; }
__device__ __forceinline__ float plane_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float plane_f32(__half x) { return __half2float(x); }

template <class T>
__device__ __forceinline__ float load_plane(T x) {
  return ftz(plane_f32(x));
}

template <class T>
__device__ __forceinline__ T to_plane(float x);
template <>
__device__ __forceinline__ float to_plane<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_plane<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half to_plane<__half>(float x) { return __float2half_rn(x); }

// The plane dtypes by the code the C entry points take (0 float32, 1
// bfloat16, 2 float16; repro_torch/kernels/common.py's PLANE_DTYPES order).
#define PLANE_F32 0
#define PLANE_BF16 1
#define PLANE_F16 2

// Call f with a value of the plane word that `plane` names (f(float{}),
// f(__nv_bfloat16{}) or f(__half{})), on the host: the C entry points'
// dispatch to a kernel's instance.  An unknown code is cudaErrorInvalidValue.
template <class F>
static int by_plane(int plane, F f) {
  switch (plane) {
    case PLANE_F32: return f(float{});
    case PLANE_BF16: return f(__nv_bfloat16{});
    case PLANE_F16: return f(__half{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// State words (DESIGN.md §14): a kernel that copies state moves it as raw
// words of the state's own width, S = uint32_t or uint16_t, a template
// argument beside the weights' plane word T: a copy is a bit move, never a
// float instruction, so a 4-byte integer state (SMC decoding's token
// buffer) rides beside any plane and no bit pattern is flushed.  A state of
// the plane's own dtype takes StateWord<T>, T's width; an index-only kernel
// takes it too (its S is unused).
template <class T>
using StateWord = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;

// Call f(T{}, S{}) for the plane word `plane` names and the state word of
// `sb` bytes (the state's element size): T's own width at every plane, and
// 4 bytes beside a 2-byte plane too; any other pair is
// cudaErrorInvalidValue.  No instance pairs float with a 2-byte state.
template <class F>
static int by_words(int plane, int sb, F f) {
  return by_plane(plane, [&](auto word) {
    using T = decltype(word);
    if (sb == (int)sizeof(T)) return f(word, StateWord<T>{});
    if constexpr (sizeof(T) == 2) {
      if (sb == 4) return f(word, uint32_t{});
    }
    return (int)cudaErrorInvalidValue;
  });
}

__device__ __forceinline__ uint32_t fmix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// U[0, 1) with 24 bits of entropy from hash bits, as hash_uniform.
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float nanmax(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// Deterministic block reductions (fixed shuffle tree, fixed warp order); the
// result is returned to every thread of the block.
template <bool IS_MAX>
__device__ float block_reduce(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = IS_MAX ? nanmax(v, o) : v + o;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int q = 1; q < NT / 32; ++q) v = IS_MAX ? nanmax(v, red[q]) : v + red[q];
  return v;
}

// --------------------------------------------------------------- mbarriers
// The rings of the Megopolis and C2 kernels: one thread starts bulk copies
// (cp.async.bulk) from device memory into a shared-memory buffer, counted on
// the buffer's full mbarrier; each warp arrives on its empty mbarrier when
// it is done with the buffer.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 state;\n\tmbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Initialise a ring's barriers (full: one arrival and the copies' bytes;
// empty: one arrival per warp) and make them visible to the block.
template <int STAGES>
__device__ __forceinline__ void ring_barriers_init(uint64_t (&full)[STAGES],
                                                   uint64_t (&empty)[STAGES]) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Scratch of a cooperative step launch (floats):
// pmax[S·G] | psum[S·G·4] | hh[S·B] | wbuf[S·n] (plane words of the
// step's log-weights; a kernel reads it through reinterpret_cast).
struct StepScratch {
  float* pmax;
  float* psum;
  uint32_t* hh;
  float* wbuf;
};

__device__ __forceinline__ StepScratch step_scratch(float* scratch, int rows, int nblk,
                                                    int iters) {
  StepScratch sc;
  sc.pmax = scratch;
  sc.psum = sc.pmax + (size_t)rows * nblk;
  sc.hh = (uint32_t*)(sc.psum + (size_t)rows * nblk * 4);
  sc.wbuf = (float*)(sc.hh + (size_t)rows * iters);
  return sc;
}

// A plane word t stored as the word W of a step's weights buffer: t itself,
// or (W = float) its exact f32 value.
template <class W>
struct StoredWord {
  template <class T>
  __device__ __forceinline__ static W of(T t) { return t; }
};
template <>
struct StoredWord<float> {
  template <class T>
  __device__ __forceinline__ static float of(T t) { return plane_f32(t); }
};

// The fused step's prelude, shared by every step kernel: step_stats per row
// (repro_torch/kernels/common.py) over log-weights lw of plane words T, each
// upcast and flushed (load_plane), the trigger ess_norm < thr, the weights
// exp(lw - m) (1/N on a degenerate row) rounded to T and written once to
// sc.wbuf as words W (by default T: the sweep reads what JAX's
// w.astype(lw.dtype).astype(f32) gives, in half the bytes at 2-byte words;
// W = float stores those values as f32, for a kernel that scans them in
// place; the stats are of the f32 weights, as step_stats(lw.astype(f32))),
// and the per-iteration hash
// prefix hh[s·B + b] = fmix(seeds[s] + b·GOLDEN).  It holds two
// grid.sync() barriers: one after the per-block maxima, one after the
// per-block sums.  Per-block partials go to scratch and every block reduces
// them in the same fixed order, so the stats repeat bit for bit (no float
// atomics).  On return, row_m[s] holds the shift and row_flag[s] bit 0 the
// degenerate flag, bit 1 the trigger; block 0 has written stats[S, 4] =
// (ess_norm, incr if fired else 0, fired, max_weight).  At T = float it is
// the f32 prelude every other step kernel instantiates.
template <class T, class W = T>
__device__ __forceinline__ void step_prelude(cg::grid_group& grid, const T* __restrict__ lw,
                                             const uint32_t* __restrict__ seeds, float thr,
                                             float* __restrict__ stats, const StepScratch& sc,
                                             float* row_m, int* row_flag, float* red,
                                             int rows, int n, int iters) {
  const int nblk = gridDim.x;
  const int tid = threadIdx.x;
  const size_t gstride = (size_t)nblk * NT;
  const size_t gtid = (size_t)blockIdx.x * NT + tid;
  const float inv_n = (float)(1.0 / (double)n);

  // Phase 1: per-block maxima (nan propagates, as jnp.max).
  for (int s = 0; s < rows; ++s) {
    const T* l = lw + (size_t)s * n;
    float mx = -INFINITY;
    for (size_t i = gtid; i < (size_t)n; i += gstride) mx = nanmax(mx, load_plane(l[i]));
    mx = block_reduce<true>(mx, red);
    if (tid == 0) sc.pmax[(size_t)s * nblk + blockIdx.x] = mx;
  }
  for (size_t q = gtid; q < (size_t)rows * iters; q += gstride) {
    sc.hh[q] = fmix(seeds[q / iters] + (uint32_t)(q % iters) * GOLDEN);
  }
  grid.sync();

  for (int s = 0; s < rows; ++s) {
    float mx = -INFINITY;
    for (int q = tid; q < nblk; q += NT) mx = nanmax(mx, sc.pmax[(size_t)s * nblk + q]);
    mx = block_reduce<true>(mx, red);
    if (tid == 0) {
      const bool deg = !isfinite(mx);
      row_m[s] = deg ? 0.0f : mx;
      row_flag[s] = deg ? 1 : 0;
    }
  }
  __syncthreads();

  // Phase 2: weights and per-block sums.
  for (int s = 0; s < rows; ++s) {
    const T* l = lw + (size_t)s * n;
    W* wr = reinterpret_cast<W*>(sc.wbuf) + (size_t)s * n;
    const float m = row_m[s];
    const bool deg = row_flag[s] & 1;
    float sraw = 0.0f, s1 = 0.0f, s2 = 0.0f, mx = -INFINITY;
    for (size_t i = gtid; i < (size_t)n; i += gstride) {
      const float e = ftz(expf(ftz(load_plane(l[i]) - m)));
      const float wv = deg ? inv_n : e;
      wr[i] = StoredWord<W>::of(to_plane<T>(wv));
      sraw += e;
      s1 += wv;
      s2 += ftz(__fmul_rn(wv, wv));
      mx = fmaxf(mx, wv);
    }
    sraw = block_reduce<false>(sraw, red);
    s1 = block_reduce<false>(s1, red);
    s2 = block_reduce<false>(s2, red);
    mx = block_reduce<true>(mx, red);
    if (tid == 0) {
      float* p = sc.psum + ((size_t)s * nblk + blockIdx.x) * 4;
      p[0] = sraw;
      p[1] = s1;
      p[2] = s2;
      p[3] = mx;
    }
  }
  grid.sync();

  for (int s = 0; s < rows; ++s) {
    float sraw = 0.0f, s1 = 0.0f, s2 = 0.0f, mx = -INFINITY;
    for (int q = tid; q < nblk; q += NT) {
      const float* p = sc.psum + ((size_t)s * nblk + q) * 4;
      sraw += p[0];
      s1 += p[1];
      s2 += p[2];
      mx = fmaxf(mx, p[3]);
    }
    sraw = block_reduce<false>(sraw, red);
    s1 = block_reduce<false>(s1, red);
    s2 = block_reduce<false>(s2, red);
    mx = block_reduce<true>(mx, red);
    if (tid == 0) {
      const float ess_norm = (s1 * s1) / fmaxf(s2, 1e-30f) / (float)n;
      const bool fire = ess_norm < thr;
      const float incr = (row_m[s] + logf(sraw)) - logf((float)n);
      row_flag[s] |= fire ? 2 : 0;
      if (blockIdx.x == 0) {
        stats[s * 4 + 0] = ess_norm;
        stats[s * 4 + 1] = fire ? incr : 0.0f;
        stats[s * 4 + 2] = fire ? 1.0f : 0.0f;
        stats[s * 4 + 3] = mx / fmaxf(s1, 1e-30f);
      }
    }
  }
  __syncthreads();
}

// Shared memory of a step launch: the per-row shift and flags.
static size_t step_smem_bytes(int rows) { return (size_t)rows * 8; }

// A step kernel whose ring and reduction floats (static shared memory) and
// per-row shift and flags (dynamic, 8 bytes a row) pass 48 KiB together at
// the most rows a step admits: every launch and every occupancy query of
// it first sets its dynamic limit to the `dynamic` bytes it asks for (a
// host-side attribute, on the current device), so no size is guessed.
template <class Kernel>
static int smem_optin(Kernel kernel, size_t dynamic) {
  return (int)cudaFuncSetAttribute((const void*)kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dynamic);
}

// Blocks of NT threads of `kernel`, with `smem` bytes of dynamic shared
// memory, that can be co-resident on the current device (blocks per SM x
// SMs), no more than `need` and at least one.  Fails where no block fits an
// SM, which a cooperative grid cannot launch around.
template <class Kernel>
static int resident_blocks(Kernel kernel, size_t smem, long long need, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  if (err != cudaSuccess) return (int)err;
  long long g = (long long)per_sm * sms;
  if (g > need) g = need;
  *blocks = (int)(g < 1 ? 1 : g);
  return per_sm < 1 ? (int)cudaErrorCooperativeLaunchTooLarge : 0;
}

// Blocks of a cooperative step grid for a bank of `rows` rows: as many as
// can be co-resident on the current device, and no more than the work needs.
template <class Kernel>
static int coop_step_grid(Kernel kernel, int rows, int n, int* blocks) {
  return resident_blocks(kernel, step_smem_bytes(rows), ((long long)rows * n + NT - 1) / NT,
                         blocks);
}

// One cooperative launch of a step kernel with its argument array.
template <class Kernel>
static int coop_step_launch(Kernel kernel, int blocks, int rows, void** args, void* stream) {
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(NT),
                                                args, step_smem_bytes(rows),
                                                (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Attributes of one kernel for the contract checks' resource table
// (repro_torch/analysis/smem.py): out = {registers per thread, static shared
// memory, largest block, blocks of NT threads co-resident on one SM with
// `dynamic_smem` bytes of dynamic shared memory}.
template <class Kernel>
static int kernel_attributes(Kernel kernel, int dynamic_smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, (const void*)kernel);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)kernel, NT,
                                                        (size_t)dynamic_smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = per_sm;
  return 0;
}
