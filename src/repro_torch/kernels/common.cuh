// Shared device code of the port's resampling kernels (sm_90a): the hash
// RNG, the flush to zero, the deterministic block reductions and the fused
// step's statistics prelude.  The CUDA twin of repro_torch/kernels/common.py;
// included by megopolis/csrc/megopolis.cu and metropolis/csrc/metropolis.cu.
// kernels/build.py hashes this header into the name of every library that
// includes it, so an edit here rebuilds both.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NT 256
#define CHUNK 256
#define GOLDEN 0x9E3779B9u
#define FLT_MIN_NORMAL 1.17549435e-38f

__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < FLT_MIN_NORMAL ? copysignf(0.0f, x) : x;
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

// Scratch of a cooperative step launch (floats):
// pmax[S·G] | psum[S·G·4] | hh[S·B] | wbuf[S·n].
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

// The fused step's prelude, shared by every step kernel: step_stats per row
// (repro_torch/kernels/common.py), the trigger ess_norm < thr, the weights
// exp(lw - m) (1/N on a degenerate row) written once to sc.wbuf, and the
// per-iteration hash prefix hh[s·B + b] = fmix(seeds[s] + b·GOLDEN).  It
// holds two grid.sync() barriers: one after the per-block maxima, one after
// the per-block sums.  Per-block partials go to scratch and every block
// reduces them in the same fixed order, so the stats repeat bit for bit (no
// float atomics).  On return, row_m[s] holds the shift and row_flag[s] bit 0
// the degenerate flag, bit 1 the trigger; block 0 has written stats[S, 4] =
// (ess_norm, incr if fired else 0, fired, max_weight).
__device__ __forceinline__ void step_prelude(cg::grid_group& grid, const float* __restrict__ lw,
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
    const float* l = lw + (size_t)s * n;
    float mx = -INFINITY;
    for (size_t i = gtid; i < (size_t)n; i += gstride) mx = nanmax(mx, ftz(l[i]));
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
    const float* l = lw + (size_t)s * n;
    float* wr = sc.wbuf + (size_t)s * n;
    const float m = row_m[s];
    const bool deg = row_flag[s] & 1;
    float sraw = 0.0f, s1 = 0.0f, s2 = 0.0f, mx = -INFINITY;
    for (size_t i = gtid; i < (size_t)n; i += gstride) {
      const float e = ftz(expf(ftz(ftz(l[i]) - m)));
      const float wv = deg ? inv_n : e;
      wr[i] = wv;
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

// Blocks of a cooperative step grid for a bank of `rows` rows: as many as
// can be co-resident on the current device, and no more than the work needs.
template <class Kernel>
static int coop_step_grid(Kernel kernel, int rows, int n, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        step_smem_bytes(rows));
  if (err != cudaSuccess) return (int)err;
  const long long need = ((long long)rows * n + NT - 1) / NT;
  long long g = (long long)per_sm * sms;
  if (g > need) g = need;
  *blocks = (int)(g < 1 ? 1 : g);
  return per_sm < 1 ? (int)cudaErrorCooperativeLaunchTooLarge : 0;
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
