// Megopolis resampling (paper Alg. 5) for NVIDIA Hopper (sm_90a).
//
// Two kernels with a plain C interface, built by repro_torch/kernels/build.py
// (nvcc -gencode arch=compute_90a,code=sm_90a -O3 -ftz=true -shared) and
// bound with ctypes by repro_torch/kernels/megopolis/megopolis.py.  Every
// entry point launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().  Their plain PyTorch versions are in ../ref.py.
//
// megopolis_fused_rows_kernel replaces the TPU kernels megopolis_pallas_fused
// and megopolis_pallas_fused_rows (repro/kernels/megopolis/megopolis.py,
// _kernel_fused and _kernel_fused_rows): the Alg. 5 sweep over B iterations
// plus the copy of each ancestor's state, for a bank of S rows (a single
// population is a bank of one row).
//
//   What bounds it: per row it must move w (4N bytes), the state in and out
//   (8DN) and the ancestors (4N): 16 MiB at N = 2^20, D = 1, about 5 us at
//   3.35 TB/s.  The sweep does B·N comparisons, each about 20 32-bit
//   operations (the index map, one murmur3 finalizer, the float conversion,
//   the product and the select): at B = 32 that is 6.7·10^8 operations, about
//   10 us at the 67 T/s of 32-bit arithmetic outside the tensor cores, so the
//   operations bound it, not the bytes.
//   What the design does about it: one thread per particle, the B-loop in
//   registers with w[k] carried by value (never re-read), and the
//   per-iteration part of the hash, fmix(seed + b·GOLDEN), computed once per
//   block into shared memory rather than by every lane.  For a fixed b the
//   lanes of a warp read consecutive j (at most one wrap), so every w[j]
//   read is coalesced: the paper's argument, at segment 1024 as on the TPU.
//
// megopolis_step_rows_kernel replaces megopolis_pallas_step and
// megopolis_pallas_step_rows (_kernel_step, _kernel_step_rows): the fused SMC
// step.  A per-row prelude mirrors step_stats (repro/kernels/common.py):
// m = max(lw), the degenerate flag, the sums of exp(lw - m), w and w^2 and
// max(w), then the trigger ess_norm < thr; the sweep runs on exp(lw - m) (or
// on 1/N for a degenerate row) and commits the selection, or the identity
// where the trigger did not fire.
//
//   What bounds it: the bytes of the fused kernel plus one more read of lw,
//   and the same integer work; the integer work bounds it here too.
//   What the design does about it: the TPU runs the prelude once, at grid
//   step (0, 0), and latches it in SMEM; blocks on this card run in no
//   order, so the kernel is one cooperative launch whose grid is sized to be
//   co-resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and walks the
//   particles with grid-stride loops, with two grid.sync() barriers: one
//   after the per-block maxima, one after the per-block sums.  Per-block
//   partials go to a scratch buffer and every block reduces them in the same
//   fixed order, so the stats are the same from run to run (no float
//   atomics).  The weights exp(lw - m) are written once to scratch in the
//   sums pass and read by the sweep.  expf (not __expf) keeps the weights
//   bit-identical to torch.exp on the card.
//
// Subnormals: built with -ftz=true, and flushed explicitly (ftz()) on the
// values selection depends on, as XLA does on the CPU.  State copies are bit
// moves and are never flushed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define SEG 1024
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

// The Megopolis comparison index at segment 1024 (Alg. 5 lines 7-11):
// j = (aligned(i) + aligned(o) + (i + o) mod 1024) mod n, for 0 <= i, o < n
// and n a multiple of 1024, so the sum is below 2n and one subtraction wraps.
__device__ __forceinline__ int cmp_index(int i, int o, int n) {
  uint32_t j = (uint32_t)(i - (i & (SEG - 1))) + (uint32_t)(o - (o & (SEG - 1))) +
               (uint32_t)((i + o) & (SEG - 1));
  return (int)(j >= (uint32_t)n ? j - (uint32_t)n : j);
}

// cnt iterations of the sweep for particle i; offs[t] and hh[t] =
// fmix(seed + b·GOLDEN) are those of iteration b = b0 + t.
__device__ __forceinline__ void sweep(const float* __restrict__ w, const int* offs,
                                      const uint32_t* hh, int cnt, int i, int n,
                                      int& k, float& wk) {
  const uint32_t lane = (uint32_t)i * GOLDEN;
  for (int t = 0; t < cnt; ++t) {
    const int j = cmp_index(i, offs[t], n);
    const float wj = ftz(__ldg(w + j));
    const uint32_t bits = fmix(hh[t] ^ lane);
    const float u = (float)(bits >> 8) * (1.0f / 16777216.0f);
    if (ftz(__fmul_rn(u, wk)) <= wj) {  // u <= w[j] / w[k]   (Alg. 5 line 13)
      k = j;
      wk = wj;
    }
  }
}

__global__ void __launch_bounds__(NT) megopolis_fused_rows_kernel(
    const float* __restrict__ w, const float* __restrict__ state,
    const int* __restrict__ offsets, const uint32_t* __restrict__ seeds,
    int* __restrict__ anc, float* __restrict__ out, int n, int d, int iters) {
  __shared__ int s_off[CHUNK];
  __shared__ uint32_t s_hh[CHUNK];
  const int s = blockIdx.y;
  const int i = blockIdx.x * NT + threadIdx.x;
  const bool live = i < n;
  const float* wr = w + (size_t)s * n;
  const uint32_t seed = seeds[s];
  int k = i;
  float wk = live ? ftz(wr[i]) : 0.0f;
  for (int b0 = 0; b0 < iters; b0 += CHUNK) {
    const int cnt = min(CHUNK, iters - b0);
    for (int t = threadIdx.x; t < cnt; t += NT) {
      s_off[t] = offsets[(size_t)s * iters + b0 + t];
      s_hh[t] = fmix(seed + (uint32_t)(b0 + t) * GOLDEN);
    }
    __syncthreads();
    if (live) sweep(wr, s_off, s_hh, cnt, i, n, k, wk);
    __syncthreads();
  }
  if (!live) return;
  anc[(size_t)s * n + i] = k;
  for (int c = 0; c < d; ++c) {
    const size_t plane = ((size_t)s * d + c) * n;
    out[plane + i] = state[plane + k];
  }
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

// Scratch layout (floats): pmax[S·G] | psum[S·G·4] | hh[S·B] | wbuf[S·n].
__global__ void __launch_bounds__(NT) megopolis_step_rows_kernel(
    const float* __restrict__ lw, const float* __restrict__ state,
    const int* __restrict__ offsets, const uint32_t* __restrict__ seeds, float thr,
    int* __restrict__ anc, float* __restrict__ out, float* __restrict__ stats,
    float* __restrict__ scratch, int rows, int n, int d, int iters) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float row_m[];          // [rows] shift m per row
  int* row_flag = (int*)(row_m + rows);     // [rows] bit 0: degenerate, bit 1: do
  __shared__ float red[NT / 32];
  const int nblk = gridDim.x;
  const int tid = threadIdx.x;
  const size_t gstride = (size_t)nblk * NT;
  const size_t gtid = (size_t)blockIdx.x * NT + tid;
  float* pmax = scratch;
  float* psum = pmax + (size_t)rows * nblk;
  uint32_t* hh = (uint32_t*)(psum + (size_t)rows * nblk * 4);
  float* wbuf = (float*)(hh + (size_t)rows * iters);
  const float inv_n = (float)(1.0 / (double)n);

  // Phase 1: per-block maxima (nan propagates, as jnp.max).
  for (int s = 0; s < rows; ++s) {
    const float* l = lw + (size_t)s * n;
    float mx = -INFINITY;
    for (size_t i = gtid; i < (size_t)n; i += gstride) mx = nanmax(mx, ftz(l[i]));
    mx = block_reduce<true>(mx, red);
    if (tid == 0) pmax[(size_t)s * nblk + blockIdx.x] = mx;
  }
  for (size_t q = gtid; q < (size_t)rows * iters; q += gstride) {
    hh[q] = fmix(seeds[q / iters] + (uint32_t)(q % iters) * GOLDEN);
  }
  grid.sync();

  for (int s = 0; s < rows; ++s) {
    float mx = -INFINITY;
    for (int q = tid; q < nblk; q += NT) mx = nanmax(mx, pmax[(size_t)s * nblk + q]);
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
    float* wr = wbuf + (size_t)s * n;
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
      float* p = psum + ((size_t)s * nblk + blockIdx.x) * 4;
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
      const float* p = psum + ((size_t)s * nblk + q) * 4;
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

  // Phase 3: the sweep, then commit (selection or identity) and state copy.
  for (size_t q = gtid; q < (size_t)rows * n; q += gstride) {
    const int s = (int)(q / n);
    const int i = (int)(q % n);
    const float* wr = wbuf + (size_t)s * n;
    int k = i;
    float wk = wr[i];
    sweep(wr, offsets + (size_t)s * iters, hh + (size_t)s * iters, iters, i, n, k, wk);
    if (!(row_flag[s] & 2)) k = i;
    anc[q] = k;
    for (int c = 0; c < d; ++c) {
      const size_t plane = ((size_t)s * d + c) * n;
      out[plane + i] = state[plane + k];
    }
  }
}

static size_t step_smem_bytes(int rows) { return (size_t)rows * 8; }

extern "C" {

int megopolis_fused_rows(const void* w, const void* state, const void* offsets,
                         const void* seeds, void* anc, void* out, int rows, int n,
                         int d, int iters, void* stream) {
  dim3 grid((n + NT - 1) / NT, rows);
  megopolis_fused_rows_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)state, (const int*)offsets,
      (const uint32_t*)seeds, (int*)anc, (float*)out, n, d, iters);
  return (int)cudaGetLastError();
}

// Blocks of the cooperative step grid for a bank of `rows` rows: as many as
// can be co-resident on the current device, and no more than the work needs.
int megopolis_step_grid(int rows, int n, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, megopolis_step_rows_kernel, NT, step_smem_bytes(rows));
  if (err != cudaSuccess) return (int)err;
  const long long need = ((long long)rows * n + NT - 1) / NT;
  long long g = (long long)per_sm * sms;
  if (g > need) g = need;
  *blocks = (int)(g < 1 ? 1 : g);
  return per_sm < 1 ? (int)cudaErrorCooperativeLaunchTooLarge : 0;
}

int megopolis_step_rows(const void* lw, const void* state, const void* offsets,
                        const void* seeds, float thr, void* anc, void* out,
                        void* stats, void* scratch, int rows, int n, int d, int iters,
                        int blocks, void* stream) {
  const float* a_lw = (const float*)lw;
  const float* a_state = (const float*)state;
  const int* a_off = (const int*)offsets;
  const uint32_t* a_seeds = (const uint32_t*)seeds;
  int* a_anc = (int*)anc;
  float* a_out = (float*)out;
  float* a_stats = (float*)stats;
  float* a_scratch = (float*)scratch;
  void* args[] = {(void*)&a_lw, (void*)&a_state, (void*)&a_off, (void*)&a_seeds, (void*)&thr, (void*)&a_anc, (void*)&a_out,
                  (void*)&a_stats, (void*)&a_scratch, (void*)&rows, (void*)&n,
                  (void*)&d, (void*)&iters};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)megopolis_step_rows_kernel, dim3(blocks), dim3(NT), args,
      step_smem_bytes(rows), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
