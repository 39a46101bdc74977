// Metropolis-C1 and -C2 resampling (paper Algs. 3-4, Dülger's
// segment-local variants of the Metropolis baseline) for NVIDIA Hopper
// (sm_90a).
//
// Two kernels with a plain C interface, built by repro_torch/kernels/build.py
// and bound with ctypes by repro_torch/kernels/metropolis/c1c2.py, as the
// Metropolis kernels are.  Every entry point launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().  Their plain
// PyTorch versions are in ../ref.py; the hash, the flushes and the step
// prelude are shared with the other kernels in ../../common.cuh.
//
// At iteration b particle i proposes j = p·1024 + (hash_bits(seed, i, b) mod
// 1024), a random lane of the partition tile p, and accepts it when
// u·w[k] <= w[j], u = hash_uniform(seed, i + N, b), with w[k] carried by
// value: repro/kernels/metropolis/ref.py:_partition_body term for term.  The
// variants differ only in how the partition table is indexed (one row of it
// per bank row, T = N / 1024 own tiles):
//   VARIANT 1 (C1, Alg. 3): p = part[i / 1024], one tile kept for all B
//     iterations (table int32[T]);
//   VARIANT 2 (C2, Alg. 4): p = part[(i / 1024)·B + b], a fresh tile at every
//     iteration (table int32[T·B], row-major by tile).
//
// metropolis_c1c2_rows_kernel<VARIANT, GATHER> replaces four TPU kernels of
// repro/kernels/metropolis/c1c2.py: with GATHER = false, metropolis_c1_pallas
// and metropolis_c2_pallas (ancestors only); with GATHER = true,
// metropolis_c1_pallas_fused and metropolis_c2_pallas_fused (via
// _c1c2_fused_call: the sweep plus the copy of each ancestor's state).  A
// bank of S rows, one seed and one table row per row (a single population is
// a bank of one row).
//
//   What bounds it: per row it must move w (4N bytes), the ancestors (4N)
//   and, with GATHER, the state in and out (8DN); the partition tiles add
//   4N bytes for C1 and 4·B·N bytes for C2 of reads that hit L2 (C2: 128 MiB
//   at N = 2^20, B = 32).  The sweep does B·N proposals of about 24 32-bit
//   operations each (two murmur3 finalizers 16, two lane xors 2, the mask
//   and the index add 2, shift, conversion and scale 3, product and compare
//   2, less the modulo Alg. 2 needs): at B = 32, N = 2^20 some 8·10^8
//   operations, 12 us at 67 T/s, so the operations bound it.
//   What the design does about it: the TPU's "partition tile fetched by the
//   BlockSpec" becomes shared memory.  One block of NT threads owns one own
//   tile of 1024 particles (4 a thread, strided by NT, so every load and
//   store is coalesced) and its partition tile: C1 loads its 4 KiB once,
//   coalesced, and keeps it for all B iterations, one transaction amortised
//   over B, which is the variant's point; C2 loads a fresh 4 KiB tile at
//   every iteration, with a __syncthreads() on either side (double buffering
//   with cp.async or TMA is for a later PR).  The proposal is a random read
//   of shared memory, not of L2 as in Alg. 2.  fmix(seed + b·GOLDEN), the
//   per-iteration half of both hashes, is computed once per block into
//   shared memory, as metropolis_rows_kernel does.
//
// metropolis_c1c2_step_rows_kernel<VARIANT> replaces metropolis_c1_pallas_step
// and metropolis_c2_pallas_step (via _c1c2_step_call): the fused SMC step, one
// cooperative launch on the design of metropolis_step_rows_kernel.  The shared
// prelude (two grid.sync() barriers) writes exp(lw - m) once to scratch; then
// each block grid-strides over (row, own tile) pairs, so that a block owns
// whole tiles and their shared partition, reads the partition tiles from
// that scratch into shared memory, and commits the selection or the identity
// and copies the state.  The TPU kernel recomputes exp(lw - m) for its own
// and its partition tile at every grid step; here it is computed once per
// particle.
//
//   What bounds it: the bytes of the fused kernel plus one more read of lw,
//   the same integer work and partition traffic, and the prelude.
//
// Subnormals: built with -ftz=true, and flushed explicitly (ftz()) on the
// values selection depends on, as XLA does on the CPU.

#include "../../common.cuh"

#define SEG 1024
#define PER_THREAD (SEG / NT)

// Copy one partition tile of weights into shared memory, flushed; called by
// every thread of the block, coalesced.
__device__ __forceinline__ void load_partition(float* s_part, const float* w_tile) {
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    s_part[q * NT + threadIdx.x] = ftz(w_tile[q * NT + threadIdx.x]);
  }
}

// The sweep state of one thread's PER_THREAD particles of one own tile:
// their lanes (i·GOLDEN and the accept lane (uint32)(i + N)·GOLDEN), their
// ancestors k and the carried w[k], and the partition's first particle.
struct C1C2Lanes {
  uint32_t lane_j[PER_THREAD];
  uint32_t lane_u[PER_THREAD];
  int k[PER_THREAD];
  float wk[PER_THREAD];
  int base;
};

// Start the sweep of own tile `tile` of a row of n weights `wr` with the
// row's partition table `part`; C1 loads its one partition into s_part here
// (visible after the caller's next __syncthreads()).
template <int VARIANT>
__device__ __forceinline__ void c1c2_start(C1C2Lanes& t, const float* wr,
                                           const int* __restrict__ part, float* s_part,
                                           int tile, int n) {
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int i = tile * SEG + q * NT + threadIdx.x;
    t.lane_j[q] = (uint32_t)i * GOLDEN;
    t.lane_u[q] = ((uint32_t)i + (uint32_t)n) * GOLDEN;
    t.k[q] = i;
    t.wk[q] = ftz(wr[i]);
  }
  t.base = 0;
  if (VARIANT == 1) {
    t.base = part[tile] * SEG;  // Alg. 3: one partition for every iteration
    load_partition(s_part, wr + t.base);
  }
}

// Iterations b0 .. b0 + cnt - 1 of the sweep; hh[c] = fmix(seed + (b0 +
// c)·GOLDEN), readable by every thread.  Every thread of the block calls it.
template <int VARIANT>
__device__ __forceinline__ void c1c2_sweep(C1C2Lanes& t, const float* wr,
                                           const int* __restrict__ part, float* s_part,
                                           const uint32_t* hh, int tile, int iters, int b0,
                                           int cnt) {
  for (int c = 0; c < cnt; ++c) {
    if (VARIANT == 2) {
      __syncthreads();  // every thread is done with the previous partition
      t.base = part[(size_t)tile * iters + b0 + c] * SEG;  // Alg. 4: a fresh partition
      load_partition(s_part, wr + t.base);
      __syncthreads();
    }
    const uint32_t h = hh[c];
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      const int jl = (int)(fmix(h ^ t.lane_j[q]) & (SEG - 1));  // U{0, N_w - 1}
      const float wj = s_part[jl];                                // a random shared read
      const float u = bits_to_uniform(fmix(h ^ t.lane_u[q]));
      if (ftz(__fmul_rn(u, t.wk[q])) <= wj) {  // u <= w[j] / w[k]
        t.k[q] = t.base + jl;
        t.wk[q] = wj;
      }
    }
  }
}

// The ancestors (the identity unless `keep`) and, with d > 0, the state copy
// of the thread's particles of one own tile of row s.
__device__ __forceinline__ void c1c2_commit(const C1C2Lanes& t, int* __restrict__ anc,
                                            const float* __restrict__ state,
                                            float* __restrict__ out, int s, int tile, int n,
                                            int d, bool keep) {
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int i = tile * SEG + q * NT + threadIdx.x;
    const int k = keep ? t.k[q] : i;
    anc[(size_t)s * n + i] = k;
    for (int c = 0; c < d; ++c) {
      const size_t plane = ((size_t)s * d + c) * n;
      out[plane + i] = state[plane + k];
    }
  }
}

// Grid (T, S): block (t, s) sweeps own tile t of row s.  The iteration
// prefixes go to shared memory in chunks of CHUNK.
template <int VARIANT, bool GATHER>
__global__ void __launch_bounds__(NT) metropolis_c1c2_rows_kernel(
    const float* __restrict__ w, const float* __restrict__ state,
    const int* __restrict__ parts, const uint32_t* __restrict__ seeds, int* __restrict__ anc,
    float* __restrict__ out, int n, int d, int iters) {
  __shared__ float s_part[SEG];
  __shared__ uint32_t s_hh[CHUNK];
  const int s = blockIdx.y;
  const int tile = blockIdx.x;
  const float* wr = w + (size_t)s * n;
  const int* part = parts + (size_t)s * (n / SEG) * (VARIANT == 1 ? 1 : iters);
  const uint32_t seed = seeds[s];
  C1C2Lanes t;
  c1c2_start<VARIANT>(t, wr, part, s_part, tile, n);
  for (int b0 = 0; b0 < iters; b0 += CHUNK) {
    const int cnt = min(CHUNK, iters - b0);
    __syncthreads();  // the previous chunk's prefixes and partition are no longer read
    for (int c = threadIdx.x; c < cnt; c += NT) s_hh[c] = fmix(seed + (uint32_t)(b0 + c) * GOLDEN);
    __syncthreads();
    c1c2_sweep<VARIANT>(t, wr, part, s_part, s_hh, tile, iters, b0, cnt);
  }
  c1c2_commit(t, anc, state, out, s, tile, n, GATHER ? d : 0, true);
}

template <int VARIANT>
__global__ void __launch_bounds__(NT) metropolis_c1c2_step_rows_kernel(
    const float* __restrict__ lw, const float* __restrict__ state,
    const int* __restrict__ parts, const uint32_t* __restrict__ seeds, float thr,
    int* __restrict__ anc, float* __restrict__ out, float* __restrict__ stats,
    float* __restrict__ scratch, int rows, int n, int d, int iters) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float row_m[];          // [rows] shift m per row
  int* row_flag = (int*)(row_m + rows);     // [rows] bit 0: degenerate, bit 1: do
  __shared__ float red[NT / 32];
  __shared__ float s_part[SEG];
  const StepScratch sc = step_scratch(scratch, rows, gridDim.x, iters);
  step_prelude(grid, lw, seeds, thr, stats, sc, row_m, row_flag, red, rows, n, iters);

  // The sweep over (row, own tile) pairs, so that a block owns whole tiles
  // and their partition, then commit (selection or identity) and state
  // copy.  sc.wbuf and sc.hh were written by every block before the
  // grid.sync(): plain loads, not the read-only path.
  const int tiles = n / SEG;
  const size_t pairs = (size_t)rows * tiles;
  for (size_t q = blockIdx.x; q < pairs; q += gridDim.x) {
    const int s = (int)(q / tiles);
    const int tile = (int)(q % tiles);
    const float* wr = sc.wbuf + (size_t)s * n;
    const int* part = parts + (size_t)s * tiles * (VARIANT == 1 ? 1 : iters);
    C1C2Lanes t;
    __syncthreads();  // the previous tile's partition is no longer read
    c1c2_start<VARIANT>(t, wr, part, s_part, tile, n);
    __syncthreads();
    c1c2_sweep<VARIANT>(t, wr, part, s_part, sc.hh + (size_t)s * iters, tile, iters, 0, iters);
    c1c2_commit(t, anc, state, out, s, tile, n, d, row_flag[s] & 2);
  }
}

template <int VARIANT, bool GATHER>
static int launch_rows(const void* w, const void* state, const void* parts,
                       const void* seeds, void* anc, void* out, int rows, int n, int d,
                       int iters, void* stream) {
  dim3 grid(n / SEG, rows);
  metropolis_c1c2_rows_kernel<VARIANT, GATHER><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)state, (const int*)parts, (const uint32_t*)seeds,
      (int*)anc, (float*)out, n, d, iters);
  return (int)cudaGetLastError();
}

template <int VARIANT>
static int launch_step(const void* lw, const void* state, const void* parts, const void* seeds,
                       float thr, void* anc, void* out, void* stats, void* scratch, int rows,
                       int n, int d, int iters, int blocks, void* stream) {
  const float* a_lw = (const float*)lw;
  const float* a_state = (const float*)state;
  const int* a_parts = (const int*)parts;
  const uint32_t* a_seeds = (const uint32_t*)seeds;
  int* a_anc = (int*)anc;
  float* a_out = (float*)out;
  float* a_stats = (float*)stats;
  float* a_scratch = (float*)scratch;
  void* args[] = {(void*)&a_lw, (void*)&a_state, (void*)&a_parts, (void*)&a_seeds,
                  (void*)&thr, (void*)&a_anc, (void*)&a_out, (void*)&a_stats,
                  (void*)&a_scratch, (void*)&rows, (void*)&n, (void*)&d, (void*)&iters};
  return coop_step_launch(metropolis_c1c2_step_rows_kernel<VARIANT>, blocks, rows, args,
                          stream);
}

extern "C" {

// The sweep of a bank: ancestors, and the state copy when state is not null.
// variant 1 (C1) or 2 (C2); n % 1024 == 0.
int metropolis_c1c2_rows(int variant, const void* w, const void* state, const void* parts,
                         const void* seeds, void* anc, void* out, int rows, int n, int d,
                         int iters, void* stream) {
  if (variant == 1) {
    return state ? launch_rows<1, true>(w, state, parts, seeds, anc, out, rows, n, d, iters,
                                        stream)
                 : launch_rows<1, false>(w, state, parts, seeds, anc, out, rows, n, 0, iters,
                                         stream);
  }
  return state ? launch_rows<2, true>(w, state, parts, seeds, anc, out, rows, n, d, iters,
                                      stream)
               : launch_rows<2, false>(w, state, parts, seeds, anc, out, rows, n, 0, iters,
                                       stream);
}

int metropolis_c1c2_step_grid(int variant, int rows, int n, int* blocks) {
  return variant == 1 ? coop_step_grid(metropolis_c1c2_step_rows_kernel<1>, rows, n, blocks)
                      : coop_step_grid(metropolis_c1c2_step_rows_kernel<2>, rows, n, blocks);
}

int metropolis_c1c2_step_rows(int variant, const void* lw, const void* state,
                              const void* parts, const void* seeds, float thr, void* anc,
                              void* out, void* stats, void* scratch, int rows, int n, int d,
                              int iters, int blocks, void* stream) {
  return variant == 1 ? launch_step<1>(lw, state, parts, seeds, thr, anc, out, stats, scratch,
                                       rows, n, d, iters, blocks, stream)
                      : launch_step<2>(lw, state, parts, seeds, thr, anc, out, stats, scratch,
                                       rows, n, d, iters, blocks, stream);
}

// Kernel `which` of this file's resource table rows, in the order of
// repro_torch/analysis/smem.py: kernel_attributes' four numbers.
int c1c2_attributes(int which, int dynamic_smem, int* out) {
  switch (which) {
    case 0: return kernel_attributes(metropolis_c1c2_rows_kernel<1, false>, dynamic_smem, out);
    case 1: return kernel_attributes(metropolis_c1c2_rows_kernel<1, true>, dynamic_smem, out);
    case 2: return kernel_attributes(metropolis_c1c2_rows_kernel<2, false>, dynamic_smem, out);
    case 3: return kernel_attributes(metropolis_c1c2_rows_kernel<2, true>, dynamic_smem, out);
    case 4: return kernel_attributes(metropolis_c1c2_step_rows_kernel<1>, dynamic_smem, out);
    case 5: return kernel_attributes(metropolis_c1c2_step_rows_kernel<2>, dynamic_smem, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
