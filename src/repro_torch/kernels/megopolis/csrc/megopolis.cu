// Megopolis resampling (paper Alg. 5) for NVIDIA Hopper (sm_90a).
//
// Two kernels with a plain C interface, built by repro_torch/kernels/build.py
// (nvcc -gencode arch=compute_90a,code=sm_90a -O3 -ftz=true -shared) and
// bound with ctypes by repro_torch/kernels/megopolis/megopolis.py.  Every
// entry point launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().  Their plain PyTorch versions are in ../ref.py; the
// hash, the flushes, the block reductions and the step prelude they share
// with the Metropolis kernels are in ../../common.cuh.
//
// megopolis_fused_rows_kernel<GATHER> replaces four TPU kernels
// (repro/kernels/megopolis/megopolis.py): with GATHER = false,
// megopolis_pallas and megopolis_pallas_batch (_kernel, _kernel_batch), the
// Alg. 5 sweep over B iterations writing ancestors only; with GATHER = true,
// megopolis_pallas_fused and megopolis_pallas_fused_rows (_kernel_fused,
// _kernel_fused_rows), the sweep plus the copy of each ancestor's state.  It
// runs a bank of S rows (a single population is a bank of one row); the
// bank-shared offset table of megopolis_pallas_batch is the one-row table
// expanded to [S, B] by the wrapper.
//
//   What bounds it: per row it must move w (4N bytes), the ancestors (4N)
//   and, with GATHER, the state in and out (8DN): 16 MiB at N = 2^20, D = 1,
//   about 5 us at 3.35 TB/s (8 MiB, 2.5 us, without the state).  The sweep
//   does B·N comparisons, each about 20 32-bit operations (the index map,
//   one murmur3 finalizer, the float conversion, the product and the
//   select): at B = 32 that is 6.7·10^8 operations, about 10 us at the
//   67 T/s of 32-bit arithmetic outside the tensor cores, so the operations
//   bound it, not the bytes.
//   What the design does about it: one thread per particle, the B-loop in
//   registers with w[k] carried by value (never re-read), and the
//   per-iteration part of the hash, fmix(seed + b·GOLDEN), computed once per
//   block into shared memory rather than by every lane.  For a fixed b the
//   lanes of a warp read consecutive j (at most one wrap), so every w[j]
//   read is coalesced: the paper's argument, at segment 1024 as on the TPU.
//   GATHER is a template argument, so the state loop and its pointers are
//   compiled out of the index-only instance and the fused one is unchanged.
//
// megopolis_step_rows_kernel replaces megopolis_pallas_step and
// megopolis_pallas_step_rows (_kernel_step, _kernel_step_rows): the fused SMC
// step.  The prelude (step_prelude in ../../common.cuh) mirrors step_stats
// (repro/kernels/common.py): m = max(lw), the degenerate flag, the sums of
// exp(lw - m), w and w^2 and max(w), then the trigger ess_norm < thr; the
// sweep runs on exp(lw - m) (or on 1/N for a degenerate row) and commits the
// selection, or the identity where the trigger did not fire.
//
//   What bounds it: the bytes of the fused kernel plus one more read of lw,
//   and the same integer work; the integer work bounds it here too.
//   What the design does about it: the TPU runs the prelude once, at grid
//   step (0, 0), and latches it in SMEM; blocks on this card run in no
//   order, so the kernel is one cooperative launch whose grid is sized to be
//   co-resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and walks the
//   particles with grid-stride loops, with the prelude's two grid.sync()
//   barriers.  Per-block partials are reduced in one fixed order, so the
//   stats are the same from run to run (no float atomics).  The weights
//   exp(lw - m) are written once to scratch in the sums pass and read by the
//   sweep.  expf (not __expf) keeps the weights bit-identical to torch.exp
//   on the card.  __launch_bounds__(NT, 8) holds it to 32 registers, so 8
//   blocks fit an SM and the grid is 8 blocks per SM: with the prelude
//   inlined from common.cuh, ptxas would otherwise take 40 registers and
//   fit 6.
//
// Subnormals: built with -ftz=true, and flushed explicitly (ftz()) on the
// values selection depends on, as XLA does on the CPU.  State copies are bit
// moves and are never flushed.

#include "../../common.cuh"

#define SEG 1024

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
    const float u = bits_to_uniform(fmix(hh[t] ^ lane));
    if (ftz(__fmul_rn(u, wk)) <= wj) {  // u <= w[j] / w[k]   (Alg. 5 line 13)
      k = j;
      wk = wj;
    }
  }
}

template <bool GATHER>
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
  if (GATHER) {
    for (int c = 0; c < d; ++c) {
      const size_t plane = ((size_t)s * d + c) * n;
      out[plane + i] = state[plane + k];
    }
  }
}

__global__ void __launch_bounds__(NT, 8) megopolis_step_rows_kernel(
    const float* __restrict__ lw, const float* __restrict__ state,
    const int* __restrict__ offsets, const uint32_t* __restrict__ seeds, float thr,
    int* __restrict__ anc, float* __restrict__ out, float* __restrict__ stats,
    float* __restrict__ scratch, int rows, int n, int d, int iters) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float row_m[];          // [rows] shift m per row
  int* row_flag = (int*)(row_m + rows);     // [rows] bit 0: degenerate, bit 1: do
  __shared__ float red[NT / 32];
  const StepScratch sc = step_scratch(scratch, rows, gridDim.x, iters);
  step_prelude(grid, lw, seeds, thr, stats, sc, row_m, row_flag, red, rows, n, iters);

  // The sweep, then commit (selection or identity) and state copy.
  const size_t gstride = (size_t)gridDim.x * NT;
  for (size_t q = (size_t)blockIdx.x * NT + threadIdx.x; q < (size_t)rows * n; q += gstride) {
    const int s = (int)(q / n);
    const int i = (int)(q % n);
    const float* wr = sc.wbuf + (size_t)s * n;
    int k = i;
    float wk = wr[i];
    sweep(wr, offsets + (size_t)s * iters, sc.hh + (size_t)s * iters, iters, i, n, k, wk);
    if (!(row_flag[s] & 2)) k = i;
    anc[q] = k;
    for (int c = 0; c < d; ++c) {
      const size_t plane = ((size_t)s * d + c) * n;
      out[plane + i] = state[plane + k];
    }
  }
}

extern "C" {

int megopolis_fused_rows(const void* w, const void* state, const void* offsets,
                         const void* seeds, void* anc, void* out, int rows, int n,
                         int d, int iters, void* stream) {
  dim3 grid((n + NT - 1) / NT, rows);
  megopolis_fused_rows_kernel<true><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)state, (const int*)offsets,
      (const uint32_t*)seeds, (int*)anc, (float*)out, n, d, iters);
  return (int)cudaGetLastError();
}

// The index-only sweep: ancestors of a bank, no state.
int megopolis_rows(const void* w, const void* offsets, const void* seeds, void* anc,
                   int rows, int n, int iters, void* stream) {
  dim3 grid((n + NT - 1) / NT, rows);
  megopolis_fused_rows_kernel<false><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)w, nullptr, (const int*)offsets, (const uint32_t*)seeds, (int*)anc,
      nullptr, n, 0, iters);
  return (int)cudaGetLastError();
}

int megopolis_step_grid(int rows, int n, int* blocks) {
  return coop_step_grid(megopolis_step_rows_kernel, rows, n, blocks);
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
  void* args[] = {(void*)&a_lw, (void*)&a_state, (void*)&a_off, (void*)&a_seeds,
                  (void*)&thr, (void*)&a_anc, (void*)&a_out, (void*)&a_stats,
                  (void*)&a_scratch, (void*)&rows, (void*)&n, (void*)&d, (void*)&iters};
  return coop_step_launch(megopolis_step_rows_kernel, blocks, rows, args, stream);
}

}  // extern "C"
