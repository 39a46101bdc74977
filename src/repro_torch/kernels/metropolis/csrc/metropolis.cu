// Metropolis resampling (paper Alg. 2, the random-access baseline) for
// NVIDIA Hopper (sm_90a).
//
// Two kernels with a plain C interface, built by repro_torch/kernels/build.py
// and bound with ctypes by repro_torch/kernels/metropolis/metropolis.py, as
// the Megopolis kernels are.  Every entry point launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().  Their plain
// PyTorch versions are in ../ref.py; the hash, the flushes, the block
// reductions and the step prelude are shared with the Megopolis kernels in
// ../../common.cuh.
//
// At iteration b particle i proposes j = hash_bits(seed, i, b) mod N, a
// uniform index over the whole row, and accepts it when
// u·w[k] <= w[j], u = hash_uniform(seed, i + N, b), with w[k] carried by
// value: repro/kernels/metropolis/ref.py:metropolis_ref term for term.
//
// metropolis_rows_kernel<GATHER> replaces four TPU kernels
// (repro/kernels/metropolis/metropolis.py): with GATHER = false,
// metropolis_pallas and metropolis_pallas_batch (_kernel, _kernel_batch),
// ancestors only; with GATHER = true, metropolis_pallas_fused and
// metropolis_pallas_fused_batch (_kernel_fused, _kernel_fused_batch), the
// sweep plus the copy of each ancestor's state.  A bank of S rows, one seed
// per row (a single population is a bank of one row).
//
//   What bounds it: per row it must move w (4N bytes), the ancestors (4N)
//   and, with GATHER, the state in and out (8DN): 8 MiB at N = 2^20 without
//   state, about 2.5 us at 3.35 TB/s.  The sweep does B·N proposals, each
//   at least 24 32-bit operations (two murmur3 finalizers 16, two lane
//   xors 2, the unsigned modulo by N counted as one though it compiles to a
//   dozen or more instructions, the shift, conversion and scale 3, the
//   product and the compare 2), the count chip_smoke.py's bound uses: at
//   B = 32 some 8·10^8 operations, 12 us at 67 T/s, so the operations bound
//   it.  But every w[j] is a random 4-byte read over the row: each touches
//   its own 32-byte L2 sector, B·N·32 bytes of sector traffic (1 GiB at
//   N = 2^20, B = 32).  That is the paper's point, and the design keeps it: the reads
//   are left uncoalesced, as Alg. 2 makes them.
//   What the design does about it: one thread per particle, the B-loop in
//   registers, w[k] carried by value, and fmix(seed + b·GOLDEN), the
//   per-iteration half of both hashes, computed once per block into shared
//   memory.  The working set is one row's weights, 4 MiB at N = 2^20, well
//   inside the 50 MB L2, so the random reads are L2 hits after the first
//   touch.  Blocks are numbered particle-fastest (grid.x over a row's
//   particles, grid.y over the rows) and issued roughly in that order, so at
//   any time the resident blocks (132 SMs × 8 blocks × 256 threads, a
//   quarter of a row at N = 2^20) cover one or two rows: a bank's working
//   set in L2 stays a row or two, not S rows.
//
// metropolis_step_rows_kernel replaces metropolis_pallas_step and
// metropolis_pallas_step_rows (_kernel_step, _kernel_step_rows): the fused
// SMC step with the Alg. 2 sweep, on the cooperative single-launch design of
// megopolis_step_rows_kernel: the shared prelude (two grid.sync() barriers,
// per-block partials reduced in a fixed order, exp(lw - m) written once to
// scratch), then the sweep over that scratch and the commit of the
// selection or the identity.  The TPU kernel recomputes exp(lw_full - m) at
// every grid step; here it is computed once per particle.
//
//   What bounds it: the bytes of the fused kernel plus one more read of lw,
//   and the same integer work and L2 sector traffic.
//
// Subnormals: built with -ftz=true, and flushed explicitly (ftz()) on the
// values selection depends on, as XLA does on the CPU.

#include "../../common.cuh"

// cnt iterations of the Alg. 2 sweep for particle i of a row of n; hh[t] =
// fmix(seed + b·GOLDEN) for iteration b = b0 + t.  (uint32)(i + n) is the
// accept lane; i + n < 2^31 for n <= 2^30.
__device__ __forceinline__ void metropolis_sweep(const float* __restrict__ w,
                                                 const uint32_t* hh, int cnt, int i, int n,
                                                 int& k, float& wk) {
  const uint32_t lane_j = (uint32_t)i * GOLDEN;
  const uint32_t lane_u = ((uint32_t)i + (uint32_t)n) * GOLDEN;
  for (int t = 0; t < cnt; ++t) {
    const uint32_t h = hh[t];
    const int j = (int)(fmix(h ^ lane_j) % (uint32_t)n);  // Alg. 2 line 5
    const float wj = ftz(__ldg(w + j));                    // a random read
    const float u = bits_to_uniform(fmix(h ^ lane_u));
    if (ftz(__fmul_rn(u, wk)) <= wj) {  // u <= w[j] / w[k]
      k = j;
      wk = wj;
    }
  }
}

template <bool GATHER>
__global__ void __launch_bounds__(NT) metropolis_rows_kernel(
    const float* __restrict__ w, const float* __restrict__ state,
    const uint32_t* __restrict__ seeds, int* __restrict__ anc, float* __restrict__ out,
    int n, int d, int iters) {
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
      s_hh[t] = fmix(seed + (uint32_t)(b0 + t) * GOLDEN);
    }
    __syncthreads();
    if (live) metropolis_sweep(wr, s_hh, cnt, i, n, k, wk);
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

__global__ void __launch_bounds__(NT) metropolis_step_rows_kernel(
    const float* __restrict__ lw, const float* __restrict__ state,
    const uint32_t* __restrict__ seeds, float thr, int* __restrict__ anc,
    float* __restrict__ out, float* __restrict__ stats, float* __restrict__ scratch,
    int rows, int n, int d, int iters) {
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
    metropolis_sweep(wr, sc.hh + (size_t)s * iters, iters, i, n, k, wk);
    if (!(row_flag[s] & 2)) k = i;
    anc[q] = k;
    for (int c = 0; c < d; ++c) {
      const size_t plane = ((size_t)s * d + c) * n;
      out[plane + i] = state[plane + k];
    }
  }
}

extern "C" {

// The index-only sweep: ancestors of a bank, no state.
int metropolis_rows(const void* w, const void* seeds, void* anc, int rows, int n, int iters,
                    void* stream) {
  dim3 grid((n + NT - 1) / NT, rows);
  metropolis_rows_kernel<false><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)w, nullptr, (const uint32_t*)seeds, (int*)anc, nullptr, n, 0, iters);
  return (int)cudaGetLastError();
}

int metropolis_fused_rows(const void* w, const void* state, const void* seeds, void* anc,
                          void* out, int rows, int n, int d, int iters, void* stream) {
  dim3 grid((n + NT - 1) / NT, rows);
  metropolis_rows_kernel<true><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)state, (const uint32_t*)seeds, (int*)anc, (float*)out,
      n, d, iters);
  return (int)cudaGetLastError();
}

int metropolis_step_grid(int rows, int n, int* blocks) {
  return coop_step_grid(metropolis_step_rows_kernel, rows, n, blocks);
}

int metropolis_step_rows(const void* lw, const void* state, const void* seeds, float thr,
                         void* anc, void* out, void* stats, void* scratch, int rows, int n,
                         int d, int iters, int blocks, void* stream) {
  const float* a_lw = (const float*)lw;
  const float* a_state = (const float*)state;
  const uint32_t* a_seeds = (const uint32_t*)seeds;
  int* a_anc = (int*)anc;
  float* a_out = (float*)out;
  float* a_stats = (float*)stats;
  float* a_scratch = (float*)scratch;
  void* args[] = {(void*)&a_lw, (void*)&a_state, (void*)&a_seeds, (void*)&thr,
                  (void*)&a_anc, (void*)&a_out, (void*)&a_stats, (void*)&a_scratch,
                  (void*)&rows, (void*)&n, (void*)&d, (void*)&iters};
  return coop_step_launch(metropolis_step_rows_kernel, blocks, rows, args, stream);
}

}  // extern "C"
