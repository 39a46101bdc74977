// Rejection resampling (Murray's unbiased baseline, paper §1) for NVIDIA
// Hopper (sm_90a).
//
// Two kernels with a plain C interface, built by repro_torch/kernels/build.py
// and bound with ctypes by repro_torch/kernels/rejection/rejection.py, as the
// Metropolis kernels are.  Every entry point launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().  Their plain
// PyTorch versions are in ../ref.py; the hash, the flushes and the step
// prelude are shared with the other families in ../../common.cuh.
//
// Particle i first proposes itself (round 0), accepted when
// u0·sup w <= w[i]; then at rounds t = 1 .. max_iters it proposes
// j = hash_bits(seed, i, t) mod N and accepts when u·sup w <= w[j], with
// u = hash_uniform(seed, i + N, t): the Metropolis hash lanes,
// repro/kernels/rejection/ref.py:rejection_ref term for term.  The TPU
// kernel runs every lane through all max_iters rounds under a done mask.
// Here a thread leaves at its first accept: k and done never change after
// it, so the ancestors are the same bit for bit.  A lane that never accepts
// keeps k = i, as the JAX code does (its docstrings say the last proposal
// is kept; the code keeps i).  u·sup w is taken in the order XLA gives it
// on the CPU, (bits >> 8)·ftz(sup w·2^-24): the same product bit for bit
// while sup w >= 2^-102, and below that every lane accepts its
// self-proposal, as the JAX package does (ROADMAP Queue C, item 13).
//
// rejection_rows_kernel<GATHER> replaces four TPU kernels
// (repro/kernels/rejection/rejection.py): with GATHER = false,
// rejection_pallas and rejection_pallas_batch, ancestors only; with
// GATHER = true, rejection_pallas_fused and rejection_pallas_fused_batch,
// the chain plus the copy of each ancestor's state.  A bank of S rows, one
// seed and one sup w per row (a single population is a bank of one row);
// sup w is reduced by the wrapper (torch.amax), as the JAX wrappers reduce
// it outside their kernels.
//
//   What bounds it: per row it must move w (4N bytes), the ancestors (4N)
//   and, with GATHER, the state in and out (8DN), plus the 4N of the
//   wrapper's sup w pass: 12 MiB at N = 2^20 without state, 3.8 us at
//   3.35 TB/s.  The operations are the realised rounds, not max_iters:
//   about 24 32-bit operations a round (the Metropolis count), summed over
//   the lanes' (accept round + 1).  Each round past 0 also reads one random
//   w[j], its own 32-byte L2 sector.  Neither is what sets the time: a
//   warp runs until its slowest lane accepts, and the number of rounds a
//   lane needs is geometric with mean sup w / mean w, so the warp's maximum
//   sits far above the lanes' mean (paper §1's divergence; chip_smoke.py
//   prints both).
//   What the design does about it: one thread per particle, the grid
//   particle-fastest (grid.x over a row's particles, grid.y over the rows),
//   as metropolis_rows_kernel, so one row's weights are the L2 working set;
//   each thread leaves the chain at its first accept, and each block stops
//   when its last lane is done: the per-round half of the hash,
//   fmix(seed + t·GOLDEN), is computed once per block into shared memory in
//   chunks of CHUNK rounds, and a __syncthreads_or(!done) before each chunk
//   lets the block stop.  Computing it in each thread instead (8 more
//   operations a round, no barrier) measured 6-14% faster at S = 1 (2 us
//   at most) and 0.5-7% slower at S = 16 (up to 60 us) on Path A's
//   weights (PERF.md); the chunks stay.
//
// rejection_step_rows_kernel replaces rejection_pallas_step and
// rejection_pallas_step_rows: the fused SMC step on the cooperative
// single-launch design of metropolis_step_rows_kernel, on the shared
// prelude of common.cuh with iters = max_iters + 1, so that its hash
// prefixes hh cover rounds 0 .. max_iters.  The TPU prelude latches
// sup w = max(exp(lw - m)); on a row that is not degenerate that is
// exp(0) = 1.0f exactly (m is the row's max), and on a degenerate row the
// uniform 1/N.  So the kernel takes sup w = (row_flag & 1) ? 1/N : 1.0f
// and adds no reduction to the prelude, which stays as the six other step
// kernels compiled it (common.cuh unchanged).  The plain version takes the
// literal max; the tests and chip_smoke.py hold the two to each other.  A
// row whose trigger did not fire runs no round: it keeps the identity.
//
//   What bounds it: the bytes of the fused kernel plus one more read of lw,
//   and the realised rounds of the rows that resample.
//
// Subnormals: built with -ftz=true, and flushed explicitly (ftz()) on the
// values selection depends on, as XLA does on the CPU.

#include "../../common.cuh"

template <bool RO>
__device__ __forceinline__ float load_w(const float* w, int j) {
  return RO ? __ldg(w + j) : w[j];
}

// sup w·2^-24, the scale of u·sup w = (bits >> 8)·scale.
__device__ __forceinline__ float uniform_scale(float wmax) {
  return ftz(__fmul_rn(wmax, 1.0f / 16777216.0f));
}

// u·sup w at the accept lane's hash bits.
__device__ __forceinline__ float scaled_uniform(uint32_t bits, float scale) {
  return ftz(__fmul_rn((float)(bits >> 8), scale));
}

// The rounds of particle i after round 0, from the first whose hash prefix
// is hh[0], over cnt rounds; stops at the first accept and returns whether
// there was one.  lane_j = i·GOLDEN proposes, lane_u = (i + n)·GOLDEN
// accepts.  RO reads w through the read-only path (w is not written by the
// launch).
template <bool RO>
__device__ __forceinline__ bool rejection_chain(const float* __restrict__ w,
                                                const uint32_t* hh, int cnt, uint32_t lane_j,
                                                uint32_t lane_u, int n, float scale, int& k) {
  for (int t = 0; t < cnt; ++t) {
    const uint32_t h = hh[t];
    const int j = (int)(fmix(h ^ lane_j) % (uint32_t)n);
    // u <= w[j] / sup w
    if (scaled_uniform(fmix(h ^ lane_u), scale) <= ftz(load_w<RO>(w, j))) {
      k = j;
      return true;
    }
  }
  return false;
}

// Round 0: particle i proposes itself; h0 = fmix(seed).
__device__ __forceinline__ bool self_accept(uint32_t h0, uint32_t lane_u, float scale, float wi) {
  return scaled_uniform(fmix(h0 ^ lane_u), scale) <= ftz(wi);
}

template <bool GATHER>
__global__ void __launch_bounds__(NT) rejection_rows_kernel(
    const float* __restrict__ w, const float* __restrict__ wmax,
    const uint32_t* __restrict__ seeds, const float* __restrict__ state,
    int* __restrict__ anc, float* __restrict__ out, int n, int d, int max_iters) {
  __shared__ uint32_t s_hh[CHUNK];
  const int s = blockIdx.y;
  const int i = blockIdx.x * NT + threadIdx.x;
  const bool live = i < n;
  const float* wr = w + (size_t)s * n;
  const uint32_t seed = seeds[s];
  const float scale = uniform_scale(wmax[s]);
  // (uint32)(i + n) is the accept lane; i + n < 2^31 for n <= 2^30.
  const uint32_t lane_j = (uint32_t)i * GOLDEN;
  const uint32_t lane_u = ((uint32_t)i + (uint32_t)n) * GOLDEN;
  int k = i;
  bool done = !live || self_accept(fmix(seed), lane_u, scale, wr[i]);
  for (int t0 = 1; t0 <= max_iters; t0 += CHUNK) {
    // A barrier too: no thread still reads the previous chunk's prefixes.
    if (!__syncthreads_or(!done)) break;
    const int cnt = min(CHUNK, max_iters - t0 + 1);
    for (int t = threadIdx.x; t < cnt; t += NT) {
      s_hh[t] = fmix(seed + (uint32_t)(t0 + t) * GOLDEN);
    }
    __syncthreads();
    if (!done) done = rejection_chain<true>(wr, s_hh, cnt, lane_j, lane_u, n, scale, k);
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

__global__ void __launch_bounds__(NT) rejection_step_rows_kernel(
    const float* __restrict__ lw, const float* __restrict__ state,
    const uint32_t* __restrict__ seeds, float thr, int* __restrict__ anc,
    float* __restrict__ out, float* __restrict__ stats, float* __restrict__ scratch,
    int rows, int n, int d, int max_iters) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float row_m[];          // [rows] shift m per row
  int* row_flag = (int*)(row_m + rows);     // [rows] bit 0: degenerate, bit 1: do
  __shared__ float red[NT / 32];
  const int iters = max_iters + 1;          // hh[s·iters + t] for rounds t = 0 .. max_iters
  const StepScratch sc = step_scratch(scratch, rows, gridDim.x, iters);
  step_prelude(grid, lw, seeds, thr, stats, sc, row_m, row_flag, red, rows, n, iters);

  // The chain on the rows that resample, then commit (selection or
  // identity) and state copy.  sc.wbuf was written in this launch: plain
  // loads, not the read-only path.
  const float inv_n = (float)(1.0 / (double)n);
  const size_t gstride = (size_t)gridDim.x * NT;
  for (size_t q = (size_t)blockIdx.x * NT + threadIdx.x; q < (size_t)rows * n; q += gstride) {
    const int s = (int)(q / n);
    const int i = (int)(q % n);
    const int flag = row_flag[s];
    int k = i;
    if (flag & 2) {
      const float* wr = sc.wbuf + (size_t)s * n;
      const uint32_t* hh = sc.hh + (size_t)s * iters;
      // sup w = max(exp(lw - m)), see the note above.
      const float scale = uniform_scale((flag & 1) ? inv_n : 1.0f);
      const uint32_t lane_j = (uint32_t)i * GOLDEN;
      const uint32_t lane_u = ((uint32_t)i + (uint32_t)n) * GOLDEN;
      if (!self_accept(hh[0], lane_u, scale, wr[i])) {
        rejection_chain<false>(wr, hh + 1, max_iters, lane_j, lane_u, n, scale, k);
      }
    }
    anc[q] = k;
    for (int c = 0; c < d; ++c) {
      const size_t plane = ((size_t)s * d + c) * n;
      out[plane + i] = state[plane + k];
    }
  }
}

extern "C" {

// The chain over a bank: ancestors, and with state (not null) the copy of
// each ancestor's state.
int rejection_rows(const void* w, const void* wmax, const void* seeds, const void* state,
                   void* anc, void* out, int rows, int n, int d, int max_iters, void* stream) {
  dim3 grid((n + NT - 1) / NT, rows);
  const float* a_w = (const float*)w;
  const float* a_wmax = (const float*)wmax;
  const uint32_t* a_seeds = (const uint32_t*)seeds;
  const float* a_state = (const float*)state;
  cudaStream_t st = (cudaStream_t)stream;
  if (state == nullptr) {
    rejection_rows_kernel<false><<<grid, NT, 0, st>>>(a_w, a_wmax, a_seeds, a_state, (int*)anc,
                                                       (float*)out, n, d, max_iters);
  } else {
    rejection_rows_kernel<true><<<grid, NT, 0, st>>>(a_w, a_wmax, a_seeds, a_state, (int*)anc,
                                                      (float*)out, n, d, max_iters);
  }
  return (int)cudaGetLastError();
}

int rejection_step_grid(int rows, int n, int* blocks) {
  return coop_step_grid(rejection_step_rows_kernel, rows, n, blocks);
}

int rejection_step_rows(const void* lw, const void* state, const void* seeds, float thr,
                        void* anc, void* out, void* stats, void* scratch, int rows, int n,
                        int d, int max_iters, int blocks, void* stream) {
  const float* a_lw = (const float*)lw;
  const float* a_state = (const float*)state;
  const uint32_t* a_seeds = (const uint32_t*)seeds;
  int* a_anc = (int*)anc;
  float* a_out = (float*)out;
  float* a_stats = (float*)stats;
  float* a_scratch = (float*)scratch;
  void* args[] = {(void*)&a_lw, (void*)&a_state, (void*)&a_seeds, (void*)&thr,
                  (void*)&a_anc, (void*)&a_out, (void*)&a_stats, (void*)&a_scratch,
                  (void*)&rows, (void*)&n, (void*)&d, (void*)&max_iters};
  return coop_step_launch(rejection_step_rows_kernel, blocks, rows, args, stream);
}

// Kernel `which` of this file's resource table rows, in the order of
// repro_torch/analysis/smem.py: kernel_attributes' four numbers.
int rejection_attributes(int which, int dynamic_smem, int* out) {
  switch (which) {
    case 0: return kernel_attributes(rejection_rows_kernel<false>, dynamic_smem, out);
    case 1: return kernel_attributes(rejection_rows_kernel<true>, dynamic_smem, out);
    case 2: return kernel_attributes(rejection_step_rows_kernel, dynamic_smem, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
