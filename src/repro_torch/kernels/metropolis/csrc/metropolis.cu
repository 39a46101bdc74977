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
//   are left uncoalesced, as Alg. 2 makes them.  The kernel moves about
//   4.4 TB/s of sectors, more than the 3.86 TB/s one PyTorch gather reaches
//   (chip_smoke.gather_probe); more reads in flight, a remainder by a 64-bit
//   constant and a larger L1 each left its time where it is (PERF.md §6).
//   Whether 4.4 TB/s is the card's limit for random sectors is not known.
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
// Plane words (DESIGN.md §14): each kernel is a template on the word T of
// its weight planes, float, __nv_bfloat16 or __half, and on the word S of
// its state (StateWord<T>, or uint32_t beside a 2-byte T: by_words in
// ../../common.cuh), picked by the C entry points' `plane` and `sb`.  Each
// weight read is
// upcast to f32 and flushed (load_plane in ../../common.cuh): the random
// read w[j] becomes a 2-byte load and still moves one 32-byte sector, and
// the sweep's arithmetic is the float32 kernel's.  The state is copied as
// S words, bit moves; the step's prelude writes exp(lw - m) rounded to T,
// as T.
//
// Subnormals: built with -ftz=true, and flushed explicitly (ftz()) on the
// values selection depends on, as XLA does on the CPU.

#include "../../common.cuh"

// cnt iterations of the Alg. 2 sweep for particle i of a row of n plane
// words; hh[t] = fmix(seed + b·GOLDEN) for iteration b = b0 + t.
// (uint32)(i + n) is the accept lane; i + n < 2^31 for n <= 2^30.
template <class T>
__device__ __forceinline__ void metropolis_sweep(const T* __restrict__ w,
                                                 const uint32_t* hh, int cnt, int i, int n,
                                                 int& k, float& wk) {
  const uint32_t lane_j = (uint32_t)i * GOLDEN;
  const uint32_t lane_u = ((uint32_t)i + (uint32_t)n) * GOLDEN;
  for (int t = 0; t < cnt; ++t) {
    const uint32_t h = hh[t];
    const int j = (int)(fmix(h ^ lane_j) % (uint32_t)n);  // Alg. 2 line 5
    const float wj = load_plane(__ldg(w + j));             // a random read
    const float u = bits_to_uniform(fmix(h ^ lane_u));
    if (ftz(__fmul_rn(u, wk)) <= wj) {  // u <= w[j] / w[k]
      k = j;
      wk = wj;
    }
  }
}

template <bool GATHER, class T, class S>
__global__ void __launch_bounds__(NT) metropolis_rows_kernel(
    const T* __restrict__ w, const S* __restrict__ state,
    const uint32_t* __restrict__ seeds, int* __restrict__ anc, S* __restrict__ out,
    int n, int d, int iters) {
  __shared__ uint32_t s_hh[CHUNK];
  const int s = blockIdx.y;
  const int i = blockIdx.x * NT + threadIdx.x;
  const bool live = i < n;
  const T* wr = w + (size_t)s * n;
  const uint32_t seed = seeds[s];
  int k = i;
  float wk = live ? load_plane(wr[i]) : 0.0f;
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

// Eight blocks an SM (32 registers), as the float32 instance takes them
// unasked: free, the 2-byte instances took 40 registers and six blocks, and
// were 3-4% slower than float32 at S = 1 (PERF.md §6).
template <class T, class S>
__global__ void __launch_bounds__(NT, 8) metropolis_step_rows_kernel(
    const T* __restrict__ lw, const S* __restrict__ state,
    const uint32_t* __restrict__ seeds, float thr, int* __restrict__ anc,
    S* __restrict__ out, float* __restrict__ stats, float* __restrict__ scratch,
    int rows, int n, int d, int iters) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float row_m[];          // [rows] shift m per row
  int* row_flag = (int*)(row_m + rows);     // [rows] bit 0: degenerate, bit 1: do
  __shared__ float red[NT / 32];
  const StepScratch sc = step_scratch(scratch, rows, gridDim.x, iters);
  step_prelude(grid, lw, seeds, thr, stats, sc, row_m, row_flag, red, rows, n, iters);

  // The sweep on the requantised weights, then commit (selection or
  // identity) and state copy.
  const size_t gstride = (size_t)gridDim.x * NT;
  for (size_t q = (size_t)blockIdx.x * NT + threadIdx.x; q < (size_t)rows * n; q += gstride) {
    const int s = (int)(q / n);
    const int i = (int)(q % n);
    const T* wr = reinterpret_cast<const T*>(sc.wbuf) + (size_t)s * n;
    int k = i;
    float wk = plane_f32(wr[i]);
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

// Each entry point takes `plane`, the code of the weights' plane word
// (PLANE_F32, PLANE_BF16, PLANE_F16 in ../../common.cuh); those that copy
// state take `sb`, the bytes of its word (4 or 2), and launch the instance
// of that pair (by_words).

// The index-only sweep: ancestors of a bank, no state.
int metropolis_rows(const void* w, const void* seeds, void* anc, int rows, int n, int iters,
                    int plane, void* stream) {
  return by_plane(plane, [&](auto word) {
    using T = decltype(word);
    dim3 grid((n + NT - 1) / NT, rows);
    metropolis_rows_kernel<false, T, StateWord<T>><<<grid, NT, 0, (cudaStream_t)stream>>>(
        (const T*)w, nullptr, (const uint32_t*)seeds, (int*)anc, nullptr, n, 0, iters);
    return (int)cudaGetLastError();
  });
}

int metropolis_fused_rows(const void* w, const void* state, const void* seeds, void* anc,
                          void* out, int rows, int n, int d, int iters, int sb, int plane,
                          void* stream) {
  return by_words(plane, sb, [&](auto word, auto sword) {
    using T = decltype(word);
    using S = decltype(sword);
    dim3 grid((n + NT - 1) / NT, rows);
    metropolis_rows_kernel<true, T, S><<<grid, NT, 0, (cudaStream_t)stream>>>(
        (const T*)w, (const S*)state, (const uint32_t*)seeds, (int*)anc, (S*)out, n, d, iters);
    return (int)cudaGetLastError();
  });
}

int metropolis_step_grid(int rows, int n, int sb, int plane, int* blocks) {
  return by_words(plane, sb, [&](auto word, auto sword) {
    return coop_step_grid(metropolis_step_rows_kernel<decltype(word), decltype(sword)>, rows, n,
                          blocks);
  });
}

int metropolis_step_rows(const void* lw, const void* state, const void* seeds, float thr,
                         void* anc, void* out, void* stats, void* scratch, int rows, int n,
                         int d, int iters, int blocks, int sb, int plane, void* stream) {
  return by_words(plane, sb, [&](auto word, auto sword) {
    using T = decltype(word);
    using S = decltype(sword);
    const T* a_lw = (const T*)lw;
    const S* a_state = (const S*)state;
    const uint32_t* a_seeds = (const uint32_t*)seeds;
    int* a_anc = (int*)anc;
    S* a_out = (S*)out;
    float* a_stats = (float*)stats;
    float* a_scratch = (float*)scratch;
    void* args[] = {(void*)&a_lw, (void*)&a_state, (void*)&a_seeds, (void*)&thr,
                    (void*)&a_anc, (void*)&a_out, (void*)&a_stats, (void*)&a_scratch,
                    (void*)&rows, (void*)&n, (void*)&d, (void*)&iters};
    return coop_step_launch(metropolis_step_rows_kernel<T, S>, blocks, rows, args, stream);
  });
}

// Kernel `which` of this file's resource table rows, in the order of
// repro_torch/analysis/smem.py: 3·plane + 0 the index-only kernel, + 1 the
// fused one, + 2 the step, each with the plane's own state word
// (StateWord<T>); then 9 + 2·(plane - 1) + 0 the fused kernel and + 1 the
// step with a 4-byte state beside the 2-byte plane.
int metropolis_attributes(int which, int dynamic_smem, int* out) {
  const int plane = which < 9 ? which / 3 : 1 + (which - 9) / 2;
  const int sb = which < 9 ? (plane == PLANE_F32 ? 4 : 2) : 4;
  const int k = which < 9 ? which % 3 : 1 + (which - 9) % 2;
  return by_words(plane, sb, [&](auto word, auto sword) {
    using T = decltype(word);
    using S = decltype(sword);
    switch (k) {
      case 0: return kernel_attributes(metropolis_rows_kernel<false, T, StateWord<T>>,
                                       dynamic_smem, out);
      case 1: return kernel_attributes(metropolis_rows_kernel<true, T, S>, dynamic_smem, out);
      default: return kernel_attributes(metropolis_step_rows_kernel<T, S>, dynamic_smem, out);
    }
  });
}

}  // extern "C"
