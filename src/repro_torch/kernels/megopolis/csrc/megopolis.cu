// Megopolis resampling (paper Alg. 5) for NVIDIA Hopper (sm_90a).
//
// Two kernels with a plain C interface, built by repro_torch/kernels/build.py
// (nvcc -gencode arch=compute_90a,code=sm_90a -O3 -ftz=true -shared) and
// bound with ctypes by repro_torch/kernels/megopolis/megopolis.py.  Every
// entry point launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().  Their plain PyTorch versions are in ../ref.py; the
// hash, the flushes, the block reductions, the ring's mbarriers and bulk
// copies and the step prelude they share with the Metropolis kernels are in
// ../../common.cuh.
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
//   about 5 us at 3.35 TB/s.  The sweep does B·N comparisons, each about 20
//   32-bit operations (the index, one murmur3 finalizer, the float
//   conversion, the product and the select): at B = 32 that is 6.7·10^8
//   operations, about 10 us at the 67 T/s of 32-bit arithmetic outside the
//   tensor cores, so the operations bound it, not the bytes.  The design's
//   own floor is the comparison weights: for a fixed b every w value is read
//   once across the row, so B·N·4 bytes move from L2 to the SMs.
//   What the design does about it: the TPU kernel's data flow.  Its
//   BlockSpec fetches the aligned comparison tile (t + o_b / 1024) mod T into
//   VMEM, pipelined, and rolls it in place (_cmp_index, _sweep).  Here one
//   block of NT threads owns one 1024-particle segment of one row (4
//   particles a thread, strided by NT, carrying w[k] in registers), and for
//   iteration b its comparison segment ((i >> 10) + (o_b >> 10)) mod T moves
//   whole into a ring of shared-memory buffers, by bulk TMA copies
//   (cp.async.bulk ... mbarrier::complete_tx) that one thread starts AHEAD
//   iterations before the sweep reaches it.  The copies roll it as they land:
//   words a .. 1023 then 0 .. a + 3 of the segment (a + 7 at 2-byte words),
//   a = (o_b mod 1024) rounded down to the copies' 16-byte grain, so lane i
//   reads word (i mod 1024) + (o_b mod 4) (mod 8), with no index arithmetic
//   and no bank conflict
//   (consecutive lanes, consecutive words).  Each stage has a full mbarrier
//   (the copies' bytes) and an empty one (one arrival per warp); there is
//   no __syncthreads() per iteration.  No lane gathers w[j] from device
//   memory: a segment moves as 128 whole 32-byte sectors, 4 per
//   warp-iteration, where a warp's own gather of 32 consecutive j from (i +
//   o_b) mod 1024 touched 5 on 7 of 8 offsets.  A particle keeps the
//   iteration of its last accept, not its index, and forms its ancestor from
//   that iteration's offset once, at the end.  The per-iteration part of the
//   hash, fmix(seed + b·GOLDEN), and each iteration's segment and offset are
//   staged per chunk of CHUNK iterations in shared memory.  GATHER is a
//   template argument, so the state loop and its pointers are compiled out
//   of the index-only instance.
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
//   co-resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor), with the
//   prelude's two grid.sync() barriers.  Per-block partials are reduced in
//   one fixed order, so the stats are the same from run to run (no float
//   atomics).  The weights exp(lw - m) are written once to scratch in the
//   sums pass (expf, not __expf, keeps them bit-identical to torch.exp on the
//   card); then each block walks (row, segment) pairs in a grid-stride loop
//   and runs the sweep of the fused kernel on them (mego_sweep, one
//   function, so the two kernels cannot drift), its ring continuing from
//   pair to pair.  Its ring sits beside the per-row shift and flags: at the
//   most rows a step admits the block passes 48 KiB, so the kernel opts in
//   to more dynamic shared memory (smem_optin in ../../common.cuh).
//
// Plane words (DESIGN.md §14): every kernel is a template on the word T of
// its weight planes, float, __nv_bfloat16 or __half, and on the word S of
// its state (StateWord<T>, or uint32_t beside a 2-byte T: by_words in
// ../../common.cuh), picked by the C entry points' `plane` and `sb`.  At
// 2-byte words each plane's bytes halve: a comparison segment is 2 KiB, 8
// words to a 16-byte grain, so the ring's rotation, its buffer length (1032
// words) and the byte count each full barrier expects follow the plane word
// T, never S (MegoRing, ring_fill); a wrong count would hang the block on
// its barrier.  Each load is upcast to
// f32 (plane_f32, load_plane in ../../common.cuh): the sweep's arithmetic,
// the hash and the uniforms are the float32 kernel's.  The state is copied
// as S words.  The step's prelude rounds exp(lw - m) to T and writes it to
// scratch as T (step_prelude), so the sweep moves 2-byte words there too.
//
// Subnormals: every value selection depends on is flushed, as XLA does on
// the CPU: built with -ftz=true, the sweep's product and comparison flush
// their operands and results in hardware; the loaded w[k] and the step
// prelude's values are flushed explicitly (ftz()).  State copies are bit
// moves of S words and are never flushed: a 4-byte integer state (SMC
// decoding's token buffer) rides beside any plane, and every bit pattern,
// subnormal ones included, comes back as it went in.

#include "../../common.cuh"

#define SEG 1024
#define PER_THREAD (SEG / NT)
// Buffers of each kernel's ring (MegoRing's STAGES), at float32 words and at
// 2-byte words.  At float32 six are the most that keep 8 blocks on an SM.
// Chosen by measurement on the H100 (benchmarks/torch_kernel_ab.py, three
// and four in turns): three were 1-4% faster than four on both instances of
// the bank kernel, four 1-3% faster on the step, whose ring then needs the
// opt-in below at the most rows.  A 2-byte ring takes half the shared
// memory, so up to twelve buffers keep 8 blocks an SM by the occupancy
// rule (analysis/smem.py); six and eight (for both rings) were 3-8% slower
// than three and four on the bank kernels and within 1% on the step
// (PERF.md §6), so the 2-byte rings keep the same depths.
#define ROWS_STAGES 3     // megopolis_fused_rows_kernel<*, float>
#define STEP_STAGES 4     // megopolis_step_rows_kernel<float>
#define ROWS_STAGES_2B 3  // megopolis_fused_rows_kernel<*, __nv_bfloat16 / __half>
#define STEP_STAGES_2B 4  // megopolis_step_rows_kernel<__nv_bfloat16 / __half>

// The two rings' depths at plane word T.
template <class T>
struct Stages {
  static constexpr int ROWS = sizeof(T) == 4 ? ROWS_STAGES : ROWS_STAGES_2B;
  static constexpr int STEP = sizeof(T) == 4 ? STEP_STAGES : STEP_STAGES_2B;
};

// The ring of STAGES comparison segments of plane words T and the per-chunk
// table of a block: tab[t] = {(segment << 10) | (o_b & 1023), fmix(seed +
// b·GOLDEN)} for b = b0 + t; its first words run AHEAD entries past the
// chunk for the copies started ahead.  A buffer holds one comparison
// segment rotated by its offset, rounded down to the bulk copies' 16-byte
// grain (GRAIN words: 4 floats, 8 2-byte words), and GRAIN more words, so
// that lane i reads word (i mod 1024) + (o_b mod GRAIN) with no wrap.  A
// segment is requested AHEAD iterations before the sweep reaches it, so a
// buffer is refilled when every warp is done with the iteration two
// before: the one thread that starts the copies waits for the slowest warp
// with one iteration of slack.
template <class T, int STAGES>
struct MegoRing {
  static constexpr int AHEAD = STAGES - 2;
  static constexpr int GRAIN = 16 / (int)sizeof(T);
  static constexpr int WORDS = SEG + GRAIN;
  __align__(128) T seg[STAGES][WORDS];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
  uint2 tab[CHUNK + AHEAD];
};

// Request the comparison segment of the block's u-th iteration (counted over
// every segment the block sweeps) into buffer u mod STAGES, once every warp
// is done with that buffer's previous use, iteration u - STAGES: two bulk
// copies lay out words a .. 1023, then 0 .. a + GRAIN - 1 of the segment,
// a = (o_b mod 1024) rounded down to GRAIN, WORDS words in all (the byte
// count the full barrier expects).  One thread.
template <class T, int STAGES>
__device__ __forceinline__ void ring_fill(MegoRing<T, STAGES>& r, uint32_t u, const T* wr,
                                          int cmp) {
  using Ring = MegoRing<T, STAGES>;
  const uint32_t st = u % STAGES;
  if (u >= STAGES) mbar_wait(&r.empty[st], (u / STAGES - 1) & 1);
  const int a = cmp & (SEG - Ring::GRAIN);
  const T* g = wr + (cmp & ~(SEG - 1));
  T* dst = r.seg[st];
  mbar_expect(&r.full[st], Ring::WORDS * sizeof(T));
  bulk_load(dst, g + a, (SEG - a) * sizeof(T), &r.full[st]);
  bulk_load(dst + SEG - a, g, (a + Ring::GRAIN) * sizeof(T), &r.full[st]);
}

// The comparison index of particle i at offset o (Alg. 5 lines 7-11) in the
// kernels' segment form: slot (i + o) mod 1024 of comparison segment
// ((i >> 10) + (o >> 10)) mod tiles, for 0 <= i, o < n.
__device__ __forceinline__ int cmp_index(int i, int o, int tiles) {
  int c = (i >> 10) + (o >> 10);
  if (c >= tiles) c -= tiles;
  return (c << 10) | ((i + o) & (SEG - 1));
}

// The Alg. 5 sweep of segment `seg` of a row of n plane words `wr` (tiles =
// n / 1024 segments, 16-byte aligned) over `iters` iterations with the
// row's offsets and seed: each thread's PER_THREAD particles i = seg·1024 +
// q·NT + tid end with their ancestors k[q].  A particle keeps the iteration
// of its last accept, and its ancestor is formed from that iteration's
// offset at the end.  `seq` counts the block's iterations over every
// segment it sweeps, so the ring's phases carry on from one segment to the
// next.  Every thread of the block calls it.
template <class T, int STAGES>
__device__ __forceinline__ void mego_sweep(MegoRing<T, STAGES>& r, uint32_t& seq, const T* wr,
                                           const int* __restrict__ offs, uint32_t seed,
                                           int seg, int tiles, int iters,
                                           int (&k)[PER_THREAD]) {
  using Ring = MegoRing<T, STAGES>;
  constexpr int AHEAD = Ring::AHEAD;
  const int tid = threadIdx.x;
  const uint32_t lane0 = (uint32_t)(seg * SEG + tid) * GOLDEN;
  float wk[PER_THREAD];
  int tk[PER_THREAD];  // iteration of the last accept, -1 for none
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    wk[q] = load_plane(wr[seg * SEG + q * NT + tid]);
    tk[q] = -1;
  }
  for (int b0 = 0; b0 < iters; b0 += CHUNK) {
    const int cnt = min(CHUNK, iters - b0);
    const int look = min(CHUNK + AHEAD, iters - b0);
    __syncthreads();  // the previous chunk's (or segment's) table is no longer read
    for (int t = tid; t < look; t += NT) {
      const int o = offs[b0 + t];
      r.tab[t] = make_uint2((uint32_t)cmp_index(seg * SEG, o, tiles),
                            t < cnt ? fmix(seed + (uint32_t)(b0 + t) * GOLDEN) : 0u);
    }
    __syncthreads();
    if (tid == 0 && b0 == 0) {
      for (int t = 0; t < min(AHEAD, iters); ++t) ring_fill(r, seq + t, wr, (int)r.tab[t].x);
    }
    for (int t = 0; t < cnt; ++t) {
      const uint32_t u = seq + b0 + t;
      if (tid == 0 && b0 + t + AHEAD < iters)
        ring_fill(r, u + AHEAD, wr, (int)r.tab[t + AHEAD].x);
      const uint32_t st = u % STAGES;
      mbar_wait(&r.full[st], (u / STAGES) & 1);
      const uint2 e = r.tab[t];
      // word (i + o_b) mod 1024, rotated
      const T* x = r.seg[st] + tid + (e.x & (Ring::GRAIN - 1));
      // u <= w[j] / w[k] (Alg. 5 line 13) as ftz(u·w[k]) <= ftz(w[j]): built
      // with -ftz=true, the product flushes its operands and its result and
      // the comparison its operands, so w[j] (upcast exactly, plane_f32)
      // and the product need no separate flush (a kept w[j] is flushed by
      // its next product), and every accept is the plain version's.
#pragma unroll
      for (int q = 0; q < PER_THREAD; ++q) {
        const float wj = plane_f32(x[q * NT]);
        const float u01 = bits_to_uniform(fmix(e.y ^ (lane0 + (uint32_t)(q * NT) * GOLDEN)));
        if (__fmul_rn(u01, wk[q]) <= wj) {
          tk[q] = b0 + t;
          wk[q] = wj;
        }
      }
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(&r.empty[st]);  // this warp is done with the buffer
    }
  }
  seq += iters;
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int i = seg * SEG + q * NT + tid;
    k[q] = tk[q] < 0 ? i : cmp_index(i, offs[tk[q]], tiles);
  }
}

// The ancestors (the identity unless `keep`) and, with d > 0, the state copy
// (state words, bit moves) of the thread's particles of segment seg of row s.
template <class S>
__device__ __forceinline__ void mego_commit(const int (&k)[PER_THREAD], int* __restrict__ anc,
                                            const S* __restrict__ state, S* __restrict__ out,
                                            int s, int seg, int n, int d, bool keep) {
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int i = seg * SEG + q * NT + threadIdx.x;
    const int kq = keep ? k[q] : i;
    anc[(size_t)s * n + i] = kq;
    for (int c = 0; c < d; ++c) {
      const size_t plane = ((size_t)s * d + c) * n;
      out[plane + i] = state[plane + kq];
    }
  }
}

// Grid (N / 1024, S): block (seg, s) sweeps segment seg of row s.
template <bool GATHER, class T, class S>
__global__ void __launch_bounds__(NT, 8) megopolis_fused_rows_kernel(
    const T* __restrict__ w, const S* __restrict__ state,
    const int* __restrict__ offsets, const uint32_t* __restrict__ seeds,
    int* __restrict__ anc, S* __restrict__ out, int n, int d, int iters) {
  __shared__ MegoRing<T, Stages<T>::ROWS> ring;
  ring_barriers_init(ring.full, ring.empty);
  const int s = blockIdx.y;
  const int seg = blockIdx.x;
  uint32_t seq = 0;
  int k[PER_THREAD];
  mego_sweep(ring, seq, w + (size_t)s * n, offsets + (size_t)s * iters, seeds[s], seg,
             n / SEG, iters, k);
  mego_commit(k, anc, state, out, s, seg, n, GATHER ? d : 0, true);
}

template <class T, class S>
__global__ void __launch_bounds__(NT, 8) megopolis_step_rows_kernel(
    const T* __restrict__ lw, const S* __restrict__ state,
    const int* __restrict__ offsets, const uint32_t* __restrict__ seeds, float thr,
    int* __restrict__ anc, S* __restrict__ out, float* __restrict__ stats,
    float* __restrict__ scratch, int rows, int n, int d, int iters) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float row_m[];          // [rows] shift m per row
  int* row_flag = (int*)(row_m + rows);     // [rows] bit 0: degenerate, bit 1: do
  __shared__ float red[NT / 32];
  __shared__ MegoRing<T, Stages<T>::STEP> ring;
  StepScratch sc = step_scratch(scratch, rows, gridDim.x, iters);
  // The bulk copies read wbuf in whole 16-byte words: its start is rounded
  // up (the wrapper's scratch has the slack).
  sc.wbuf = (float*)(((uintptr_t)sc.wbuf + 15) & ~(uintptr_t)15);
  ring_barriers_init(ring.full, ring.empty);
  // The prelude also writes sc.hh, the per-iteration hash prefixes the
  // Metropolis step kernels read; this kernel stages its own per chunk and
  // leaves sc.hh unread (S·B words).
  step_prelude(grid, lw, seeds, thr, stats, sc, row_m, row_flag, red, rows, n, iters);
  // wbuf was written through the generic proxy before the prelude's last
  // grid.sync(); the bulk copies read it through the async proxy.
  asm volatile("fence.proxy.async.global;" ::: "memory");

  // The sweep over (row, segment) pairs on the requantised weights, then
  // commit (selection or identity) and state copy.
  const T* wbuf = reinterpret_cast<const T*>(sc.wbuf);
  const int tiles = n / SEG;
  const size_t pairs = (size_t)rows * tiles;
  uint32_t seq = 0;
  for (size_t p = blockIdx.x; p < pairs; p += gridDim.x) {
    const int s = (int)(p / tiles);
    const int seg = (int)(p % tiles);
    int k[PER_THREAD];
    mego_sweep(ring, seq, wbuf + (size_t)s * n, offsets + (size_t)s * iters, seeds[s], seg,
               tiles, iters, k);
    mego_commit(k, anc, state, out, s, seg, n, d, row_flag[s] & 2);
  }
}

extern "C" {

// Each entry point takes `plane`, the code of the weights' plane word
// (PLANE_F32, PLANE_BF16, PLANE_F16 in ../../common.cuh); those that copy
// state take `sb`, the bytes of its word (4 or 2), and launch the instance
// of that pair (by_words).
int megopolis_fused_rows(const void* w, const void* state, const void* offsets,
                         const void* seeds, void* anc, void* out, int rows, int n,
                         int d, int iters, int sb, int plane, void* stream) {
  return by_words(plane, sb, [&](auto word, auto sword) {
    using T = decltype(word);
    using S = decltype(sword);
    dim3 grid(n / SEG, rows);
    megopolis_fused_rows_kernel<true, T, S><<<grid, NT, 0, (cudaStream_t)stream>>>(
        (const T*)w, (const S*)state, (const int*)offsets, (const uint32_t*)seeds, (int*)anc,
        (S*)out, n, d, iters);
    return (int)cudaGetLastError();
  });
}

// The index-only sweep: ancestors of a bank, no state.
int megopolis_rows(const void* w, const void* offsets, const void* seeds, void* anc,
                   int rows, int n, int iters, int plane, void* stream) {
  return by_plane(plane, [&](auto word) {
    using T = decltype(word);
    dim3 grid(n / SEG, rows);
    megopolis_fused_rows_kernel<false, T, StateWord<T>><<<grid, NT, 0, (cudaStream_t)stream>>>(
        (const T*)w, nullptr, (const int*)offsets, (const uint32_t*)seeds, (int*)anc,
        nullptr, n, 0, iters);
    return (int)cudaGetLastError();
  });
}

int megopolis_step_grid(int rows, int n, int sb, int plane, int* blocks) {
  return by_words(plane, sb, [&](auto word, auto sword) {
    const auto kernel = megopolis_step_rows_kernel<decltype(word), decltype(sword)>;
    const int err = smem_optin(kernel, step_smem_bytes(rows));
    if (err != 0) return err;
    return coop_step_grid(kernel, rows, n, blocks);
  });
}

int megopolis_step_rows(const void* lw, const void* state, const void* offsets,
                        const void* seeds, float thr, void* anc, void* out,
                        void* stats, void* scratch, int rows, int n, int d, int iters,
                        int blocks, int sb, int plane, void* stream) {
  return by_words(plane, sb, [&](auto word, auto sword) {
    using T = decltype(word);
    using S = decltype(sword);
    const auto kernel = megopolis_step_rows_kernel<T, S>;
    const T* a_lw = (const T*)lw;
    const S* a_state = (const S*)state;
    const int* a_off = (const int*)offsets;
    const uint32_t* a_seeds = (const uint32_t*)seeds;
    int* a_anc = (int*)anc;
    S* a_out = (S*)out;
    float* a_stats = (float*)stats;
    float* a_scratch = (float*)scratch;
    void* args[] = {(void*)&a_lw, (void*)&a_state, (void*)&a_off, (void*)&a_seeds,
                    (void*)&thr, (void*)&a_anc, (void*)&a_out, (void*)&a_stats,
                    (void*)&a_scratch, (void*)&rows, (void*)&n, (void*)&d, (void*)&iters};
    const int err = smem_optin(kernel, step_smem_bytes(rows));
    if (err != 0) return err;
    return coop_step_launch(kernel, blocks, rows, args, stream);
  });
}

// Kernel `which` of this file's resource table rows, in the order of
// repro_torch/analysis/smem.py: 3·plane + 0 the index-only bank kernel,
// + 1 the fused one, + 2 the step, each with the plane's own state word
// (StateWord<T>); then 9 + 2·(plane - 1) + 0 the fused kernel and + 1 the
// step with a 4-byte state beside the 2-byte plane.
int megopolis_attributes(int which, int dynamic_smem, int* out) {
  const int plane = which < 9 ? which / 3 : 1 + (which - 9) / 2;
  const int sb = which < 9 ? (plane == PLANE_F32 ? 4 : 2) : 4;
  const int k = which < 9 ? which % 3 : 1 + (which - 9) % 2;
  return by_words(plane, sb, [&](auto word, auto sword) {
    using T = decltype(word);
    using S = decltype(sword);
    switch (k) {
      case 0: return kernel_attributes(megopolis_fused_rows_kernel<false, T, StateWord<T>>,
                                       dynamic_smem, out);
      case 1: return kernel_attributes(megopolis_fused_rows_kernel<true, T, S>, dynamic_smem,
                                       out);
      default: {
        const int err = smem_optin(megopolis_step_rows_kernel<T, S>, (size_t)dynamic_smem);
        if (err != 0) return err;
        return kernel_attributes(megopolis_step_rows_kernel<T, S>, dynamic_smem, out);
      }
    }
  });
}

}  // extern "C"
