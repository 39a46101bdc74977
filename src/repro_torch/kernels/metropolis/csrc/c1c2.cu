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
//   What bounds it: per row it must move w (4N bytes; 2N at 2-byte plane
//   words), the ancestors (4N) and, with GATHER, the state in and out (8DN;
//   4DN); the partition tiles add 4N bytes for C1 and 4·B·N bytes for C2 of
//   reads that hit L2 (C2: 128 MiB at N = 2^20, B = 32; half at 2 bytes).
//   The sweep does B·N proposals of about 24 32-bit operations each (two
//   murmur3 finalizers 16, two lane xors 2, the mask
//   and the index add 2, shift, conversion and scale 3, product and compare
//   2, less the modulo Alg. 2 needs): at B = 32, N = 2^20 some 8·10^8
//   operations, 12 us at 67 T/s, so the operations bound it.
//   What the design does about it: the TPU's "partition tile fetched by the
//   BlockSpec" becomes shared memory.  One block of NT threads owns one own
//   tile of 1024 particles (4 a thread, strided by NT, so every load and
//   store is coalesced) and its partition tile: C1 loads its 4 KiB once,
//   coalesced, and keeps it for all B iterations, one transaction amortised
//   over B, which is the variant's point.  C2 takes a fresh 4 KiB tile at
//   every iteration through a ring of shared-memory buffers (C1C2Smem), as
//   the Megopolis kernels take their comparison segments: a buffer holds
//   the tiles of GROUP consecutive iterations, one thread starts their bulk
//   TMA copies (cp.async.bulk ... mbarrier::complete_tx) AHEAD groups before
//   the sweep reaches them, and each buffer has a full mbarrier (the
//   copies' bytes) and an empty one (one arrival per warp), so no iteration
//   waits on its own L2 round trip and there is no __syncthreads() per
//   iteration.  The proposal is a random read of shared memory, not of L2
//   as in Alg. 2.  fmix(seed + b·GOLDEN), the per-iteration half of both
//   hashes, and C2's tile of each iteration are staged per chunk of CHUNK
//   iterations in shared memory.
//
// metropolis_c1c2_step_rows_kernel<VARIANT> replaces metropolis_c1_pallas_step
// and metropolis_c2_pallas_step (via _c1c2_step_call): the fused SMC step, one
// cooperative launch on the design of metropolis_step_rows_kernel.  The shared
// prelude (two grid.sync() barriers) writes exp(lw - m) once to scratch; then
// each block grid-strides over (row, own tile) pairs, so that a block owns
// whole tiles and their shared partition, runs the rows kernel's sweep
// (c1c2_sweep, one function, so the two kernels cannot drift) with the
// partition tiles read from that scratch, C2's ring continuing from pair to
// pair, and commits the selection or the identity and copies the state.
// The TPU kernel recomputes exp(lw - m) for its own and its partition tile
// at every grid step; here it is computed once per particle.  With C2's
// ring beside the per-row shift and flags, the block passes 48 KiB at the
// most rows a step admits, so the kernel opts in to more dynamic shared
// memory (smem_optin), as the Megopolis step does.
//
//   What bounds it: the bytes of the fused kernel plus one more read of lw,
//   the same integer work and partition traffic, and the prelude.
//
// Plane words (DESIGN.md §14): both kernels are templates on the word T of
// their weight planes, float, __nv_bfloat16 or __half, and on the word S of
// their state (StateWord<T>, or uint32_t beside a 2-byte T), picked by the
// C entry points' `plane` and `sb` (by_words in ../../common.cuh).  The
// partition stays one tile of 1024 particles at every word
// (partition_size_bytes 4096, as in the JAX package): at 2-byte
// words a tile is 2 KiB, and C2's copies and the byte count each full
// barrier expects follow sizeof(T) (c2_fill); a wrong count would hang the
// block on its barrier.  Every weight a sweep reads, its own and the random
// shared read, is upcast exactly (plane_f32), so the sweep's arithmetic,
// the hash and the uniforms are the float32 kernel's.  The state is copied
// as S words, bit moves; the step's prelude rounds exp(lw - m) to T and
// writes it to scratch as T (step_prelude), so C2's ring moves 2-byte tiles
// there too: the ring's byte counts follow T, never S.
//
// Subnormals: every value selection depends on is flushed, as XLA does on
// the CPU: built with -ftz=true, the sweep's product and comparison flush
// their operands and results in hardware, so the weights are copied raw
// (C2's bulk copies cannot flush) and the carried w[k] may hold an
// unflushed subnormal that only its next product reads; the step prelude's
// values are flushed explicitly (ftz()).  State copies are bit moves and are
// never flushed.

#include "../../common.cuh"

#define SEG 1024
#define PER_THREAD (SEG / NT)
// C2's ring, per kernel: buffers (C1C2Smem's STAGES), each holding the
// partition tiles of GROUP consecutive iterations under one pair of
// barriers.  Chosen by measurement on the H100 (benchmarks/torch_kernel_ab.py
// --module metropolis.c1c2, each depth given with --source LABEL=<a copy of
// this file with other values>): against one tile a buffer, two took 3-7%
// off the bank kernel and 7% off the step; five buffers of two (40 KiB)
// were the fastest bank ring.  The step's three buffers of two and its
// per-row shift and flags pass 48 KiB together at the most rows, so it
// opts in to more dynamic shared memory (smem_optin).
#define C2_ROWS_STAGES 5  // metropolis_c1c2_rows_kernel<2, *>
#define C2_ROWS_GROUP 2
#define C2_STEP_STAGES 3  // metropolis_c1c2_step_rows_kernel<2>
#define C2_STEP_GROUP 2

// A block's shared memory: STAGES buffers of GROUP partition tiles of plane
// words T (4 KiB a tile at float32, 2 KiB at 2-byte words), with a
// full and an empty mbarrier each (C2's ring; C1 keeps its one tile in
// tile[0][0] and uses no barrier), and the per-chunk table tab[t] =
// {partition tile of iteration b0 + t (C2), fmix(seed + (b0 + t)·GOLDEN)},
// whose first words run AHEAD groups past the chunk for the copies started
// ahead.  A group's tiles are requested AHEAD groups before the sweep
// reaches them, so a buffer is refilled when every warp is done with the
// group two before: the one thread that starts the copies waits for the
// slowest warp with one group of slack.
template <class T, int STAGES, int GROUP>
struct C1C2Smem {
  static constexpr int AHEAD = STAGES > 1 ? STAGES - 2 : 0;  // in groups
  __align__(128) T tile[STAGES][GROUP][SEG];
  uint64_t full[STAGES];
  uint64_t empty[STAGES];
  uint2 tab[CHUNK + AHEAD * GROUP];
};

template <int VARIANT, class T>
using C1C2RowsSmem =
    C1C2Smem<T, VARIANT == 1 ? 1 : C2_ROWS_STAGES, VARIANT == 1 ? 1 : C2_ROWS_GROUP>;
template <int VARIANT, class T>
using C1C2StepSmem =
    C1C2Smem<T, VARIANT == 1 ? 1 : C2_STEP_STAGES, VARIANT == 1 ? 1 : C2_STEP_GROUP>;

template <class T, int STAGES, int GROUP>
__device__ __forceinline__ void c1c2_init(C1C2Smem<T, STAGES, GROUP>& r) {
  if constexpr (STAGES > 1) ring_barriers_init(r.full, r.empty);
}

// Request the `cnt` partition tiles of the block's u-th group of GROUP
// iterations (counted over every own tile it sweeps), tab[0 .. cnt) their
// table entries, from row wr (16-byte aligned) into buffer u mod STAGES,
// once every warp is done with that buffer's previous use, group u -
// STAGES: one bulk copy of a tile, 1024 words (4 KiB of float32, 2 KiB of a
// 2-byte word: the byte count the full barrier expects).  One thread.
template <class T, int STAGES, int GROUP>
__device__ __forceinline__ void c2_fill(C1C2Smem<T, STAGES, GROUP>& r, uint32_t u, const T* wr,
                                        const uint2* tab, int cnt) {
  const uint32_t st = u % STAGES;
  if (u >= STAGES) mbar_wait(&r.empty[st], (u / STAGES - 1) & 1);
  mbar_expect(&r.full[st], cnt * SEG * (uint32_t)sizeof(T));
  for (int g = 0; g < cnt; ++g) {
    bulk_load(r.tile[st][g], wr + (size_t)tab[g].x * SEG, SEG * (uint32_t)sizeof(T),
              &r.full[st]);
  }
}

// The sweep state of one thread's PER_THREAD particles i = tile·1024 + q·NT
// + tid of one own tile: their ancestors k and the carried w[k] (their
// lanes are formed from lane0 = (tile·1024 + tid)·GOLDEN), and C1's
// partition's first particle.
struct C1C2Lanes {
  int k[PER_THREAD];
  float wk[PER_THREAD];
  uint32_t lane0;
  int base;
};

// Start the sweep of own tile `tile` of a row of n plane words `wr` with the
// row's partition table `part`; C1 copies its one partition into r.tile[0]
// here (visible after the sweep's first __syncthreads()).  Raw bits, upcast
// exactly: with -ftz=true the sweep's product and compare flush what they
// read.
template <int VARIANT, class T, int STAGES, int GROUP>
__device__ __forceinline__ void c1c2_start(C1C2Lanes& t, C1C2Smem<T, STAGES, GROUP>& r,
                                           const T* wr,
                                           const int* __restrict__ part, int tile) {
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    t.k[q] = tile * SEG + q * NT + threadIdx.x;
    t.wk[q] = plane_f32(wr[t.k[q]]);
  }
  t.lane0 = (uint32_t)(tile * SEG + threadIdx.x) * GOLDEN;
  t.base = 0;
  if (VARIANT == 1) {
    t.base = part[tile] * SEG;  // Alg. 3: one partition for every iteration
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      r.tile[0][0][q * NT + threadIdx.x] = wr[t.base + q * NT + threadIdx.x];
    }
  }
}

// One iteration of the sweep against partition tile x (its first particle
// `base`) with hash prefix h; lane_n = n·GOLDEN, so the accept lane
// (uint32)(i + n)·GOLDEN = i·GOLDEN + lane_n.  Built with -ftz=true, the
// product flushes its operands and result and the compare its operands: no
// w value needs a separate flush (a kept w[j] is flushed by its next
// product), and every accept is the plain version's.
template <class T>
__device__ __forceinline__ void c1c2_iteration(C1C2Lanes& t, const T* x, int base,
                                               uint32_t h, uint32_t lane_n) {
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const uint32_t lane = t.lane0 + (uint32_t)(q * NT) * GOLDEN;
    const int jl = (int)(fmix(h ^ lane) & (SEG - 1));  // U{0, N_w - 1}
    const float wj = plane_f32(x[jl]);                 // a random shared read
    const float u = bits_to_uniform(fmix(h ^ (lane + lane_n)));
    if (__fmul_rn(u, t.wk[q]) <= wj) {  // u <= w[j] / w[k]
      t.k[q] = base + jl;
      t.wk[q] = wj;
    }
  }
}

// The sweep of own tile `tile` of row wr (n weights) over `iters`
// iterations with the row's partition table and hash prefixes: for C1,
// `hh`, the row's fmix(seed + b·GOLDEN) in device memory (the step
// kernel's, written by its prelude), or nullptr to stage them per chunk
// from `seed`, as C2 always does (its loop waits on the ring's barriers,
// behind which a load from device memory would stall every iteration).  C1
// reads its one tile (written by c1c2_start, visible after the caller's
// next __syncthreads()); C2 takes each group of GROUP iterations' tiles
// from the ring, requested AHEAD groups before by one thread, with no
// __syncthreads() per iteration.  `seq` counts the block's groups over
// every own tile it sweeps, so the ring's phases carry on from one tile to
// the next.  Every thread of the block calls it.
template <int VARIANT, class T, int STAGES, int GROUP>
__device__ __forceinline__ void c1c2_sweep(C1C2Lanes& t, C1C2Smem<T, STAGES, GROUP>& r,
                                           uint32_t& seq, const T* wr,
                                           const int* __restrict__ part, const uint32_t* hh,
                                           uint32_t seed, int tile, int n, int iters) {
  constexpr int AHEAD = C1C2Smem<T, STAGES, GROUP>::AHEAD;
  const int tid = threadIdx.x;
  const uint32_t lane_n = (uint32_t)n * GOLDEN;
  const int groups = (iters + GROUP - 1) / GROUP;
  for (int b0 = 0; b0 < iters; b0 += CHUNK) {  // CHUNK % GROUP == 0
    const int cnt = min(CHUNK, iters - b0);
    const int look = VARIANT == 2 ? min(CHUNK + AHEAD * GROUP, iters - b0) : cnt;
    if (VARIANT == 2 || hh == nullptr) {
      __syncthreads();  // the previous chunk's (or tile's) table is no longer read
      for (int c = tid; c < look; c += NT) {
        const uint32_t p = VARIANT == 2 ? (uint32_t)part[(size_t)tile * iters + b0 + c] : 0u;
        const uint32_t h = c < cnt && hh == nullptr ? fmix(seed + (uint32_t)(b0 + c) * GOLDEN)
                                                    : 0u;
        r.tab[c] = make_uint2(p, h);
      }
      __syncthreads();
    }
    if constexpr (VARIANT == 1) {
      for (int c = 0; c < cnt; ++c) {
        c1c2_iteration(t, r.tile[0][0], t.base, hh ? hh[b0 + c] : r.tab[c].y, lane_n);
      }
    } else {
      if (tid == 0 && b0 == 0) {
        for (int g = 0; g < min(AHEAD, groups); ++g) {
          c2_fill(r, seq + g, wr, &r.tab[g * GROUP], min(GROUP, iters - g * GROUP));
        }
      }
      for (int c = 0; c < cnt; c += GROUP) {
        const int g = (b0 + c) / GROUP;
        const uint32_t u = seq + g;
        if (tid == 0 && g + AHEAD < groups) {
          const int b = (g + AHEAD) * GROUP;
          c2_fill(r, u + AHEAD, wr, &r.tab[b - b0], min(GROUP, iters - b));
        }
        const uint32_t st = u % STAGES;
        mbar_wait(&r.full[st], (u / STAGES) & 1);
#pragma unroll
        for (int e = 0; e < GROUP; ++e) {
          if (GROUP > 1 && c + e >= cnt) break;
          const uint2 x = r.tab[c + e];  // Alg. 4: a fresh partition
          c1c2_iteration(t, r.tile[st][e], (int)x.x * SEG, x.y, lane_n);
        }
        __syncwarp();
        if ((tid & 31) == 0) mbar_arrive(&r.empty[st]);  // this warp is done with the buffer
      }
    }
  }
  seq += groups;
}

// The ancestors (the identity unless `keep`) and, with d > 0, the state copy
// (state words, bit moves) of the thread's particles of one own tile of row s.
template <class S>
__device__ __forceinline__ void c1c2_commit(const C1C2Lanes& t, int* __restrict__ anc,
                                            const S* __restrict__ state,
                                            S* __restrict__ out, int s, int tile, int n,
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

// Grid (T, S): block (t, s) sweeps own tile t of row s.  C2 needs w on a
// 16-byte boundary (the wrappers check it).
template <int VARIANT, bool GATHER, class T, class S>
__global__ void __launch_bounds__(NT) metropolis_c1c2_rows_kernel(
    const T* __restrict__ w, const S* __restrict__ state,
    const int* __restrict__ parts, const uint32_t* __restrict__ seeds, int* __restrict__ anc,
    S* __restrict__ out, int n, int d, int iters) {
  __shared__ C1C2RowsSmem<VARIANT, T> sm;
  c1c2_init(sm);
  const int s = blockIdx.y;
  const int tile = blockIdx.x;
  const T* wr = w + (size_t)s * n;
  const int* part = parts + (size_t)s * (n / SEG) * (VARIANT == 1 ? 1 : iters);
  C1C2Lanes t;
  c1c2_start<VARIANT>(t, sm, wr, part, tile);
  uint32_t seq = 0;
  c1c2_sweep<VARIANT>(t, sm, seq, wr, part, nullptr, seeds[s], tile, n, iters);
  c1c2_commit(t, anc, state, out, s, tile, n, GATHER ? d : 0, true);
}

template <int VARIANT, class T, class S>
__global__ void __launch_bounds__(NT) metropolis_c1c2_step_rows_kernel(
    const T* __restrict__ lw, const S* __restrict__ state,
    const int* __restrict__ parts, const uint32_t* __restrict__ seeds, float thr,
    int* __restrict__ anc, S* __restrict__ out, float* __restrict__ stats,
    float* __restrict__ scratch, int rows, int n, int d, int iters) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float row_m[];          // [rows] shift m per row
  int* row_flag = (int*)(row_m + rows);     // [rows] bit 0: degenerate, bit 1: do
  __shared__ float red[NT / 32];
  __shared__ C1C2StepSmem<VARIANT, T> sm;
  StepScratch sc = step_scratch(scratch, rows, gridDim.x, iters);
  // The bulk copies read wbuf in whole 16-byte words: its start is rounded
  // up (the wrapper's scratch has the slack).
  sc.wbuf = (float*)(((uintptr_t)sc.wbuf + 15) & ~(uintptr_t)15);
  c1c2_init(sm);
  step_prelude(grid, lw, seeds, thr, stats, sc, row_m, row_flag, red, rows, n, iters);
  // wbuf was written through the generic proxy before the prelude's last
  // grid.sync(); C2's bulk copies read it through the async proxy.
  if (VARIANT == 2) asm volatile("fence.proxy.async.global;" ::: "memory");

  // The sweep over (row, own tile) pairs, so that a block owns whole tiles
  // and their partitions, then commit (selection or identity) and state
  // copy; C2's ring continues from pair to pair.  The sweep reads the
  // requantised weights as T.
  const T* wbuf = reinterpret_cast<const T*>(sc.wbuf);
  const int tiles = n / SEG;
  const size_t pairs = (size_t)rows * tiles;
  uint32_t seq = 0;
  for (size_t q = blockIdx.x; q < pairs; q += gridDim.x) {
    const int s = (int)(q / tiles);
    const int tile = (int)(q % tiles);
    const T* wr = wbuf + (size_t)s * n;
    const int* part = parts + (size_t)s * tiles * (VARIANT == 1 ? 1 : iters);
    C1C2Lanes t;
    if (VARIANT == 1) __syncthreads();  // the previous tile's partition is no longer read
    c1c2_start<VARIANT>(t, sm, wr, part, tile);
    if (VARIANT == 1) __syncthreads();  // its partition is in shared memory
    // C1 reads the prelude's hash prefixes; C2, whose loop waits on the
    // ring's barriers, stages them per chunk as the rows kernel does.
    const uint32_t* hh = VARIANT == 1 ? sc.hh + (size_t)s * iters : nullptr;
    c1c2_sweep<VARIANT>(t, sm, seq, wr, part, hh, seeds[s], tile, n, iters);
    c1c2_commit(t, anc, state, out, s, tile, n, d, row_flag[s] & 2);
  }
}

template <int VARIANT, bool GATHER, class T, class S>
static int launch_rows(const void* w, const void* state, const void* parts,
                       const void* seeds, void* anc, void* out, int rows, int n, int d,
                       int iters, void* stream) {
  dim3 grid(n / SEG, rows);
  metropolis_c1c2_rows_kernel<VARIANT, GATHER, T, S><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const T*)w, (const S*)state, (const int*)parts, (const uint32_t*)seeds, (int*)anc,
      (S*)out, n, d, iters);
  return (int)cudaGetLastError();
}

template <int VARIANT, class T, class S>
static int launch_step(const void* lw, const void* state, const void* parts, const void* seeds,
                       float thr, void* anc, void* out, void* stats, void* scratch, int rows,
                       int n, int d, int iters, int blocks, void* stream) {
  const auto kernel = metropolis_c1c2_step_rows_kernel<VARIANT, T, S>;
  const T* a_lw = (const T*)lw;
  const S* a_state = (const S*)state;
  const int* a_parts = (const int*)parts;
  const uint32_t* a_seeds = (const uint32_t*)seeds;
  int* a_anc = (int*)anc;
  S* a_out = (S*)out;
  float* a_stats = (float*)stats;
  float* a_scratch = (float*)scratch;
  void* args[] = {(void*)&a_lw, (void*)&a_state, (void*)&a_parts, (void*)&a_seeds,
                  (void*)&thr, (void*)&a_anc, (void*)&a_out, (void*)&a_stats,
                  (void*)&a_scratch, (void*)&rows, (void*)&n, (void*)&d, (void*)&iters};
  const int err = smem_optin(kernel, step_smem_bytes(rows));
  if (err != 0) return err;
  return coop_step_launch(kernel, blocks, rows, args, stream);
}

template <int VARIANT, class T, class S>
static int step_grid(int rows, int n, int* blocks) {
  const auto kernel = metropolis_c1c2_step_rows_kernel<VARIANT, T, S>;
  const int err = smem_optin(kernel, step_smem_bytes(rows));
  if (err != 0) return err;
  return coop_step_grid(kernel, rows, n, blocks);
}

template <int VARIANT, class T, class S>
static int step_attributes(int dynamic_smem, int* out) {
  const auto kernel = metropolis_c1c2_step_rows_kernel<VARIANT, T, S>;
  const int err = smem_optin(kernel, (size_t)dynamic_smem);
  if (err != 0) return err;
  return kernel_attributes(kernel, dynamic_smem, out);
}

extern "C" {

// Each entry point takes `plane`, the code of the weights' plane word
// (PLANE_F32, PLANE_BF16, PLANE_F16 in ../../common.cuh); those that copy
// state take `sb`, the bytes of its word (4 or 2), and launch the instance
// of that pair (by_words).

// The sweep of a bank: ancestors, and the state copy when state is not null.
// variant 1 (C1) or 2 (C2); n % 1024 == 0.
int metropolis_c1c2_rows(int variant, const void* w, const void* state, const void* parts,
                         const void* seeds, void* anc, void* out, int rows, int n, int d,
                         int iters, int sb, int plane, void* stream) {
  if (state == nullptr) {
    return by_plane(plane, [&](auto word) {
      using T = decltype(word);
      using S = StateWord<T>;
      return variant == 1
                 ? launch_rows<1, false, T, S>(w, state, parts, seeds, anc, out, rows, n, 0,
                                               iters, stream)
                 : launch_rows<2, false, T, S>(w, state, parts, seeds, anc, out, rows, n, 0,
                                               iters, stream);
    });
  }
  return by_words(plane, sb, [&](auto word, auto sword) {
    using T = decltype(word);
    using S = decltype(sword);
    return variant == 1 ? launch_rows<1, true, T, S>(w, state, parts, seeds, anc, out, rows, n,
                                                     d, iters, stream)
                        : launch_rows<2, true, T, S>(w, state, parts, seeds, anc, out, rows, n,
                                                     d, iters, stream);
  });
}

int metropolis_c1c2_step_grid(int variant, int rows, int n, int sb, int plane, int* blocks) {
  return by_words(plane, sb, [&](auto word, auto sword) {
    using T = decltype(word);
    using S = decltype(sword);
    return variant == 1 ? step_grid<1, T, S>(rows, n, blocks)
                        : step_grid<2, T, S>(rows, n, blocks);
  });
}

int metropolis_c1c2_step_rows(int variant, const void* lw, const void* state,
                              const void* parts, const void* seeds, float thr, void* anc,
                              void* out, void* stats, void* scratch, int rows, int n, int d,
                              int iters, int blocks, int sb, int plane, void* stream) {
  return by_words(plane, sb, [&](auto word, auto sword) {
    using T = decltype(word);
    using S = decltype(sword);
    return variant == 1 ? launch_step<1, T, S>(lw, state, parts, seeds, thr, anc, out, stats,
                                               scratch, rows, n, d, iters, blocks, stream)
                        : launch_step<2, T, S>(lw, state, parts, seeds, thr, anc, out, stats,
                                               scratch, rows, n, d, iters, blocks, stream);
  });
}

// Kernel `which` of this file's resource table rows, in the order of
// repro_torch/analysis/smem.py: 6·plane + 0-3 the bank kernels <1, false>,
// <1, true>, <2, false>, <2, true>, + 4, + 5 the steps <1>, <2>, each with
// the plane's own state word (StateWord<T>); then 18 + 4·(plane - 1) + 0-3
// the bank kernels <1, true>, <2, true> and the steps <1>, <2> with a
// 4-byte state beside the 2-byte plane: kernel_attributes' four numbers.
int c1c2_attributes(int which, int dynamic_smem, int* out) {
  const int plane = which < 18 ? which / 6 : 1 + (which - 18) / 4;
  const int sb = which < 18 ? (plane == PLANE_F32 ? 4 : 2) : 4;
  const int tail[4] = {1, 3, 4, 5};
  const int k = which < 18 ? which % 6 : tail[(which - 18) % 4];
  return by_words(plane, sb, [&](auto word, auto sword) {
    using T = decltype(word);
    using S = decltype(sword);
    const int d = dynamic_smem;
    switch (k) {
      case 0: return kernel_attributes(metropolis_c1c2_rows_kernel<1, false, T, StateWord<T>>, d,
                                       out);
      case 1: return kernel_attributes(metropolis_c1c2_rows_kernel<1, true, T, S>, d, out);
      case 2: return kernel_attributes(metropolis_c1c2_rows_kernel<2, false, T, StateWord<T>>, d,
                                       out);
      case 3: return kernel_attributes(metropolis_c1c2_rows_kernel<2, true, T, S>, d, out);
      case 4: return step_attributes<1, T, S>(dynamic_smem, out);
      default: return step_attributes<2, T, S>(dynamic_smem, out);
    }
  });
}

}  // extern "C"
