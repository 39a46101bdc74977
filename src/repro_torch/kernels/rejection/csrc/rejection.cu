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
//   What bounds it: per row it must move w (4N bytes; 2N at 2-byte plane
//   words), the ancestors (4N) and, with GATHER, the state in and out (8DN;
//   4DN), plus the wrapper's sup w pass over w: 12 MiB at N = 2^20 without
//   state, 3.8 us at 3.35 TB/s.  The operations are the realised rounds,
//   not max_iters:
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
//   weights (PERF.md); the chunks stay.  At S = 16 the kernel moved 2.1 GB
//   of random sectors at 2.7 TB/s, and the issue of each round's
//   instructions, not the sectors, set that rate: a proposal's j = hash
//   mod N takes a mask where N is a power of two (the path's N) in place of
//   the remainder's instruction sequence, and that alone made rows 19-22
//   6-8% faster on an NVIDIA H100 80GB HBM3 at 700.00 W (2.7-2.9 TB/s at
//   S = 16; PERF.md).  Also tried on the card and kept out: the step's
//   warp chains (refilled lanes) took the S = 16 index bank from 0.80 to
//   0.76 ms but the fused one from 0.83 to 1.01 and one row from
//   0.016-0.018 to 0.021-0.025, at 4 to 8 blocks an SM and 2 or 4 rounds a
//   lane; 2, 4 or 8 rounds in flight a thread in this loop were 8-80%
//   slower (the rounds past an accept read sectors and issue instructions
//   too); blocks of 32, 64 or 128 threads, and a remainder by a 64-bit
//   reciprocal, were no faster.
//
// rejection_step_rows_kernel replaces rejection_pallas_step and
// rejection_pallas_step_rows: the fused SMC step on the cooperative
// single-launch design of metropolis_step_rows_kernel, on the shared
// prelude of common.cuh with no hash prefixes (each round hashes
// fmix(seed + t·GOLDEN) in the thread, the hh of the rows kernel).  The
// TPU prelude latches sup w = max(exp(lw - m)); on a row that is not
// degenerate that is exp(0) = 1.0f exactly (m is the row's max), and on a
// degenerate row the uniform 1/N.  So the kernel takes sup w = (row_flag &
// 1) ? 1/N : 1.0f and adds no reduction to the prelude, which stays as the
// other step kernels compiled it.  The plain version takes the literal max;
// the tests and chip_smoke.py hold the two to each other.  A row whose
// trigger did not fire runs no round: it keeps the identity.
//
//   What bounds it: the bytes of the fused kernel plus one more read of lw,
//   and the realised rounds of the rows that resample, each past round 0 a
//   random L2 sector.  One thread a particle in a grid-stride loop ran each
//   warp as long as its slowest lane: on Path A's bank (S = 16) the lanes
//   averaged 15.6 rounds and their warps 61.6.
//   What the design does about it (warp_chains below): each lane holds a
//   particle and takes the next one when its own accepts, so no lane waits
//   for the warp's slowest; a lane runs REJ_ROUNDS = 2 rounds at once, their
//   loads in flight together; the grid's warps take equal pieces of the
//   resampling rows' particles in turns, so the grid sweeps the bank in
//   order and one or two rows' weights are the L2 working set; when a
//   warp's particles run out, its last ones share its lanes.  A committed
//   particle's state is stored one round later, its load in flight beside
//   that round's.  Registers are capped at 48 (5 blocks an SM).  On an
//   NVIDIA H100 80GB HBM3 (700.00 W): 1.28 ms against the parent's 1.74 at
//   S = 16, 0.088 against 0.106 at S = 1 (PERF.md).
//
// Plane words (DESIGN.md §14): both kernels are templates on the word T of
// their weight planes, float, __nv_bfloat16 or __half, and on the word S of
// their state (StateWord<T>, or uint32_t beside a 2-byte T), picked by the
// C entry points' `plane` and `sb` (by_words in ../../common.cuh).  Each
// weight read is upcast to f32 and flushed
// (load_plane): a random read w[j] becomes a 2-byte load and still moves one
// 32-byte sector, and the chain's arithmetic, the hash, the uniforms and
// sup w stay f32 (the wrapper upcasts its torch.amax before the launch).
// The state is copied as S words, bit moves.  The step's prelude rounds
// exp(lw - m) to T and writes it to scratch as T (step_prelude); its sup w, the max
// of those words, is 1.0f on a row that is not degenerate and 1/N rounded
// to T on a degenerate one.
//
// Subnormals: built with -ftz=true, and flushed explicitly (ftz()) on the
// values selection depends on, as XLA does on the CPU.

#include "../../common.cuh"

// w[j] upcast and flushed; RO reads through the read-only path.
template <bool RO, class T>
__device__ __forceinline__ float load_w(const T* w, int j) {
  return load_plane(RO ? __ldg(w + j) : w[j]);
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
template <bool RO, class T>
__device__ __forceinline__ bool rejection_chain(const T* __restrict__ w,
                                                const uint32_t* hh, int cnt, uint32_t lane_j,
                                                uint32_t lane_u, int n, float scale, int& k) {
  for (int t = 0; t < cnt; ++t) {
    const uint32_t h = hh[t];
    const uint32_t x = fmix(h ^ lane_j);  // mod n, as a mask where n is a power of two
    const int j = (int)((n & (n - 1)) == 0 ? x & (uint32_t)(n - 1) : x % (uint32_t)n);
    // u <= w[j] / sup w
    if (scaled_uniform(fmix(h ^ lane_u), scale) <= load_w<RO>(w, j)) {
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

template <bool GATHER, class T, class S>
__global__ void __launch_bounds__(NT) rejection_rows_kernel(
    const T* __restrict__ w, const float* __restrict__ wmax,
    const uint32_t* __restrict__ seeds, const S* __restrict__ state,
    int* __restrict__ anc, S* __restrict__ out, int n, int d, int max_iters) {
  __shared__ uint32_t s_hh[CHUNK];
  const int s = blockIdx.y;
  const int i = blockIdx.x * NT + threadIdx.x;
  const bool live = i < n;
  const T* wr = w + (size_t)s * n;
  const uint32_t seed = seeds[s];
  const float scale = uniform_scale(wmax[s]);
  // (uint32)(i + n) is the accept lane; i + n < 2^31 for n <= 2^30.
  const uint32_t lane_j = (uint32_t)i * GOLDEN;
  const uint32_t lane_u = ((uint32_t)i + (uint32_t)n) * GOLDEN;
  int k = i;
  bool done = !live || self_accept(fmix(seed), lane_u, scale, plane_f32(wr[i]));
  // Chunks of rounds t0 .. t0 + cnt - 1: the rounds left, max_iters - t0 +
  // 1, are counted down, so no sum passes max_iters < 2^31 - 1.
  for (int t0 = 1;; t0 += CHUNK) {
    // A barrier too: no thread still reads the previous chunk's prefixes.
    if (!__syncthreads_or(!done)) break;
    const int cnt = min(CHUNK, max_iters - t0 + 1);
    for (int t = threadIdx.x; t < cnt; t += NT) {
      s_hh[t] = fmix(seed + (uint32_t)(t0 + t) * GOLDEN);
    }
    __syncthreads();
    if (!done) done = rejection_chain<true>(wr, s_hh, cnt, lane_j, lane_u, n, scale, k);
    if (cnt < CHUNK) break;
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

// Particles a warp takes at a time, at least (the grid's warps take pieces
// in turn, so that the whole grid sweeps the bank in order); rounds a lane
// runs at once, their loads in flight together; and blocks a
// multiprocessor must hold (the register cap: 5 is 48 registers; 6 and 8
// spilled and lost, PERF.md).
#define REJ_CHUNK 64
#define REJ_ROUNDS 2
#define REJ_MIN_BLOCKS 5
#define FULL 0xffffffffu

// What the warp chain needs of a row: its weights (plane words), its seed
// (round t's hash prefix is fmix(seed + t·GOLDEN), the hh of the rows
// kernel) and the scale of u·sup w.
template <class T>
struct ChainRow {
  const T* w;
  uint32_t seed;
  float scale;
};

// A store a commit leaves for later: the warp chain writes the state word
// val to dst one round on, so that the load of val is in flight beside that
// round's.
template <class S>
struct Pending {
  S* dst;
  S val;
};

// Round t of particle i's chain: t = 0 proposes i itself, t >= 1 proposes
// j = hash mod n; accepted when u·sup w <= w[j] (the rounds of
// rejection_chain and self_accept, term for term).
template <class T>
__device__ __forceinline__ bool chain_round(const ChainRow<T>& r, int t, int i, int n, int& j) {
  const uint32_t h = fmix(r.seed + (uint32_t)t * GOLDEN);
  const uint32_t lane_j = (uint32_t)i * GOLDEN;
  const uint32_t lane_u = ((uint32_t)i + (uint32_t)n) * GOLDEN;
  j = t == 0 ? i : (int)(fmix(h ^ lane_j) % (uint32_t)n);
  return scaled_uniform(fmix(h ^ lane_u), r.scale) <= load_plane(r.w[j]);
}

// The position of the set bit of rank g (from 0) in m, which has more than g.
__device__ __forceinline__ int nth_set(unsigned m, int g) {
  int pos = 0;
#pragma unroll
  for (int b = 16; b > 0; b >>= 1) {
    if (__popc(m & ((1u << (pos + b)) - 1)) <= g) pos += b;
  }
  return pos;
}

// The chains of the particles of rows 0 .. rows - 1 of n each (row r is
// row_id(r) of the bank), in bank order, on warp w of `warps`, every lane
// of the warp calling it: in each of T = rows·n / (warps·REJ_CHUNK) turns
// (at least one) the grid's warps split the turn's particles, warp w the
// w-th piece, so every warp gets as many as any other, give or take T.
// Each lane holds one particle and its next round; a lane whose particle
// accepts (or passes the cap, keeping i) commits it and takes the next one,
// so no lane waits for the warp's slowest.  While more than 16 lanes are
// busy, a lane runs REJ_ROUNDS rounds of its particle at once; when the
// particles run out and at most 16 are busy, their particles are spread
// over the warp, 32 / 2^ceil(log2 busy) lanes each, one round a lane: the
// first accepting round of a particle is the lowest set bit of its lanes'
// ballot, the sequential chain's first accept.  So each ancestor is the
// chain's, whichever lane and warp run it.  The rounds left to a particle
// at round t are max_iters - t >= 0, so no sum passes max_iters and the
// caller may take any max_iters < 2^31 - 1.  row_of(s) gives row s's
// ChainRow<T>; commit(s, i, k) records ancestor k of particle i of row s and
// returns the store of an S word it leaves pending (dst null: none).
template <class T, class S, class RowId, class RowOf, class Commit>
__device__ __forceinline__ void warp_chains(int w, int warps, int rows, int n, int max_iters,
                                            RowId row_id, RowOf row_of, Commit commit) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  int s = -1, i = 0, t = 0;  // this lane's particle (s < 0: none) and its next round
  ChainRow<T> row{nullptr, 0u, 0.0f};
  Pending<S> pend{nullptr, S{}};
  const int total = rows * n;  // rows·n < 2^31
  const int pieces = warps * max(1, total / (warps * REJ_CHUNK));
  int piece = w;  // piece p holds ids [total·p / pieces, total·(p + 1) / pieces)
  int cur = (int)((long long)total * piece / pieces);
  int end = (int)((long long)total * (piece + 1) / pieces);
  int cr = cur / n, ci = cur - cr * n;  // cur as row, particle
  while (true) {
    unsigned idle = __ballot_sync(FULL, s < 0);
    while (idle && cur < end) {
      const int take = min(__popc(idle), end - cur);
      const int rank = __popc(idle & below);
      if (((idle >> lane) & 1) && rank < take) {
        const bool next = ci + rank >= n;  // ci + rank < n + 32: this row or the next
        s = row_id(cr + next);
        i = ci + rank - (next ? n : 0);
        t = 0;
        row = row_of(s);
      }
      cur += take;
      ci += take;
      if (ci >= n) {
        ci -= n;
        ++cr;
      }
      if (cur == end && piece + warps < pieces) {  // the warp's piece of the next turn
        piece += warps;
        cur = (int)((long long)total * piece / pieces);
        end = (int)((long long)total * (piece + 1) / pieces);
        cr = cur / n;
        ci = cur - cr * n;
      }
      idle = __ballot_sync(FULL, s < 0);
    }
    const unsigned busy = __ballot_sync(FULL, s >= 0);
    if (!busy) break;
    const int nb = __popc(busy);
    int k = -1;  // >= 0: this lane's particle is done, with ancestor k
    if (nb > 16) {  // a lane a particle, REJ_ROUNDS rounds at once
      if (s >= 0) {
        const int left = max_iters - t;
        int j[REJ_ROUNDS];
        bool acc[REJ_ROUNDS];
#pragma unroll
        for (int r = 0; r < REJ_ROUNDS; ++r) {
          acc[r] = r <= left && chain_round(row, t + r, i, n, j[r]);
        }
#pragma unroll
        for (int r = REJ_ROUNDS - 1; r >= 0; --r) {
          if (acc[r]) k = j[r];
        }
        if (k < 0) {
          if (left < REJ_ROUNDS) {
            k = i;
          } else {
            t += REJ_ROUNDS;
          }
        }
      }
    } else {
      const int gsz = 32 >> (32 - __clz(nb - 1));  // 32 / 2^ceil(log2 nb)
      const int g = lane / gsz;
      const int src = nth_set(busy, g < nb ? g : nb - 1);
      const int ps = __shfl_sync(FULL, s, src);
      const int pi = __shfl_sync(FULL, i, src);
      const int pt = __shfl_sync(FULL, t, src);
      const int o = lane % gsz;
      int j = 0;
      bool acc = false;
      if (g < nb && o <= max_iters - pt) acc = chain_round(row_of(ps), pt + o, pi, n, j);
      const unsigned hit = __ballot_sync(FULL, acc);
      // A busy lane of rank r reads its particle's outcome from group r.
      const int r = __popc(busy & below);
      const unsigned mine = s >= 0 ? (hit >> (r * gsz)) & (FULL >> (32 - gsz)) : 0u;
      const int kj = __shfl_sync(FULL, j, mine ? r * gsz + __ffs(mine) - 1 : lane);
      if (s >= 0) {
        if (mine) {
          k = kj;
        } else if (max_iters - t < gsz) {
          k = i;
        } else {
          t += gsz;
        }
      }
    }
    if (pend.dst != nullptr) {
      *pend.dst = pend.val;
      pend.dst = nullptr;
    }
    if (k >= 0) {
      pend = commit(s, i, k);
      s = -1;
    }
  }
  if (pend.dst != nullptr) *pend.dst = pend.val;
}

template <class T, class S>
__global__ void __launch_bounds__(NT, REJ_MIN_BLOCKS) rejection_step_rows_kernel(
    const T* __restrict__ lw, const S* __restrict__ state,
    const uint32_t* __restrict__ seeds, float thr, int* __restrict__ anc,
    S* __restrict__ out, float* __restrict__ stats, float* __restrict__ scratch,
    int rows, int n, int d, int max_iters) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float row_m[];          // [rows] shift m per row
  int* row_flag = (int*)(row_m + rows);     // [rows] bit 0: degenerate, bit 1: do
  __shared__ float red[NT / 32];
  // No hash prefixes in scratch: each round computes its own (ChainRow).
  const StepScratch sc = step_scratch(scratch, rows, gridDim.x, 0);
  step_prelude(grid, lw, seeds, thr, stats, sc, row_m, row_flag, red, rows, n, 0);

  // The rows that do not resample: the identity and the state copy.
  const size_t gtid = (size_t)blockIdx.x * NT + threadIdx.x;
  const size_t gstride = (size_t)gridDim.x * NT;
  for (int s = 0; s < rows; ++s) {
    if (row_flag[s] & 2) continue;
    for (size_t i = gtid; i < (size_t)n; i += gstride) {
      anc[(size_t)s * n + i] = (int)i;
      for (int c = 0; c < d; ++c) {
        const size_t plane = ((size_t)s * d + c) * n;
        out[plane + i] = state[plane + i];
      }
    }
  }

  // The rows that resample, in order, in place of the shifts (no longer
  // read), and their count in red[0].
  int* fired = (int*)row_m;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    int cnt = 0;
    for (int r0 = 0; r0 < rows; r0 += 32) {
      const bool f = r0 + lane < rows && (row_flag[r0 + lane] & 2);
      const unsigned m = __ballot_sync(FULL, f);
      if (f) fired[cnt + __popc(m & ((1u << lane) - 1))] = r0 + lane;
      cnt += __popc(m);
    }
    if (lane == 0) ((int*)red)[0] = cnt;
  }
  __syncthreads();

  // Their chains, the F particles in bank order, and each ancestor's state
  // (plane 0's store one round later).  sc.wbuf was written in this launch:
  // plain loads, not the read-only path.  A degenerate row's sup w is its
  // weight 1/N as the prelude wrote it, rounded to T.
  const float inv_n = plane_f32(to_plane<T>((float)(1.0 / (double)n)));
  const T* wbuf = reinterpret_cast<const T*>(sc.wbuf);
  warp_chains<T, S>(
      blockIdx.x * (NT / 32) + (threadIdx.x >> 5), gridDim.x * (NT / 32), ((int*)red)[0], n,
      max_iters, [&](int r) { return fired[r]; },
      [&](int s) {
        // sup w = max(exp(lw - m)), see the note above.
        return ChainRow<T>{wbuf + (size_t)s * n, __ldg(seeds + s),
                           uniform_scale((row_flag[s] & 1) ? inv_n : 1.0f)};
      },
      [&](int s, int i, int k) {
        anc[(size_t)s * n + i] = k;
        for (int c = 1; c < d; ++c) {
          const size_t plane = ((size_t)s * d + c) * n;
          out[plane + i] = state[plane + k];
        }
        const size_t plane0 = (size_t)s * d * n;
        return d > 0 ? Pending<S>{out + plane0 + i, state[plane0 + k]}
                     : Pending<S>{nullptr, S{}};
      });
}

extern "C" {

// Each entry point takes `plane`, the code of the weights' plane word
// (PLANE_F32, PLANE_BF16, PLANE_F16 in ../../common.cuh); those that copy
// state take `sb`, the bytes of its word (4 or 2), and launch the instance
// of that pair (by_words); sup w (wmax) is f32 at every word.

// The chain over a bank: ancestors, and with state (not null) the copy of
// each ancestor's state.
int rejection_rows(const void* w, const void* wmax, const void* seeds, const void* state,
                   void* anc, void* out, int rows, int n, int d, int max_iters, int sb,
                   int plane, void* stream) {
  const float* a_wmax = (const float*)wmax;
  const uint32_t* a_seeds = (const uint32_t*)seeds;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((n + NT - 1) / NT, rows);
  if (state == nullptr) {
    return by_plane(plane, [&](auto word) {
      using T = decltype(word);
      rejection_rows_kernel<false, T, StateWord<T>><<<grid, NT, 0, st>>>(
          (const T*)w, a_wmax, a_seeds, nullptr, (int*)anc, nullptr, n, d, max_iters);
      return (int)cudaGetLastError();
    });
  }
  return by_words(plane, sb, [&](auto word, auto sword) {
    using T = decltype(word);
    using S = decltype(sword);
    rejection_rows_kernel<true, T, S><<<grid, NT, 0, st>>>(
        (const T*)w, a_wmax, a_seeds, (const S*)state, (int*)anc, (S*)out, n, d, max_iters);
    return (int)cudaGetLastError();
  });
}

int rejection_step_grid(int rows, int n, int sb, int plane, int* blocks) {
  return by_words(plane, sb, [&](auto word, auto sword) {
    return coop_step_grid(rejection_step_rows_kernel<decltype(word), decltype(sword)>, rows, n,
                          blocks);
  });
}

int rejection_step_rows(const void* lw, const void* state, const void* seeds, float thr,
                        void* anc, void* out, void* stats, void* scratch, int rows, int n,
                        int d, int max_iters, int blocks, int sb, int plane, void* stream) {
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
                    (void*)&rows, (void*)&n, (void*)&d, (void*)&max_iters};
    return coop_step_launch(rejection_step_rows_kernel<T, S>, blocks, rows, args, stream);
  });
}

// Kernel `which` of this file's resource table rows, in the order of
// repro_torch/analysis/smem.py: 3·plane + 0 the index-only kernel, + 1 the
// fused one, + 2 the step, each with the plane's own state word
// (StateWord<T>); then 9 + 2·(plane - 1) + 0 the fused kernel and + 1 the
// step with a 4-byte state beside the 2-byte plane.
int rejection_attributes(int which, int dynamic_smem, int* out) {
  const int plane = which < 9 ? which / 3 : 1 + (which - 9) / 2;
  const int sb = which < 9 ? (plane == PLANE_F32 ? 4 : 2) : 4;
  const int k = which < 9 ? which % 3 : 1 + (which - 9) % 2;
  return by_words(plane, sb, [&](auto word, auto sword) {
    using T = decltype(word);
    using S = decltype(sword);
    switch (k) {
      case 0: return kernel_attributes(rejection_rows_kernel<false, T, StateWord<T>>,
                                       dynamic_smem, out);
      case 1: return kernel_attributes(rejection_rows_kernel<true, T, S>, dynamic_smem, out);
      default: return kernel_attributes(rejection_step_rows_kernel<T, S>, dynamic_smem, out);
    }
  });
}

}  // extern "C"
