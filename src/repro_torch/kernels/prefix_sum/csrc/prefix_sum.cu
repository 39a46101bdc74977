// The prefix-sum resamplers (paper §6.5: multinomial Alg. 7, systematic and
// improved systematic Alg. 8, stratified, residual) for NVIDIA Hopper
// (sm_90a).
//
// Three kernels with a plain C interface, built by repro_torch/kernels/build.py
// and bound with ctypes by repro_torch/kernels/prefix_sum/{prefix_sum,search,
// step}.py.  Every entry point launches on the caller's stream, allocates
// nothing and returns the launch's CUDA error.  Their plain PyTorch versions
// are in ../ref.py; the flushes, block reductions and the step prelude are
// shared with the other families in ../../common.cuh (unchanged here).
//
// The scan order is the contract.  The JAX package scans each tile of 1024
// particles with jnp.cumsum, which XLA on the CPU computes as a recursive
// scan with base 16: the tile as 64 rows of 16, each row added left to
// right; the 64 row totals as 4 rows of 16, the same; the 4 totals of those
// one after the other; then every row after the first offset by the scan of
// the rows before it.  Across tiles it adds a carry strictly in tile order:
// y_t = local_t + C_t, C_0 = 0, C_{t+1} = C_t + local_t[-1].  A decoupled
// look-back, or any other re-association of the carry, would give other
// bits; so each carry is one thread's chain of adds.  Adds and products that
// must match are __fadd_rn/__fmul_rn/__fsub_rn/__fdiv_rn (the build keeps
// nvcc's default --fmad=true, which would contract N·w - counts into an
// FMA), and the values selection depends on are flushed, as XLA on the CPU
// does: the scan's adds in hardware (-ftz=true, see fadd), the rest by
// ftz().
//
// prefix_scan_rows_kernel replaces prefix_sum_pallas
// (repro/kernels/prefix_sum/prefix_sum.py): the tiled inclusive scan of a
// bank of S rows [S, N] in one cooperative launch.
//
//   What bounds it: 4N bytes in and 4N out per row, 8 MiB at N = 2^20,
//   2.5 us at 3.35 TB/s.  Beyond the bytes, latency the bound does not
//   count: the carry is a chain of N/1024 - 1 dependent adds (1023 at N =
//   2^20, about 2 us at 4 clocks an add), and blocks that run in no order
//   meet at a grid barrier.
//   What the design does about it: reduce then scan, with one grid.sync().
//   Each block owns a contiguous span of the bank's tiles (split into
//   segments at row ends).  Phase 1: each tile of the span is scanned in
//   registers, thread t holding elements 4t .. 4t+3 as a float4 (a row of
//   16 is four neighbouring lanes, scanned by passing the running total one
//   lane up; the 64 row totals go through shared memory and one warp scans
//   them the same way), and the tile's last scanned element, its total in
//   the scan's own association, goes to tot.  Phase 2, after the barrier:
//   thread 0 of each block folds its row's totals from C_0 = 0 up to its
//   segment's first tile, left to right (the same chain of adds, run by
//   every block of the row at once instead of by one thread while the grid
//   waits), and each tile of the segment is scanned again, adds its carry
//   (tile 0 adds 0, as the TPU kernel does) and is written once; the next
//   carry is the last lane's C_t + total_t.  The span's last tile stays in
//   registers across the barrier, so at S = 1, where a block owns one
//   tile, the kernel moves the bound's 8N; with more tiles a block it
//   moves 12N (x is read again: from L2 while the bank fits there, from
//   device memory at S = 16, N = 2^20, 64 MiB).
//
// prefix_search_rows_kernel<GATHER> and prefix_search_tree_kernel<GATHER,
// RESIDUAL> replace searchsorted_pallas (GATHER false),
// searchsorted_gather_pallas (GATHER true) and residual_select_gather_pallas
// (<true, true>) (repro/kernels/prefix_sum/search.py): the TPU's
// bisection of each slot's row of the CDF, ceil(log2(N + 1)) steps at
// most, stopping when lo == hi (nothing changes after that in the TPU's
// fixed trip).  left: the first c >= u; right: the first c > u; clipped to
// N - 1.  mid = lo + (hi - lo) / 2 keeps clear of int32 overflow near N =
// 2^30.  RESIDUAL: slot i < n_det[s] bisects the count CDF at (float)i,
// other slots the residual CDF at u (only the search a slot keeps is run).
// The wrapper picks the kernel by the draws (repro_torch/kernels/
// prefix_sum/search.py): both compute the same function, bit for bit.
//
//   What bounds it: per row the CDF (4N) and u (4N) in, ancestors (4N) out,
//   and with GATHER the state in and out (8DN): 12 MiB at N = 2^20 index
//   only, 3.8 us.  Each of the ~21 steps is a dependent read.  Draws that
//   rise with i (systematic, stratified, residual's counts) keep a warp's
//   32 paths together until the last steps, so the CDF's top stays in L1.
//   Draws in no order (multinomial, residual's residuals) scatter every
//   step below the ~10th over its own 32-byte L2 sector, about 9 a search
//   with the state's: at S = 16 the parent's one thread a slot moved about
//   4 TB/s of sectors (1.31 ms), the rate one PyTorch gather reaches.
//   What the design does about it: rising draws keep one thread a slot
//   (prefix_search_rows_kernel).  The others go to one cooperative launch
//   (prefix_search_tree_kernel) that first writes each row's search tree,
//   the bisection's nodes in lines of one sector for three steps each (the
//   tree_* helpers below; 1.2 MB a row at N = 2^20), then, after one grid
//   barrier, searches one slot a thread with the grid sweeping the bank in
//   order: six sector reads for the first 18 steps (the top four groups
//   stay in L1), then bisect's loop on at most 16 elements.  On an NVIDIA
//   H100 80GB HBM3 (700.00 W) the multinomial gather at S = 16 took 0.913
//   ms against 1.310, at S = 1 0.056 against 0.092, Path C's bank at N =
//   2^22 16.4 against 23.5 (PERF.md).  A tree in each block's shared
//   memory lost: its fills per block, and blocks spread over every row at
//   once, which put the bank past L2.  The build (build_trees, shared with
//   the step) takes 32-bit indices and finds a line's group in closed
//   form: the gather 3-5% and the residual select 10-11% faster (PERF.md).
//
// prefix_step_rows_kernel<KIND> replaces prefix_pallas_step
// (repro/kernels/prefix_sum/step.py): the fused SMC step of a bank in one
// cooperative launch, on common.cuh's step_prelude with iters = 0 (the
// prefix kinds draw no hash, so the prelude builds no hash prefix and the
// eight earlier step kernels compile as before).  Then, on the rows whose
// trigger fired: the scan above (bit-identical: the same device code), the
// draws scaled from the host's key-derived bases (ubase = uniform(key, (N,)),
// u0 = uniform(key, ()), as the JAX wrapper draws them), the bisection,
// k = fired ? k : i, and the state copy.  KIND 0 multinomial, 1 systematic
// and improved systematic, 2 stratified, 3 residual: three scans (the
// weights, then the counts and the residuals as one bank of 2S rows), n_det
// as a fixed-order f32 sum of the counts (exact up to N = 2^24, the port's
// residual limit), then the slot select.
//
//   What bounds it: the bytes of lw and the state in, ancestors and state
//   out (16N per row), and the prelude's operations; the design adds the
//   scan's traffic and three more grid barriers (residual: seven).  On an
//   NVIDIA H100 80GB HBM3 (700.00 W), at S = 16 with 7 rows fired, the
//   prelude took 0.19 ms, the scan 0.06-0.08 and the search and copy the
//   rest (0.26 of 0.50 for the rising draws, 0.59 of 0.86 for multinomial's
//   random ones, each bisection step below the ~10th a scattered sector).
//   What the design does about it: on the rows that fired, the random
//   draws (KIND 0, and KIND 3's residual slots) search through the search
//   kernels' per-row tree: build_trees writes it to the front of work after
//   the scans, one more grid barrier, then tree_search; the CDF and the
//   tree are written in the launch, so both are read with plain loads.
//   Rising draws keep bisect (the tree lost on them).  Multinomial
//   took 0.639 ms against 0.858 at S = 16 and 0.075 against 0.103 at S = 1;
//   residual stayed within 1% (its random slots are few, and the tree's
//   build costs about what their search saves) (PERF.md).
//
// Plane words (DESIGN.md §14): only the scan's input travels compressed, as
// in the JAX package; the CDF it emits, the draws, the bisection bounds and
// residual's counts and residuals stay f32, so every bisection boundary is
// the float32 kernels' on the same (quantised) weights.  Each kernel is a
// template on a plane word T, float, __nv_bfloat16 or __half, picked by the
// C entry points' `plane` code (by_plane in ../../common.cuh):
// prefix_scan_rows_kernel<T> on its input (upcast exactly on load;
// residual's count and residual scans take the float instance),
// prefix_step_rows_kernel<KIND, T, S> on its log-weights: the prelude
// writes exp(lw - m) rounded to T as exact f32 values (step_prelude<T,
// float>), so the rest of the step, the scan in place among it, is the
// float32 instance's code; a buffer of T words would need the CDF beside it
// and took more registers (PERF.md §6).  The searches and the step copy
// state as S words, uint32_t or uint16_t by the state's width (a copy does
// no arithmetic): the searches read no plane, so each has an instance per
// state word alone.

#include "../../common.cuh"

#define TILE 1024
#define FOLD 1024  // tile totals of a row staged per chunk of the carry chain

// The scan's shared memory: a tile's 64 row totals, their level-1 scan, the
// carry of the tile being written and of the next one, and a chunk of a
// row's tile totals for the fold (with slack for fold's reads ahead).
struct ScanSmem {
  alignas(16) float rt[64];
  alignas(16) float o1[64];
  float carry[2];
  alignas(16) float buf[FOLD + 16];
};

// Every add of the scan.  build.py compiles with -ftz=true, so __fadd_rn is
// add.rn.ftz.f32: subnormal operands and a subnormal sum flush to zero of
// their sign in hardware, which is the plain version's add of flushed values
// (a sum below 2^-126 is exact, so flushing before or after the rounding
// agree).  Every element of y goes through at least one add (the carry), so
// the inputs need no separate flush.
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ float4 add4(float4 a, float c) {
  return make_float4(fadd(a.x, c), fadd(a.y, c), fadd(a.z, c), fadd(a.w, c));
}

// A thread's four elements, as one 16-byte access when both pointers allow
// it (vec), else one by one.
__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

// The 2-byte plane word in the low 16 bits of b.
__device__ __forceinline__ __nv_bfloat16 word_bits(uint32_t b, __nv_bfloat16) {
  return __ushort_as_bfloat16((unsigned short)b);
}
__device__ __forceinline__ __half word_bits(uint32_t b, __half) {
  return __ushort_as_half((unsigned short)b);
}

// Four 2-byte plane words upcast exactly, as one 8-byte access when vec
// (the words split from its two halves in registers).
template <class T>
__device__ __forceinline__ float4 load4(const T* p, bool vec) {
  static_assert(sizeof(T) == 2, "a 2-byte plane word");
  if (vec) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    return make_float4(plane_f32(word_bits(r.x, T{})), plane_f32(word_bits(r.x >> 16, T{})),
                       plane_f32(word_bits(r.y, T{})), plane_f32(word_bits(r.y >> 16, T{})));
  }
  return make_float4(plane_f32(p[0]), plane_f32(p[1]), plane_f32(p[2]), plane_f32(p[3]));
}

__device__ __forceinline__ void store4(float* p, float4 v, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    p[0] = v.x;
    p[1] = v.y;
    p[2] = v.z;
    p[3] = v.w;
  }
}

// Inclusive scans of rows of 16 values, left to right, a row held by four
// neighbouring lanes as float4s (lane & 3 its quarter), in place: four
// stages, each passing the running total one lane up.  Every lane of the
// warp calls it.
__device__ __forceinline__ void rows16(float4& a) {
  const int k = threadIdx.x & 3;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float in = s > 0 ? __shfl_up_sync(0xffffffffu, a.w, 1) : 0.0f;
    if (k == s) {
      if (s > 0) a.x = fadd(in, a.x);
      a.y = fadd(a.x, a.y);
      a.z = fadd(a.y, a.z);
      a.w = fadd(a.z, a.w);
    }
  }
}

// The local scan of one tile in XLA-CPU's base-16 order: the 64 rows of 16;
// their totals as 4 rows of 16 (warp 0, lanes 0-15); the 4 totals of those
// one after the other; each level-1 row after the first offset by that; each
// row after the first offset by the level-1 scan before it.  Thread t passes
// elements 4t .. 4t+3 and gets them back scanned; thread NT - 1's last is the
// tile's total.  Every thread of the block calls it (two __syncthreads();
// the next call writes sm.rt only after the second, sm.o1 only after the
// next call's first).
__device__ __forceinline__ float4 tile_scan(float4 a, ScanSmem& sm) {
  const int tid = threadIdx.x, row = tid >> 2;
  rows16(a);
  if ((tid & 3) == 3) sm.rt[row] = a.w;
  __syncthreads();
  if (tid < 32) {
    const int l = tid & 15;
    float4 g = reinterpret_cast<const float4*>(sm.rt)[l];
    rows16(g);
    const float s0 = __shfl_sync(0xffffffffu, g.w, 3);
    const float s1 = fadd(s0, __shfl_sync(0xffffffffu, g.w, 7));
    const float s2 = fadd(s1, __shfl_sync(0xffffffffu, g.w, 11));
    const int q = l >> 2;
    if (q > 0) g = add4(g, q == 1 ? s0 : (q == 2 ? s1 : s2));
    if (tid < 16) reinterpret_cast<float4*>(sm.o1)[l] = g;
  }
  __syncthreads();
  return row > 0 ? add4(a, sm.o1[row - 1]) : a;
}

// One thread's chain C = C + tot_t over the cnt totals in buf, in order (the
// order is the contract); the loads run a pair of float4s ahead of the adds.
__device__ __forceinline__ float fold(const float* buf, int cnt, float c) {
  const float4* b4 = reinterpret_cast<const float4*>(buf);
  const int n4 = cnt >> 2;
  float4 u = b4[0], v = b4[1];
  for (int j = 0; j < n4; j += 2) {
    const float4 nu = b4[j + 2], nv = b4[j + 3];  // inside buf's slack
    c = fadd(fadd(fadd(fadd(c, u.x), u.y), u.z), u.w);
    if (j + 1 < n4) c = fadd(fadd(fadd(fadd(c, v.x), v.y), v.z), v.w);
    u = nu;
    v = nv;
  }
  for (int i = n4 * 4; i < cnt; ++i) c = fadd(c, buf[i]);
  return c;
}

// The tiled scan of rows [rows, n] of plane words X from x into f32 y (y
// may be x at X = float), with the tile totals in tot [rows, n / TILE]; rows
// for which skip(r) holds are left alone.  Every block of the grid calls it
// (one grid.sync()).  Block b owns
// tiles [Q·b / G, Q·(b + 1) / G) of the Q in the bank (Q < 2^21: S·N <
// 2^31); it reads x and writes y only there, so the scan may run in place.
// The span's last tile stays in registers across the barrier.  On return a
// block has finished its own tiles; the caller syncs the grid before reading
// another block's.
template <class X, class Skip>
__device__ void scan_rows(cg::grid_group& grid, const X* x, float* y, float* tot, int rows,
                          int n, ScanSmem& sm, Skip skip) {
  const int T = n / TILE;
  const int tiles = rows * T;
  const int q0 = (int)((long long)tiles * blockIdx.x / gridDim.x);
  const int q1 = (int)((long long)tiles * (blockIdx.x + 1) / gridDim.x);
  // A thread's four input words are 4·sizeof(X) bytes, its four outputs 16.
  const bool vec = sizeof(X) == 4 ? (((uintptr_t)x | (uintptr_t)y) & 15) == 0
                                  : (((uintptr_t)x & 7) | ((uintptr_t)y & 15)) == 0;
  const int e4 = 4 * threadIdx.x;
  float4 kept = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int q = q0; q < q1; ++q) {
    if (skip(q / T)) continue;
    const float4 v = tile_scan(load4(x + (size_t)q * TILE + e4, vec), sm);
    if (threadIdx.x == NT - 1) tot[q] = v.w;
    kept = v;
  }
  grid.sync();
  for (int seg = q0; seg < q1;) {
    const int r = seg / T;
    const int row0 = r * T;
    const int a = seg - row0;
    const int e = min(T, q1 - row0);
    seg = row0 + e;
    if (skip(r)) continue;
    // C_a: the row's totals before the segment, folded from C_0 = 0.
    float c = 0.0f;
    for (int t0 = 0; t0 < a; t0 += FOLD) {
      const int cnt = min(FOLD, a - t0);
      __syncthreads();  // buf is free
      for (int i = threadIdx.x; i < cnt; i += NT) sm.buf[i] = tot[row0 + t0 + i];
      __syncthreads();
      if (threadIdx.x == 0) c = fold(sm.buf, cnt, c);
    }
    __syncthreads();  // the segment before has read and written its carries
    if (threadIdx.x == 0) sm.carry[a & 1] = c;
    __syncthreads();
    for (int t = a; t < e; ++t) {
      const int q = row0 + t;
      float4 v;
      if (q == q1 - 1) {
        if (t > a) __syncthreads();  // the last lane's carry of the tile before
        v = kept;
      } else {
        v = tile_scan(load4(x + (size_t)q * TILE + e4, vec), sm);
      }
      const float ct = sm.carry[t & 1];
      if (threadIdx.x == NT - 1) sm.carry[(t + 1) & 1] = fadd(ct, v.w);
      store4(y + (size_t)q * TILE + e4, add4(v, ct), vec);
    }
  }
}

// 8 blocks per SM (at most 32 registers): 1056 co-resident blocks, so at S =
// 1, N = 2^20 each of the 1024 tiles has a block of its own.
template <class T>
__global__ void __launch_bounds__(NT, 8) prefix_scan_rows_kernel(const T* x, float* y,
                                                                 float* tot, int rows, int n) {
  cg::grid_group grid = cg::this_grid();
  __shared__ ScanSmem sm;
  scan_rows(grid, x, y, tot, rows, n, sm, [](int) { return false; });
}

// The TPU's bisection: the first index with c > u (right) or c >= u
// (left), clipped to n - 1.  RO reads through the read-only path (c not
// written by the launch); else plain loads, and no __restrict__ that would
// let the compiler take that path.
template <bool RO>
__device__ __forceinline__ int bisect(const float* c, float u, bool right, int n) {
  u = ftz(u);
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const float cm = ftz(RO ? __ldg(c + mid) : c[mid]);
    if (right ? (cm <= u) : (cm < u)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return min(lo, n - 1);
}

// One thread per slot: slot i bisects its row's CDF at u (draws that rise
// with i, so a warp's 32 paths coincide but for their last steps); S is the
// word of the state it copies.
template <bool GATHER, class S>
__global__ void __launch_bounds__(NT) prefix_search_rows_kernel(
    const float* __restrict__ cdf, const float* __restrict__ u, const S* __restrict__ state,
    int* __restrict__ anc, S* __restrict__ out, int n, int d, int right) {
  const int s = blockIdx.y;
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  const size_t row = (size_t)s * n;
  const int k = bisect<true>(cdf + row, u[row + i], right, n);
  anc[row + i] = k;
  if (GATHER) {
    for (int c = 0; c < d; ++c) {
      const size_t plane = ((size_t)s * d + c) * n;
      out[plane + i] = state[plane + k];
    }
  }
}

// A node of the bisection tree over [0, n): the index that bisect reads at
// step l on the path whose turns (1: right, lo = mid + 1) are v's bits
// below its leading one, v in [1, 2^levels) in breadth-first order (v = 1
// the root, 2v and 2v + 1 its children), or -1 where that step's interval
// is empty (no search reaches it).  For n a power of two the interval of
// node (l, p = v - 2^l) is (p·n/2^l, (p + 1)·n/2^l], [0, n/2^l) for p = 0,
// and its midpoint (2p + 1)·n/2^(l+1); any other n replays the midpoints
// from the root.
__device__ __forceinline__ int tree_node(int v, int n) {
  const int l = 31 - __clz(v);
  if ((n & (n - 1)) == 0) return (2 * (v - (1 << l)) + 1) * (n >> (l + 1));
  int lo = 0, hi = n;
  for (int b = l - 1; b >= 0; --b) {
    const int mid = lo + ((hi - lo) >> 1);
    if ((v >> b) & 1) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < hi ? lo + ((hi - lo) >> 1) : -1;
}

// The search tree of a CDF row: the bisection's nodes (tree_node) of its
// first 3·groups steps, as lines of 8 floats (one 32-byte sector): line r
// of group g holds the 7 nodes of levels 3g .. 3g + 2 under node 8^g + r
// (breadth first: its root, then 2, then 4; the eighth float unused), and
// group g's 8^g lines follow the (8^g - 1) / 7 of the groups before.  So a
// search reads one sector for three steps where bisect reads three.
// groups: as many as leave an interval of at most 16 elements (half a
// 128-byte line of the CDF) to the last steps: ceil((ceil(log2 n) - 4) /
// 3), at least 1.
#define TREE_LINE 8
__host__ __device__ __forceinline__ int tree_groups(int n) {
#ifdef __CUDA_ARCH__
  const int l = 32 - __clz(n - 1);  // ceil(log2 n), n >= 2
#else
  const int l = 32 - __builtin_clz((unsigned)(n - 1));
#endif
  return l <= 7 ? 1 : (l - 2) / 3;
}
__host__ __device__ __forceinline__ long long tree_lines(int groups) {
  return ((1LL << (3 * groups)) - 1) / 7;
}

// Three steps of a search from one tree line f (8 floats in registers):
// each reads the node its path reaches, lo < hi permitting, as bisect does;
// returns the path's three turns as bits (first turn highest).
__device__ __forceinline__ int line_steps(const float (&f)[TREE_LINE], float x, bool right,
                                          int& lo, int& hi) {
  int path = 0;
#pragma unroll
  for (int dl = 0; dl < 3; ++dl) {
    const int base = (1 << dl) - 1;
    float cm = f[base];
#pragma unroll
    for (int o = 1; o < (1 << dl); ++o) cm = path == o ? f[base + o] : cm;
    int go = 0;
    if (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      go = right ? (cm <= x) : (cm < x);
      lo = go ? mid + 1 : lo;
      hi = go ? hi : mid;
    }
    path = 2 * path + go;
  }
  return path;
}

// One slot's search of row c at x: the tree's groups, then bisect's loop
// on the CDF from the interval they leave.  The tree was written in the
// launch: plain loads; RO reads c through the read-only path.
template <bool RO>
__device__ __forceinline__ int tree_search(const float* tree, int groups, const float* c,
                                           float x, bool right, int n) {
  int lo = 0, hi = n;
  long long v = 1;  // the node the path has reached, breadth first
  for (int g = 0; g < groups && lo < hi; ++g) {
    const float4* line = reinterpret_cast<const float4*>(
        tree + TREE_LINE * (tree_lines(g) + v - (1LL << (3 * g))));
    const float4 a = line[0], b = line[1];
    const float f[TREE_LINE] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    v = 8 * v + line_steps(f, x, right, lo, hi);
  }
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const float cm = ftz(RO ? __ldg(c + mid) : c[mid]);
    if (right ? (cm <= x) : (cm < x)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return min(lo, n - 1);
}

// Floats of one row's search tree.
__host__ __device__ __forceinline__ long long tree_row_floats(int n) {
  return TREE_LINE * tree_lines(tree_groups(n));
}

// The search trees of the CDF rows c [rows, n] into tree, of `groups`
// groups (tree_groups(n), which the caller searches with too) and so
// TREE_LINE·tree_lines(groups) floats a row, a float a thread over the
// grid; rows for which skip(s) holds are left alone.  The indices are
// 32-bit (a bank's trees hold fewer floats than its rows·n < 2^31
// elements) and a line's group is found in closed form.  RO reads c
// through the read-only path (c not written by the launch).
template <bool RO, class Skip>
__device__ __forceinline__ void build_trees(const float* c, float* tree, int rows, int n,
                                            int groups, Skip skip) {
  const int per_row = TREE_LINE * (int)tree_lines(groups);
  const unsigned total = (unsigned)rows * per_row;
  for (unsigned q = blockIdx.x * NT + threadIdx.x; q < total; q += gridDim.x * NT) {
    const int s = (int)(q / per_row);
    if (skip(s)) continue;
    const int line = (int)(q - s * per_row) / TREE_LINE;
    const int k = (int)(q % TREE_LINE);
    float val = 0.0f;
    if (k < TREE_LINE - 1) {
      const int g = (31 - __clz(7 * line + 1)) / 3;  // 8^g <= 7·line + 1 < 8^(g + 1)
      const int dl = 31 - __clz(k + 1);
      const int v = (((1 << (3 * g)) + line - (int)tree_lines(g)) << dl) + (k + 1 - (1 << dl));
      const int m = tree_node(v, n);
      if (m >= 0) val = ftz(RO ? __ldg(c + (size_t)s * n + m) : c[(size_t)s * n + m]);
    }
    tree[q] = val;
  }
}

// One cooperative launch: first every row's search tree into tree, one
// float a thread, then one grid barrier, then one slot a thread, the grid
// sweeping the bank in order (so one or two rows' CDFs, trees and states
// are the L2 working set).  RESIDUAL: slot i < n_det[s] bisects the count
// CDF at (float)i as prefix_search_rows_kernel does (those draws rise with
// i); the tree is the residual CDF's.  S is the word of the state it
// copies.
template <bool GATHER, bool RESIDUAL, class S>
__global__ void __launch_bounds__(NT) prefix_search_tree_kernel(
    const float* __restrict__ cdf, const float* __restrict__ cc, const float* __restrict__ u,
    const int* __restrict__ n_det, const S* __restrict__ state, int* __restrict__ anc,
    S* __restrict__ out, float* tree, int rows, int n, int d, int right) {
  cg::grid_group grid = cg::this_grid();
  const int groups = tree_groups(n);
  build_trees<true>(cdf, tree, rows, n, groups, [](int) { return false; });
  grid.sync();

  const long long per_row = tree_row_floats(n);
  const size_t gtid = (size_t)blockIdx.x * NT + threadIdx.x;
  const size_t gstride = (size_t)gridDim.x * NT;
  for (size_t q = gtid; q < (size_t)rows * n; q += gstride) {
    const int s = (int)(q / n);
    const int i = (int)(q % n);
    const size_t row = (size_t)s * n;
    int k;
    if (RESIDUAL && i < n_det[s]) {
      k = bisect<true>(cc + row, __int2float_rn(i), true, n);
    } else {
      k = tree_search<true>(tree + s * per_row, groups, cdf + row, ftz(__ldg(u + q)),
                            RESIDUAL || right, n);
    }
    anc[q] = k;
    if (GATHER) {
      for (int ch = 0; ch < d; ++ch) {
        const size_t plane = ((size_t)s * d + ch) * n;
        out[plane + i] = state[plane + k];
      }
    }
  }
}

// Registers by KIND, from A/Bs on the card at Path A's shapes: multinomial
// capped at 64 (4 blocks per SM; free, the tree took it to 71 and 3 blocks,
// 12% slower at S = 16); systematic and stratified capped at 40 (6
// blocks per SM, 8 bytes spilled), faster on a bank of 16 than 48 or free
// by 8-21% and slower on one row by 5-7%; residual keeps its 48 (5), the
// count it had before the scan held four elements a thread in registers.
// The 2-byte instances (T, the word of lw) take their own, whatever the
// state word S (StepBlocks): capped at 40 as float32's, systematic and stratified spilled
// 28 bytes, so they keep 48 (5 blocks an SM, no spill; PERF.md §6).
#define STEP_BLOCKS_1_2 6     // prefix_step_rows_kernel<1 or 2, float>
#define STEP_BLOCKS_1_2_2B 5  // prefix_step_rows_kernel<1 or 2, __nv_bfloat16 / __half>
template <int KIND, class T>
struct StepBlocks {
  static constexpr int value =
      KIND == 0 ? 4 : (KIND == 3 ? 5 : (sizeof(T) == 4 ? STEP_BLOCKS_1_2 : STEP_BLOCKS_1_2_2B));
};

template <int KIND, class T, class S>
__global__ void __launch_bounds__(NT, StepBlocks<KIND, T>::value)
    prefix_step_rows_kernel(
    const T* __restrict__ lw, const S* __restrict__ state,
    const float* __restrict__ ubase, const float* __restrict__ u0, float thr,
    int* __restrict__ anc, S* __restrict__ out, float* __restrict__ stats,
    float* __restrict__ scratch, float* work, int rows, int n, int d) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float row_m[];          // [rows] shift m; residual: then n_det
  int* row_flag = (int*)(row_m + rows);     // [rows] bit 0: degenerate, bit 1: do
  __shared__ float red[NT / 32];
  __shared__ ScanSmem sm;
  const StepScratch sc = step_scratch(scratch, rows, gridDim.x, 0);
  step_prelude<T, float>(grid, lw, nullptr, thr, stats, sc, row_m, row_flag, red, rows, n, 0);

  // The indices below are formed after the scan, so that none is held in a
  // register across it.  work: the random draws' search trees first (KIND
  // 0 and 3, tree_row_floats(n) floats a row), then the scans' space.
  constexpr bool TREE = KIND == 0 || KIND == 3;
  float* scan_work = TREE ? work + rows * tree_row_floats(n) : work;
  float* w = sc.wbuf;  // exp(lw - m) on T's grid, 1/N on a degenerate row
  float* cdf;          // the CDF the draws are scaled from and searched
  float* cc = nullptr;
  if (KIND != 3) {
    scan_rows(grid, w, w, scan_work, rows, n, sm, [&](int r) { return !(row_flag[r] & 2); });
    cdf = w;
  } else {
    const int nt = n / TILE;  // tiles a row
    const size_t sn = (size_t)rows * n;
    const size_t gtid = (size_t)blockIdx.x * NT + threadIdx.x;
    const size_t gstride = (size_t)gridDim.x * NT;
    const float nf = (float)n;
    float* cw = scan_work;
    cc = cw + sn;                  // counts, then their CDF
    cdf = cc + sn;                 // residuals, then their CDF
    float* tot = cdf + sn;         // [2·rows, nt]
    float* part = tot + 2 * (size_t)rows * nt;  // [rows, gridDim.x]
    scan_rows(grid, w, cw, tot, rows, n, sm, [&](int r) { return !(row_flag[r] & 2); });
    grid.sync();
    for (int s = 0; s < rows; ++s) {
      if (!(row_flag[s] & 2)) continue;
      const float total = cw[(size_t)s * n + n - 1];
      float sum = 0.0f;  // integer counts: exact in any order while <= 2^24
      for (size_t i = gtid; i < (size_t)n; i += gstride) {
        const size_t q = (size_t)s * n + i;
        const float nw = ftz(__fmul_rn(ftz(__fdiv_rn(w[q], total)), nf));
        const float counts = floorf(nw);
        cc[q] = counts;
        cdf[q] = ftz(__fsub_rn(nw, counts));
        sum += counts;
      }
      sum = block_reduce<false>(sum, red);
      if (threadIdx.x == 0) part[(size_t)s * gridDim.x + blockIdx.x] = sum;
    }
    grid.sync();
    // The counts and the residuals scanned as one bank of 2·rows rows.
    scan_rows(grid, cc, cc, tot, 2 * rows, n, sm,
              [&](int r) { return !(row_flag[r % rows] & 2); });
    for (int s = 0; s < rows; ++s) {
      if (!(row_flag[s] & 2)) continue;
      float sum = 0.0f;
      for (int q = threadIdx.x; q < (int)gridDim.x; q += NT) sum += part[(size_t)s * gridDim.x + q];
      sum = block_reduce<false>(sum, red);
      if (threadIdx.x == 0) row_m[s] = sum;  // the shift is no longer needed
    }
  }
  grid.sync();
  // The trees of the CDFs that random draws search (the weights', or the
  // residuals'), on the rows that resample; written here, so plain loads.
  const int groups = tree_groups(n);
  if (TREE) {
    build_trees<false>(cdf, work, rows, n, groups, [&](int r) { return !(row_flag[r] & 2); });
    grid.sync();
  }

  const size_t sn = (size_t)rows * n;
  const size_t gtid = (size_t)blockIdx.x * NT + threadIdx.x;
  const size_t gstride = (size_t)gridDim.x * NT;
  const float nf = (float)n;
  const float inv_n = __fdiv_rn(1.0f, nf);  // x / N as XLA computes it: x·fl(1/N)
  for (size_t q = gtid; q < sn; q += gstride) {
    const int s = (int)(q / n);
    const int i = (int)(q % n);
    int k = i;
    if (row_flag[s] & 2) {
      const float* c = cdf + (size_t)s * n;
      const float total = c[n - 1];
      if (KIND == 3 && i < __float2int_rz(row_m[s])) {  // NaN gives 0, as XLA's conversion
        k = bisect<false>(cc + (size_t)s * n, __int2float_rn(i), true, n);
      } else if (TREE) {
        k = tree_search<false>(work + s * TREE_LINE * tree_lines(groups), groups, c,
                               ftz(__fmul_rn(__ldg(ubase + q), total)), true, n);
      } else {
        const float scale = ftz(__fmul_rn(total, inv_n));
        const float base = KIND == 1 ? __ldg(u0 + s) : __ldg(ubase + q);
        k = bisect<false>(c, ftz(__fmul_rn(__fadd_rn(__int2float_rn(i), base), scale)), false,
                          n);
      }
    }
    anc[q] = k;
    for (int c = 0; c < d; ++c) {
      const size_t plane = ((size_t)s * d + c) * n;
      out[plane + i] = state[plane + k];
    }
  }
}

// The step kernel of each KIND at plane word T and state word S.
template <class T, class S>
static const void* step_kernel(int kind) {
  switch (kind) {
    case 0: return (const void*)prefix_step_rows_kernel<0, T, S>;
    case 1: return (const void*)prefix_step_rows_kernel<1, T, S>;
    case 2: return (const void*)prefix_step_rows_kernel<2, T, S>;
    case 3: return (const void*)prefix_step_rows_kernel<3, T, S>;
    default: return nullptr;
  }
}

// The tree search kernel copying S words (the index-only one at uint32_t
// alone).
template <class S>
static const void* tree_kernel(bool residual, bool gather) {
  if (residual) return (const void*)prefix_search_tree_kernel<true, true, S>;
  if (gather) return (const void*)prefix_search_tree_kernel<true, false, S>;
  return (const void*)prefix_search_tree_kernel<false, false, uint32_t>;
}

// Call f(S{}) for the state word of sb bytes, uint32_t or uint16_t, on the
// host: the searches' dispatch (they read no plane).  Any other width is
// cudaErrorInvalidValue.
template <class F>
static int by_state(int sb, F f) {
  switch (sb) {
    case 4: return f(uint32_t{});
    case 2: return f(uint16_t{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// The scan kernel reading plane words T.
template <class T>
static const void* scan_kernel() {
  return (const void*)prefix_scan_rows_kernel<T>;
}

extern "C" {

// Each entry point that reads a plane takes `plane`, the code of its word
// (PLANE_F32, PLANE_BF16, PLANE_F16 in ../../common.cuh): the scan's input,
// the step's log-weights; those that copy state take `sb`, the bytes of its
// word (4 or 2), and launch the instance of that word (by_words, by_state).

// Blocks of the cooperative scan grid: as many as can be co-resident, and
// no more than the bank has tiles.
int prefix_scan_grid(int rows, int n, int plane, int* blocks) {
  return by_plane(plane, [&](auto word) {
    return resident_blocks(scan_kernel<decltype(word)>(), 0, (long long)rows * (n / TILE),
                           blocks);
  });
}

int prefix_scan_rows(const void* x, void* y, void* tot, int rows, int n, int blocks, int plane,
                     void* stream) {
  return by_plane(plane, [&](auto word) {
    float* a_y = (float*)y;
    float* a_tot = (float*)tot;
    void* args[] = {(void*)&x, (void*)&a_y, (void*)&a_tot, (void*)&rows, (void*)&n};
    cudaError_t err = cudaLaunchCooperativeKernel(scan_kernel<decltype(word)>(), dim3(blocks),
                                                  dim3(NT), args, 0, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  });
}

// Floats of one row's search tree.
long long prefix_search_tree_floats(int n) { return tree_row_floats(n); }

// The search over a bank: with state (not null) the copy of each
// ancestor's state, of sb-byte words.  With neither tree nor cc, one
// thread a slot (prefix_search_rows_kernel, for draws that rise with i);
// else one cooperative launch of prefix_search_tree_kernel on a co-resident
// grid, with cc (not null) the residual select and tree scratch of
// tree_floats floats, at least a tree a row (prefix_search_tree_floats).
int prefix_search_rows(const void* cdf, const void* cc, const void* u, const void* n_det,
                       const void* state, void* anc, void* out, void* tree,
                       long long tree_floats, int rows, int n, int d, int right, int sb,
                       void* stream) {
  return by_state(sb, [&](auto sword) {
    using S = decltype(sword);
    const float* a_cdf = (const float*)cdf;
    const float* a_cc = (const float*)cc;
    const float* a_u = (const float*)u;
    const int* a_nd = (const int*)n_det;
    const S* a_state = (const S*)state;
    int* a_anc = (int*)anc;
    S* a_out = (S*)out;
    cudaStream_t st = (cudaStream_t)stream;
    if (tree == nullptr && cc == nullptr) {
      dim3 grid((n + NT - 1) / NT, rows);
      if (state != nullptr) {
        prefix_search_rows_kernel<true, S><<<grid, NT, 0, st>>>(a_cdf, a_u, a_state, a_anc,
                                                                a_out, n, d, right);
      } else {
        prefix_search_rows_kernel<false, uint32_t><<<grid, NT, 0, st>>>(
            a_cdf, a_u, nullptr, a_anc, nullptr, n, d, right);
      }
      return (int)cudaGetLastError();
    }
    if (tree_floats < (long long)rows * prefix_search_tree_floats(n))
      return (int)cudaErrorInvalidValue;
    const void* kernel = tree_kernel<S>(cc != nullptr, state != nullptr);
    int blocks = 0;
    const int err = resident_blocks(kernel, 0, ((long long)rows * n + NT - 1) / NT, &blocks);
    if (err != 0) return err;
    float* a_tree = (float*)tree;
    void* args[] = {(void*)&a_cdf,   (void*)&a_cc,  (void*)&a_u,   (void*)&a_nd,
                    (void*)&a_state, (void*)&a_anc, (void*)&a_out, (void*)&a_tree,
                    (void*)&rows,    (void*)&n,     (void*)&d,     (void*)&right};
    const cudaError_t e =
        cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(NT), args, 0, st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  });
}

int prefix_step_grid(int kind, int rows, int n, int sb, int plane, int* blocks) {
  return by_words(plane, sb, [&](auto word, auto sword) {
    const void* kernel = step_kernel<decltype(word), decltype(sword)>(kind);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    return coop_step_grid(kernel, rows, n, blocks);
  });
}

int prefix_step_rows(int kind, const void* lw, const void* state, const void* ubase,
                     const void* u0, float thr, void* anc, void* out, void* stats,
                     void* scratch, void* work, int rows, int n, int d, int blocks, int sb,
                     int plane, void* stream) {
  return by_words(plane, sb, [&](auto word, auto sword) {
    using T = decltype(word);
    using S = decltype(sword);
    const void* kernel = step_kernel<T, S>(kind);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    const T* a_lw = (const T*)lw;
    const S* a_state = (const S*)state;
    const float* a_ubase = (const float*)ubase;
    const float* a_u0 = (const float*)u0;
    int* a_anc = (int*)anc;
    S* a_out = (S*)out;
    float* a_stats = (float*)stats;
    float* a_scratch = (float*)scratch;
    float* a_work = (float*)work;
    void* args[] = {(void*)&a_lw, (void*)&a_state, (void*)&a_ubase, (void*)&a_u0,
                    (void*)&thr, (void*)&a_anc, (void*)&a_out, (void*)&a_stats,
                    (void*)&a_scratch, (void*)&a_work, (void*)&rows, (void*)&n, (void*)&d};
    return coop_step_launch(kernel, blocks, rows, args, stream);
  });
}

// Kernel `which` of this file's resource table rows, in the order of
// repro_torch/analysis/smem.py: 0 the scan at float; 1-2 the rows searches
// <false>, <true>; 3-5 the tree searches <false, false>, <true, false>,
// <true, true>, all copying uint32_t; 6-9 the steps of KIND 0-3 at float;
// 10-12 the searches that copy, copying uint16_t; then per 2-byte word
// (13 + 9·(plane - 1)): + 0 the scan, + 1-4 the steps with the plane's own
// state word, + 5-8 with a 4-byte one.
int prefix_sum_attributes(int which, int dynamic_smem, int* out) {
  const void* kernel = nullptr;
  if (which < 13) {
    switch (which) {
      case 0: kernel = scan_kernel<float>(); break;
      case 1: kernel = (const void*)prefix_search_rows_kernel<false, uint32_t>; break;
      case 2: kernel = (const void*)prefix_search_rows_kernel<true, uint32_t>; break;
      case 3: case 4: case 5: kernel = tree_kernel<uint32_t>(which == 5, which >= 4); break;
      case 10: kernel = (const void*)prefix_search_rows_kernel<true, uint16_t>; break;
      case 11: case 12: kernel = tree_kernel<uint16_t>(which == 12, true); break;
      default: kernel = step_kernel<float, uint32_t>(which - 6);
    }
  } else {
    const int plane = 1 + (which - 13) / 9, k = (which - 13) % 9;
    const int err = by_words(plane, k <= 4 ? 2 : 4, [&](auto word, auto sword) {
      using T = decltype(word);
      kernel = k == 0 ? scan_kernel<T>() : step_kernel<T, decltype(sword)>((k - 1) % 4);
      return 0;
    });
    if (err != 0) return err;
  }
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return kernel_attributes(kernel, dynamic_smem, out);
}

}  // extern "C"
