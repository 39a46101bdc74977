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
// bits; so each row's carry is one thread's chain of adds.  Adds and
// products that must match are __fadd_rn/__fmul_rn/__fsub_rn/__fdiv_rn (the
// build keeps nvcc's default --fmad=true, which would contract N·w - counts
// into an FMA), and the values selection depends on are flushed (ftz()),
// as XLA on the CPU does.
//
// prefix_scan_rows_kernel replaces prefix_sum_pallas
// (repro/kernels/prefix_sum/prefix_sum.py): the tiled inclusive scan of a
// bank of S rows [S, N] in one cooperative launch.  Phase 1: each block
// scans tiles in shared memory (rows padded to 17 floats, so the 64 row
// scans hit 32 banks), writes the local scan and the tile's total.  After a
// grid.sync(), phase 2: one thread per row walks the row's tile totals in
// order (staged in shared memory) and turns them into the exclusive carries
// C_t.  After another grid.sync(), phase 3: each tile adds its carry (tile
// 0 adds 0, as the TPU kernel does).
//
//   What bounds it: 4N bytes in and 4N out per row, 8 MiB at N = 2^20,
//   2.5 us at 3.35 TB/s; the design moves 16N (the local scan is re-read
//   and re-written in phase 3, from L2 at Path A's sizes).  The chain of
//   N/1024 dependent adds per row (1024 at N = 2^20, a few us) and the two
//   grid barriers are latency the bound does not count.
//
// prefix_search_rows_kernel<GATHER, RESIDUAL> replaces searchsorted_pallas
// (<false, false>), searchsorted_gather_pallas (<true, false>) and
// residual_select_gather_pallas (<true, true>) (repro/kernels/prefix_sum/
// search.py): one thread per output slot bisects its row's CDF, read from
// global memory through the read-only path (4 MiB a row at N = 2^20, so it
// stays in L2); ceil(log2(N + 1)) steps bound the loop, which stops when
// lo == hi (nothing changes after that in the TPU's fixed trip).  left: the
// first c >= u; right: the first c > u; clipped to N - 1.  mid = lo +
// (hi - lo) / 2 keeps clear of int32 overflow near N = 2^30.  RESIDUAL:
// slot i < n_det[s] bisects the count CDF at (float)i, other slots the
// residual CDF at u (only the search a slot keeps is run).
//
//   What bounds it: per row the CDF (4N) and u (4N) in, ancestors (4N) out,
//   and with GATHER the state in and out (8DN): 12 MiB at N = 2^20 index
//   only, 3.8 us.  Each of the ~21 steps is a dependent read; the draws of
//   the systematic kinds rise with i, so a warp's 32 paths coincide until
//   the last few steps, while multinomial draws are random and scatter
//   their last steps over L2 sectors.
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
//   scan's traffic and three more grid barriers (residual: seven).

#include "../../common.cuh"

#define TILE 1024
#define PAD 17  // a row of 16 in shared memory, padded

// The in-tile scan's shared memory: the tile as 64 rows of 16, their totals
// as 4 rows of 16, and the scan of those 4 totals.
struct ScanSmem {
  float l0[64 * PAD];
  float l1[4 * PAD];
  float l2[4];
};

__device__ __forceinline__ float fadd(float a, float b) { return ftz(__fadd_rn(a, b)); }

__device__ __forceinline__ float& at0(ScanSmem& sm, int e) {
  return sm.l0[(e >> 4) * PAD + (e & 15)];
}

// Inclusive scan of 16 values in place, left to right; returns the last.
__device__ __forceinline__ float seq16(float* p) {
  float acc = p[0];
#pragma unroll
  for (int j = 1; j < 16; ++j) {
    acc = fadd(acc, p[j]);
    p[j] = acc;
  }
  return acc;
}

// The tile in sm.l0, scanned in place in XLA-CPU's base-16 order; every
// thread of the block calls it.  The total lands in at0(sm, TILE - 1).
__device__ void tile_scan16(ScanSmem& sm) {
  const int tid = threadIdx.x;
  if (tid < 64) sm.l1[(tid >> 4) * PAD + (tid & 15)] = seq16(sm.l0 + tid * PAD);
  __syncthreads();
  if (tid < 4) seq16(sm.l1 + tid * PAD);
  __syncthreads();
  if (tid == 0) {
    float acc = sm.l1[15];
    sm.l2[0] = acc;
    for (int q = 1; q < 4; ++q) {
      acc = fadd(acc, sm.l1[q * PAD + 15]);
      sm.l2[q] = acc;
    }
  }
  __syncthreads();
  if (tid >= 16 && tid < 64) {
    float& v = sm.l1[(tid >> 4) * PAD + (tid & 15)];
    v = fadd(v, sm.l2[(tid >> 4) - 1]);
  }
  __syncthreads();
  for (int e = tid; e < TILE; e += NT) {
    if (e < 16) continue;  // row 0 keeps its own scan
    const int p = (e >> 4) - 1;
    at0(sm, e) = fadd(at0(sm, e), sm.l1[(p >> 4) * PAD + (p & 15)]);
  }
  __syncthreads();
}

// A row's tile totals tot[0 .. T) become its exclusive carries in tile
// order: C_0 = 0, C_{t+1} = C_t + tot_t, one thread adding, staged through
// shared memory (buf, TILE floats) in chunks.
__device__ void row_carries(float* tot, int T, float* buf) {
  float c = 0.0f;
  for (int t0 = 0; t0 < T; t0 += TILE) {
    const int cnt = min(TILE, T - t0);
    for (int t = threadIdx.x; t < cnt; t += NT) buf[t] = tot[t0 + t];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int t = 0; t < cnt; ++t) {
        const float v = buf[t];
        buf[t] = c;
        c = fadd(c, v);
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += NT) tot[t0 + t] = buf[t];
    __syncthreads();
  }
}

// The tiled scan of rows [rows, n] from x into y (y may be x), with the
// tile totals and then the carries in tot [rows, n / TILE]; rows for which
// skip(r) holds are left alone.  Every block of the grid calls it (two
// grid.sync()).  On return a block has finished its own tiles; the caller
// syncs the grid before reading another block's.
template <class Skip>
__device__ void scan_rows(cg::grid_group& grid, const float* x, float* y, float* tot, int rows,
                          int n, ScanSmem& sm, Skip skip) {
  const int T = n / TILE;
  const long long tiles = (long long)rows * T;
  for (long long q = blockIdx.x; q < tiles; q += gridDim.x) {
    if (skip((int)(q / T))) continue;
    const float* xt = x + q * TILE;
    for (int e = threadIdx.x; e < TILE; e += NT) at0(sm, e) = ftz(xt[e]);
    __syncthreads();
    tile_scan16(sm);
    float* yt = y + q * TILE;
    for (int e = threadIdx.x; e < TILE; e += NT) yt[e] = at0(sm, e);
    if (threadIdx.x == 0) tot[q] = at0(sm, TILE - 1);
    __syncthreads();
  }
  grid.sync();
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    if (!skip(r)) row_carries(tot + (size_t)r * T, T, sm.l0);
  }
  grid.sync();
  for (long long q = blockIdx.x; q < tiles; q += gridDim.x) {
    if (skip((int)(q / T))) continue;
    const float c = tot[q];
    float* yt = y + q * TILE;
    for (int e = threadIdx.x; e < TILE; e += NT) yt[e] = fadd(yt[e], c);
  }
}

__global__ void __launch_bounds__(NT) prefix_scan_rows_kernel(const float* x, float* y,
                                                              float* tot, int rows, int n) {
  cg::grid_group grid = cg::this_grid();
  __shared__ ScanSmem sm;
  scan_rows(grid, x, y, tot, rows, n, sm, [](int) { return false; });
}

// The TPU's bisection: the first index with c > u (right) or c >= u
// (left), clipped to n - 1.  RO reads through the read-only path (c not
// written by the launch).
template <bool RO>
__device__ __forceinline__ int bisect(const float* __restrict__ c, float u, bool right, int n) {
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

template <bool GATHER, bool RESIDUAL>
__global__ void __launch_bounds__(NT) prefix_search_rows_kernel(
    const float* __restrict__ cdf, const float* __restrict__ cc, const float* __restrict__ u,
    const int* __restrict__ n_det, const float* __restrict__ state, int* __restrict__ anc,
    float* __restrict__ out, int n, int d, int right) {
  const int s = blockIdx.y;
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= n) return;
  const size_t row = (size_t)s * n;
  int k;
  if (RESIDUAL && i < n_det[s]) {
    k = bisect<true>(cc + row, __int2float_rn(i), true, n);
  } else {
    k = bisect<true>(cdf + row, u[row + i], RESIDUAL || right, n);
  }
  anc[row + i] = k;
  if (GATHER) {
    for (int c = 0; c < d; ++c) {
      const size_t plane = ((size_t)s * d + c) * n;
      out[plane + i] = state[plane + k];
    }
  }
}

template <int KIND>
__global__ void __launch_bounds__(NT) prefix_step_rows_kernel(
    const float* __restrict__ lw, const float* __restrict__ state,
    const float* __restrict__ ubase, const float* __restrict__ u0, float thr,
    int* __restrict__ anc, float* __restrict__ out, float* __restrict__ stats,
    float* __restrict__ scratch, float* work, int rows, int n, int d) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float row_m[];          // [rows] shift m; residual: then n_det
  int* row_flag = (int*)(row_m + rows);     // [rows] bit 0: degenerate, bit 1: do
  __shared__ float red[NT / 32];
  __shared__ ScanSmem sm;
  const StepScratch sc = step_scratch(scratch, rows, gridDim.x, 0);
  step_prelude(grid, lw, nullptr, thr, stats, sc, row_m, row_flag, red, rows, n, 0);

  const int T = n / TILE;
  const size_t sn = (size_t)rows * n;
  const size_t gtid = (size_t)blockIdx.x * NT + threadIdx.x;
  const size_t gstride = (size_t)gridDim.x * NT;
  const float nf = (float)n;
  float* w = sc.wbuf;  // exp(lw - m), 1/N on a degenerate row
  float* cdf;          // the CDF the draws are scaled from and searched
  float* cc = nullptr;
  if (KIND != 3) {
    scan_rows(grid, w, w, work, rows, n, sm, [&](int r) { return !(row_flag[r] & 2); });
    cdf = w;
  } else {
    float* cw = work;
    cc = cw + sn;                  // counts, then their CDF
    cdf = cc + sn;                 // residuals, then their CDF
    float* tot = cdf + sn;         // [2·rows, T]
    float* part = tot + 2 * (size_t)rows * T;  // [rows, gridDim.x]
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

  const float inv_n = __fdiv_rn(1.0f, nf);  // x / N as XLA computes it: x·fl(1/N)
  for (size_t q = gtid; q < sn; q += gstride) {
    const int s = (int)(q / n);
    const int i = (int)(q % n);
    int k = i;
    if (row_flag[s] & 2) {
      const float* c = cdf + (size_t)s * n;
      const float total = c[n - 1];
      if (KIND == 3) {
        if (i < __float2int_rz(row_m[s])) {  // NaN gives 0, as XLA's conversion
          k = bisect<false>(cc + (size_t)s * n, __int2float_rn(i), true, n);
        } else {
          k = bisect<false>(c, ftz(__fmul_rn(__ldg(ubase + q), total)), true, n);
        }
      } else if (KIND == 0) {
        k = bisect<false>(c, ftz(__fmul_rn(__ldg(ubase + q), total)), true, n);
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

// The step kernel of each KIND.
static const void* step_kernel(int kind) {
  switch (kind) {
    case 0: return (const void*)prefix_step_rows_kernel<0>;
    case 1: return (const void*)prefix_step_rows_kernel<1>;
    case 2: return (const void*)prefix_step_rows_kernel<2>;
    case 3: return (const void*)prefix_step_rows_kernel<3>;
    default: return nullptr;
  }
}

extern "C" {

// Blocks of the cooperative scan grid: as many as can be co-resident, and
// no more than the bank has tiles.
int prefix_scan_grid(int rows, int n, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, prefix_scan_rows_kernel, NT, 0);
  if (err != cudaSuccess) return (int)err;
  const long long need = (long long)rows * (n / TILE);
  long long g = (long long)per_sm * sms;
  if (g > need) g = need;
  *blocks = (int)(g < 1 ? 1 : g);
  return per_sm < 1 ? (int)cudaErrorCooperativeLaunchTooLarge : 0;
}

int prefix_scan_rows(const void* x, void* y, void* tot, int rows, int n, int blocks,
                     void* stream) {
  const float* a_x = (const float*)x;
  float* a_y = (float*)y;
  float* a_tot = (float*)tot;
  void* args[] = {(void*)&a_x, (void*)&a_y, (void*)&a_tot, (void*)&rows, (void*)&n};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)prefix_scan_rows_kernel,
                                                dim3(blocks), dim3(NT), args, 0,
                                                (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The search over a bank: with cc (not null) the residual select, with
// state (not null) the copy of each ancestor's state.
int prefix_search_rows(const void* cdf, const void* cc, const void* u, const void* n_det,
                       const void* state, void* anc, void* out, int rows, int n, int d,
                       int right, void* stream) {
  dim3 grid((n + NT - 1) / NT, rows);
  const float* a_cdf = (const float*)cdf;
  const float* a_cc = (const float*)cc;
  const float* a_u = (const float*)u;
  const int* a_nd = (const int*)n_det;
  const float* a_state = (const float*)state;
  int* a_anc = (int*)anc;
  float* a_out = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (cc != nullptr) {
    prefix_search_rows_kernel<true, true><<<grid, NT, 0, st>>>(a_cdf, a_cc, a_u, a_nd, a_state,
                                                                a_anc, a_out, n, d, right);
  } else if (state != nullptr) {
    prefix_search_rows_kernel<true, false><<<grid, NT, 0, st>>>(a_cdf, a_cc, a_u, a_nd, a_state,
                                                                 a_anc, a_out, n, d, right);
  } else {
    prefix_search_rows_kernel<false, false><<<grid, NT, 0, st>>>(a_cdf, a_cc, a_u, a_nd,
                                                                  a_state, a_anc, a_out, n, d,
                                                                  right);
  }
  return (int)cudaGetLastError();
}

int prefix_step_grid(int kind, int rows, int n, int* blocks) {
  const void* kernel = step_kernel(kind);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return coop_step_grid(kernel, rows, n, blocks);
}

int prefix_step_rows(int kind, const void* lw, const void* state, const void* ubase,
                     const void* u0, float thr, void* anc, void* out, void* stats,
                     void* scratch, void* work, int rows, int n, int d, int blocks,
                     void* stream) {
  const void* kernel = step_kernel(kind);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const float* a_lw = (const float*)lw;
  const float* a_state = (const float*)state;
  const float* a_ubase = (const float*)ubase;
  const float* a_u0 = (const float*)u0;
  int* a_anc = (int*)anc;
  float* a_out = (float*)out;
  float* a_stats = (float*)stats;
  float* a_scratch = (float*)scratch;
  float* a_work = (float*)work;
  void* args[] = {(void*)&a_lw, (void*)&a_state, (void*)&a_ubase, (void*)&a_u0, (void*)&thr,
                  (void*)&a_anc, (void*)&a_out, (void*)&a_stats, (void*)&a_scratch,
                  (void*)&a_work, (void*)&rows, (void*)&n, (void*)&d};
  return coop_step_launch(kernel, blocks, rows, args, stream);
}

// Kernel `which` of this file's resource table rows, in the order of
// repro_torch/analysis/smem.py: kernel_attributes' four numbers.
int prefix_sum_attributes(int which, int dynamic_smem, int* out) {
  switch (which) {
    case 0: return kernel_attributes(prefix_scan_rows_kernel, dynamic_smem, out);
    case 1: return kernel_attributes(prefix_search_rows_kernel<false, false>, dynamic_smem, out);
    case 2: return kernel_attributes(prefix_search_rows_kernel<true, false>, dynamic_smem, out);
    case 3: return kernel_attributes(prefix_search_rows_kernel<true, true>, dynamic_smem, out);
    case 4: case 5: case 6: case 7:
      return kernel_attributes(step_kernel(which - 4), dynamic_smem, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
