// logsumexp_rows_kernel: log Σ exp(x) of each row of f32[S, N], in an order of
// adds that depends on N alone, never on S (NVIDIA Hopper, sm_90a).
//
// Built by repro_torch/kernels/build.py (nvcc -gencode arch=compute_90a,
// code=sm_90a -O3 -ftz=true -shared) and bound with ctypes by
// repro_torch/kernels/reduce/reduce.py.  The entry point makes one
// cooperative launch on the caller's stream, allocates nothing (the wrapper
// hands it a scratch of 2·S·32 floats) and returns cudaGetLastError().  Its
// plain PyTorch version, the same adds in the same order, is in ../ref.py;
// that order is fixed, and the plain version's arithmetic is not edited.
//
// It has no TPU counterpart.  The adaptive AIS schedule (ais/schedule.py)
// reduces a row [N] in a single run and a bank [S, N] in a bank run; a
// library reduction picks its split by the number of outputs, so a bank row
// rounded otherwise than its single call and a bisection midpoint compared
// the other way (ROADMAP Queue C item 21).  The order, of 1024 chains:
//
//   1. chain t < 1024 takes the quads of 4 consecutive lanes q = t, t + 1024,
//      t + 2·1024, ... and adds exp(x - shift) of their lanes in lane order
//      to its own sum, starting from 0;
//   2. each warp of 32 chains, 32w ... 32w + 31, halves its 32 sums (lanes l
//      and l + 16, then l + 8, ...);
//   3. the 32 warps' sums are added in warp order, starting from warp 0's;
//   4. the row's result is shift + log(sum).  The shift is the row's max
//      (a max has no order; NaN wins, as in torch.amax), or 0 where it is not
//      finite (all -inf gives -inf, +inf gives +inf, NaN gives NaN).
//
// Every add and subtract is __fadd_rn/__fsub_rn (no contraction) and the
// build's -ftz=true flushes subnormals, as the plain version does by hand;
// expf and logf round as torch.exp and torch.log do on the card.
//
// The launch: a unit is (row r, warp w < 32), the 32 chains of step 2; it
// needs nothing of the row's other 31 units but the shift and, in step 3,
// their sums.  A block of LSE_WARPS warps takes one unit at a time, on a
// co-resident grid (a cooperative launch, at most one block a unit) whose
// blocks take the S·32 units in turn, so a row of 2^20 runs on 32 SMs, not
// one.  Phase 1: the block's warps split the unit's rounds (a round: the
// unit's 32 quads 32w + 1024k + lane, 512 contiguous bytes) for its max,
// into part[r·32 + w]; grid barrier.  Phase 2: every warp reduces the
// row's 32 maxima to the shift; warps 1 .. LSE_WARPS - 1 (the makers) copy
// chunks of LSE_CHUNK rounds into a ring of LSE_DEPTH buffers in shared
// memory and turn them into their terms exp(x - shift) in place, a chunk
// ahead of warp 0, which adds each lane's terms in chain order, then halves
// them, into part[S·32 + r·32 + w]; grid barrier.  Phase 3: a warp a row
// adds the row's 32 unit sums in warp order.  Where the row lies on a
// 16-byte boundary and N % 4 == 0, loads are 16-byte vectors and the
// makers' copies 16-byte asynchronous copies (cp.async, each lane its own
// quads, two chunks ahead of the chunk it makes); other rows load lane by
// lane (load_quad).
//
//   What bounds it: each chain's serial adds, 4·ceil(N/4096) a lane, 1024
//   at N = 2^20: warp 0 of a unit adds 1024 terms a lane, a dependent add
//   each (~2 µs at 4 cycles an add); the terms' expf (a MUFU.EX2 and ~8
//   more instructions each, ~10^4 warp instructions a unit at N = 2^20) are
//   spread over the makers.  The bytes: S·N·4 read by the max pass and
//   again, from L2 where the bank fits there (S <= 8 at N = 2^20), by the
//   makers, each unit's through one SM.  Two grid barriers, a block
//   barrier a chunk and the cooperative launch add a few µs whatever S.
//   Candidates timed against this design (PERF.md): one warp a unit,
//   reading through a ring of 512-byte bulk copies or through registers;
//   makers that load into registers, or whose chunks come by bulk copies.

#include "../../common.cuh"

// Warps of a block, all on one unit: warp 0 adds, the others make terms.
#define LSE_WARPS 8
#define LSE_THREADS (32 * LSE_WARPS)
static_assert(LSE_THREADS == NT, "resident_blocks and kernel_attributes count blocks of NT");
#define LSE_MAKERS (LSE_WARPS - 1)
// Chains of a row (the order's threads) and units (their warps) of a row.
#define LSE_CHAINS 1024
#define LSE_UNITS (LSE_CHAINS / 32)
// Rounds of a chunk (8 KiB at 16), a maker's rounds of one, and the chunks
// of the ring in shared memory.
#define LSE_CHUNK 16
#define LSE_PER_MAKER ((LSE_CHUNK + LSE_MAKERS - 1) / LSE_MAKERS)
#define LSE_DEPTH 4
// Rounds a lane loads before it folds any into its max.
#define LSE_AHEAD 16
// Rounds of terms warp 0 reads before it adds any.
#define LSE_BATCH 8

// The four lanes of quad q of a row (4q, ..., 4q + 3); lanes past n read as
// -inf, which adds exp(-inf) = 0 to a sum and nothing to a max.
__device__ __forceinline__ float4 load_quad(const float* __restrict__ row, long long q,
                                            long long n, bool vec) {
  const long long i = 4 * q;
  if (vec) return __ldg(reinterpret_cast<const float4*>(row) + q);
  float4 v;
  v.x = __ldg(row + i);
  v.y = i + 1 < n ? __ldg(row + i + 1) : -INFINITY;
  v.z = i + 2 < n ? __ldg(row + i + 2) : -INFINITY;
  v.w = i + 3 < n ? __ldg(row + i + 3) : -INFINITY;
  return v;
}

__device__ __forceinline__ float lse_term(float x, float shift) {
  return expf(__fsub_rn(x, shift));
}

// The shift of a row from its units' maxima m[0 .. 31] (written before the
// last grid barrier): their max, or 0 where it is not finite; lane 0's, on
// every lane of the calling warp.
__device__ __forceinline__ float row_shift(const float* m) {
  float v = m[threadIdx.x & 31];
  for (int off = 16; off > 0; off >>= 1) v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, off));
  v = __shfl_sync(0xffffffffu, v, 0);
  return isfinite(v) ? v : 0.0f;
}

struct LseShared {
  // A chunk's rounds: a lane's quad, then (in place) its four terms.
  float4 buf[LSE_DEPTH][LSE_CHUNK][32];
  float red[LSE_WARPS];
};

// A 16-byte asynchronous copy from device memory into shared memory (L2
// only), in the calling thread's current group; the groups, committed in
// order, and the wait for all but the newest `pending` of them.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// part: 2·rows·LSE_UNITS floats of scratch (the units' maxima, then their
// sums), written and read only within the launch.
__global__ void __launch_bounds__(LSE_THREADS) logsumexp_rows_kernel(const float* __restrict__ x,
                                                                     float* __restrict__ out,
                                                                     float* part, int rows,
                                                                     long long n) {
  __shared__ __align__(16) LseShared sm;
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long quads = (n + 3) / 4;
  const long long units = (long long)rows * LSE_UNITS;
  // Every row shares x's alignment when N % 4 == 0.
  const bool vec = ((uintptr_t)x & 15) == 0 && (n & 3) == 0;
  float* pmax = part;
  float* psum = part + units;

  // Phase 1: each unit's max (order-free), its rounds split over the warps.
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const float* row = x + (u / LSE_UNITS) * n;
    const long long q0 = (u % LSE_UNITS) * 32 + lane;  // this lane's quad of round 0
    const long long mine = q0 < quads ? (quads - q0 + LSE_CHAINS - 1) / LSE_CHAINS : 0;
    float m = -INFINITY;
    for (long long k0 = warp; k0 < mine; k0 += (long long)LSE_WARPS * LSE_AHEAD) {
      float4 v[LSE_AHEAD];
#pragma unroll
      for (int a = 0; a < LSE_AHEAD; ++a) {
        const long long k = k0 + (long long)a * LSE_WARPS;
        if (k < mine) v[a] = load_quad(row, q0 + k * LSE_CHAINS, n, vec);
      }
#pragma unroll
      for (int a = 0; a < LSE_AHEAD; ++a) {
        if (k0 + (long long)a * LSE_WARPS < mine)
          m = nanmax(m, nanmax(nanmax(v[a].x, v[a].y), nanmax(v[a].z, v[a].w)));
      }
    }
    for (int off = 16; off > 0; off >>= 1) m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) sm.red[warp] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < LSE_WARPS; ++w) m = nanmax(m, sm.red[w]);
      pmax[u] = m;
    }
    __syncthreads();  // red is free for the next unit
  }
  grid.sync();

  // Phase 2: warp 0 adds each lane's chain in order, a chunk behind the
  // makers, which turn each chunk's quads into terms in place; then warp 0
  // halves its 32 sums (lane l takes lane l + 16, then l + 8, ...; lane 0
  // holds the unit's sum).  On 16-byte rows each maker lane copies its own
  // quads into the ring by 16-byte asynchronous copies, LSE_DEPTH - 2
  // chunks ahead of the chunk it makes: unlike loads into registers, they
  // stay in flight across the block's barriers.
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long row_i = u / LSE_UNITS;
    const float* row = x + row_i * n;
    const float shift = row_shift(pmax + row_i * LSE_UNITS);
    const long long u0 = (u % LSE_UNITS) * 32;
    const long long q0 = u0 + lane;
    const long long rounds = u0 < quads ? (quads - u0 + LSE_CHAINS - 1) / LSE_CHAINS : 0;
    const long long mine = q0 < quads ? (quads - q0 + LSE_CHAINS - 1) / LSE_CHAINS : 0;
    const long long chunks = (rounds + LSE_CHUNK - 1) / LSE_CHUNK;
    // A maker's rounds of chunk c: c·LSE_CHUNK + maker + i·LSE_MAKERS, in
    // buffer c mod LSE_DEPTH.  Each copy is one group, empty past the end.
    auto copy = [&](long long c) {
#pragma unroll
      for (int i = 0; i < LSE_PER_MAKER; ++i) {
        const int j = warp - 1 + i * LSE_MAKERS;
        const long long k = c * LSE_CHUNK + j;
        if (c < chunks && j < LSE_CHUNK && k < mine)
          cp_async16(&sm.buf[c % LSE_DEPTH][j][lane],
                     reinterpret_cast<const float4*>(row) + q0 + k * LSE_CHAINS);
      }
      cp_async_commit();
    };
    auto make = [&](long long c) {
#pragma unroll
      for (int i = 0; i < LSE_PER_MAKER; ++i) {
        const int j = warp - 1 + i * LSE_MAKERS;
        const long long k = c * LSE_CHUNK + j;
        if (j < LSE_CHUNK && k < mine) {
          float4& b = sm.buf[c % LSE_DEPTH][j][lane];
          const float4 v = vec ? b : load_quad(row, q0 + k * LSE_CHAINS, n, false);
          b = make_float4(lse_term(v.x, shift), lse_term(v.y, shift), lse_term(v.z, shift),
                          lse_term(v.w, shift));
        }
      }
    };
    if (warp > 0 && chunks > 0) {
      if (vec) {
        for (int c = 0; c < LSE_DEPTH - 1; ++c) copy(c);
        cp_async_wait<LSE_DEPTH - 2>();  // chunk 0 has landed
      }
      make(0);
    }
    __syncthreads();
    float s = 0.0f;
    for (long long c = 0; c < chunks; ++c) {
      if (warp == 0) {
        const float4* t = sm.buf[c % LSE_DEPTH][0] + lane;
        const long long left = mine - c * LSE_CHUNK;  // this lane's rounds from chunk c on
        const int cnt = (int)(left < LSE_CHUNK ? (left > 0 ? left : 0) : LSE_CHUNK);
        for (int j0 = 0; j0 < cnt; j0 += LSE_BATCH) {
          float4 e[LSE_BATCH];
#pragma unroll
          for (int j = 0; j < LSE_BATCH; ++j)
            if (j0 + j < cnt) e[j] = t[(j0 + j) * 32];
#pragma unroll
          for (int j = 0; j < LSE_BATCH; ++j) {
            if (j0 + j < cnt) {
              s = __fadd_rn(s, e[j].x);
              s = __fadd_rn(s, e[j].y);
              s = __fadd_rn(s, e[j].z);
              s = __fadd_rn(s, e[j].w);
            }
          }
        }
      } else if (c + 1 < chunks) {
        if (vec) {
          copy(c + LSE_DEPTH - 1);  // into chunk c - 1's buffer, added before the last barrier
          cp_async_wait<LSE_DEPTH - 2>();  // chunk c + 1 has landed
        }
        make(c + 1);
      }
      __syncthreads();
    }
    if (warp > 0 && vec) cp_async_wait<0>();  // no copy outlives the unit
    if (warp == 0) {
      for (int off = 16; off > 0; off >>= 1)
        s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
      if (lane == 0) psum[u] = s;
    }
  }
  grid.sync();

  // Phase 3: a row's 32 unit sums in warp order, from unit 0's; a warp a row.
  for (long long row_i = (long long)blockIdx.x * LSE_WARPS + warp; row_i < rows;
       row_i += (long long)gridDim.x * LSE_WARPS) {
    const float shift = row_shift(pmax + row_i * LSE_UNITS);
    const float v = psum[row_i * LSE_UNITS + lane];
    float s = __shfl_sync(0xffffffffu, v, 0);
    for (int q = 1; q < LSE_UNITS; ++q) s = __fadd_rn(s, __shfl_sync(0xffffffffu, v, q));
    if (lane == 0) out[row_i] = __fadd_rn(shift, logf(s));
  }
}

extern "C" {

// Blocks of the cooperative grid for `rows` rows: as many as can be
// co-resident, and no more than the rows have units.
int reduce_logsumexp_grid(int rows, int* blocks) {
  return resident_blocks(logsumexp_rows_kernel, 0, (long long)rows * LSE_UNITS, blocks);
}

// out[r] = log Σ_i exp(x[r, i]) for r < rows; part: 2·rows·32 floats.
int reduce_logsumexp_rows(const void* x, void* out, void* part, int rows, long long n,
                          void* stream) {
  if (rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const int err = reduce_logsumexp_grid(rows, &blocks);
  if (err != 0) return err;
  const float* a_x = (const float*)x;
  float* a_out = (float*)out;
  float* a_part = (float*)part;
  void* args[] = {(void*)&a_x, (void*)&a_out, (void*)&a_part, (void*)&rows, (void*)&n};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)logsumexp_rows_kernel,
                                                    dim3(blocks), dim3(LSE_THREADS), args, 0,
                                                    (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Kernel `which` of this file's resource table rows, in the order of
// repro_torch/analysis/smem.py: registers, static shared memory, largest
// block, blocks of LSE_THREADS threads co-resident on one SM.
int reduce_attributes(int which, int dynamic_smem, int* out) {
  if (which != 0) return (int)cudaErrorInvalidValue;
  return kernel_attributes(logsumexp_rows_kernel, dynamic_smem, out);
}

}  // extern "C"
