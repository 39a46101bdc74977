// logsumexp_rows_kernel: log Σ exp(x) of each row of f32[S, N], in an order of
// adds that depends on N alone, never on S (NVIDIA Hopper, sm_90a).
//
// Built by repro_torch/kernels/build.py (nvcc -gencode arch=compute_90a,
// code=sm_90a -O3 -ftz=true -shared) and bound with ctypes by
// repro_torch/kernels/reduce/reduce.py.  The entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().  Its
// plain PyTorch version, the same adds in the same order, is in ../ref.py.
//
// It has no TPU counterpart.  The adaptive AIS schedule (ais/schedule.py)
// reduces a row [N] in a single run and a bank [S, N] in a bank run; a
// library reduction picks its split by the number of outputs, so a bank row
// rounded otherwise than its single call and a bisection midpoint compared
// the other way (ROADMAP Queue C item 21).  Here each row is one block:
//
//   1. each thread t takes the quads of 4 consecutive lanes q = t, t + NT,
//      t + 2·NT, ... and folds them into its running max (a max has no
//      order; NaN wins, as in torch.amax);
//   2. the block's max by a fixed tree (xor shuffles within a warp, then the
//      warps' values in order); the shift is that max, or 0 where it is not
//      finite (all -inf gives -inf, +inf gives +inf, NaN gives NaN);
//   3. each thread adds exp(x - shift) of its quads' lanes in lane order to
//      its own sum, starting from 0;
//   4. the block's sum by the fixed tree: each warp halves its 32 values
//      (lanes l and l + 16, then l + 8, ...), then the warps' sums are added
//      in warp order, starting from warp 0's;
//   5. the row's result is shift + log(sum).
//
// Every add and subtract is __fadd_rn/__fsub_rn (no contraction) and the
// build's -ftz=true flushes subnormals, as the plain version does by hand;
// expf and logf round as torch.exp and torch.log do on the card.
//
//   What bounds it: each element read twice (the max, then the sum), 8
//   bytes; at S = 4, N = 2^20 the first read moves 16 MiB from memory, the
//   second finds the row in L2.  A row is one block, so a bank of S rows
//   runs on S SMs: at small S the kernel is bound by one SM's loads in
//   flight, not by the card's memory rate.
//   What the design does about it: LSE_NT = 1024 threads a block, 16-byte
//   loads where the row allows (a row at a 16-byte boundary and N % 4 == 0),
//   LSE_UNROLL quads a thread loaded before any is folded.  Order first:
//   splitting a row over more blocks would need a second pass or a grid
//   barrier to keep the adds fixed.

#include "../../common.cuh"

#define LSE_NT 1024
#define LSE_UNROLL 4

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

// The block's reduction of one value a thread, in the fixed tree of steps 2
// and 4: each warp's 32 values halved (lane l takes lane l + 16, then l + 8,
// ...; lane 0 holds the warp's result), then the warps' results added in
// warp order, starting from warp 0's.  (A second halving over the warps
// moved the adaptive ladder's β enough to move a systematic run's logZ
// 7e-4 from the JAX package's on the CPU, past the parity tests' 1e-4.)
template <bool IS_MAX>
__device__ float lse_block(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_down_sync(0xffffffffu, v, off);
    v = IS_MAX ? nanmax(v, o) : __fadd_rn(v, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read by the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int q = 1; q < LSE_NT / 32; ++q) v = IS_MAX ? nanmax(v, red[q]) : __fadd_rn(v, red[q]);
  return v;
}

__device__ __forceinline__ float lse_term(float x, float shift) {
  return expf(__fsub_rn(x, shift));
}

__global__ void __launch_bounds__(LSE_NT) logsumexp_rows_kernel(const float* __restrict__ x,
                                                                float* __restrict__ out,
                                                                long long n) {
  __shared__ float red[LSE_NT / 32];
  const float* row = x + (long long)blockIdx.x * n;
  const long long quads = (n + 3) / 4;
  const bool vec = ((uintptr_t)row & 15) == 0 && (n & 3) == 0;
  const long long t = threadIdx.x;

  float m = -INFINITY;
  for (long long q0 = t; q0 < quads; q0 += (long long)LSE_UNROLL * LSE_NT) {
    float4 v[LSE_UNROLL];
#pragma unroll
    for (int k = 0; k < LSE_UNROLL; ++k) {
      const long long q = q0 + (long long)k * LSE_NT;
      if (q < quads) v[k] = load_quad(row, q, n, vec);
    }
#pragma unroll
    for (int k = 0; k < LSE_UNROLL; ++k) {
      if (q0 + (long long)k * LSE_NT < quads) {
        m = nanmax(m, v[k].x);
        m = nanmax(m, v[k].y);
        m = nanmax(m, v[k].z);
        m = nanmax(m, v[k].w);
      }
    }
  }
  m = lse_block<true>(m, red);
  const float shift = isfinite(m) ? m : 0.0f;

  float s = 0.0f;
  for (long long q0 = t; q0 < quads; q0 += (long long)LSE_UNROLL * LSE_NT) {
    float4 v[LSE_UNROLL];
#pragma unroll
    for (int k = 0; k < LSE_UNROLL; ++k) {
      const long long q = q0 + (long long)k * LSE_NT;
      if (q < quads) v[k] = load_quad(row, q, n, vec);
    }
#pragma unroll
    for (int k = 0; k < LSE_UNROLL; ++k) {
      if (q0 + (long long)k * LSE_NT < quads) {
        s = __fadd_rn(s, lse_term(v[k].x, shift));
        s = __fadd_rn(s, lse_term(v[k].y, shift));
        s = __fadd_rn(s, lse_term(v[k].z, shift));
        s = __fadd_rn(s, lse_term(v[k].w, shift));
      }
    }
  }
  s = lse_block<false>(s, red);
  if (t == 0) out[blockIdx.x] = __fadd_rn(shift, logf(s));
}

extern "C" {

// out[r] = log Σ_i exp(x[r, i]) for r < rows; a block per row.
int reduce_logsumexp_rows(const void* x, void* out, int rows, long long n, void* stream) {
  if (rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  logsumexp_rows_kernel<<<rows, LSE_NT, 0, (cudaStream_t)stream>>>((const float*)x,
                                                                   (float*)out, n);
  return (int)cudaGetLastError();
}

// Kernel `which` of this file's resource table rows, in the order of
// repro_torch/analysis/smem.py: registers, static shared memory, largest
// block, blocks of LSE_NT threads co-resident on one SM.
int reduce_attributes(int which, int dynamic_smem, int* out) {
  if (which != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, (const void*)logsumexp_rows_kernel);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, (const void*)logsumexp_rows_kernel, LSE_NT, (size_t)dynamic_smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = per_sm;
  return 0;
}

}  // extern "C"
