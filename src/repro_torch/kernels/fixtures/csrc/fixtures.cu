// The contract checks' two fixture kernels for NVIDIA Hopper (sm_90a), and
// the card's limits that the checks read.
//
// Built by repro_torch/kernels/build.py (nvcc -gencode arch=compute_90a,
// code=sm_90a -O3 -ftz=true -shared) and bound with ctypes by
// repro_torch/kernels/fixtures/fixtures.py.  Each entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().  Their
// plain PyTorch versions are in ../ref.py.  They are deliberately misused by
// repro_torch/analysis/fixtures.py, the programs that prove each pass of the
// contract checks fires; the kernels themselves are right.
//
// copy_kernel replaces _copy_launch (repro/analysis/fixtures.py), a Pallas
// whole-array copy o = x: two chained in extra_launch, one in the
// telemetry-on run of leaky_telemetry.
//
//   What bounds it: each element read once and written once, 8 bytes: at
//   N = 2^23 f32, 64 MiB, 0.020 ms at 3.35 TB/s; at the fixtures' N = 2048,
//   16 KiB, so a launch's latency.
//   What the design does about it: 16-byte vectors, COPY_UNROLL of them a
//   thread loaded before any is stored, on a grid of the blocks that can be
//   co-resident (blocks per SM x SMs), no more than one vector a thread
//   needs, so N = 2048 stays two blocks.  A torch view may start at any
//   4-byte offset and N need not be a multiple of 4: the up to 3 elements
//   before x's first 16-byte boundary (the head) and after the last whole
//   vector (the tail) are copied one by one.  The wrapper gives o the same
//   offset modulo 16 bytes as x (same_phase_empty); fixture_copy refuses a
//   pair whose offsets differ (cudaErrorInvalidValue).  The TPU kernel
//   stages the whole array in VMEM; nothing is staged here.
//
// iota_kernel replaces the pallas_call of hbm_roundtrip (same file), which
// writes int32[1, N] = 0..N-1; the fixture then indexes the state with it
// outside any kernel, the round trip of ancestors through device memory
// that the fused apply and step remove.
//
//   What bounds it: the 4N bytes written: 32 MiB at N = 2^23, 0.010 ms at
//   3.35 TB/s.
//   What the design does about it: copy_kernel's shape without the loads.
//   16-byte int4 stores of four consecutive values, IOTA_UNROLL of them a
//   thread a turn of its loop, on a grid of the blocks that can be
//   co-resident, no more than one vector a thread needs (the grid-stride
//   loop of 4-byte stores on up to 65535 blocks it replaces reached 39% of
//   the bound).  An output view may start at any 4-byte offset and N need
//   not be a multiple of 4: the up to 3 elements before its first 16-byte
//   boundary (the head) and after the last whole vector (the tail) are
//   written one by one.

#include "../../common.cuh"

// 16-byte vectors a thread of copy_kernel loads before it stores them.
#define COPY_UNROLL 4
// 16-byte vectors a thread of iota_kernel stores a turn of its loop.
#define IOTA_UNROLL 4

__global__ void __launch_bounds__(NT) copy_kernel(const float* __restrict__ x,
                                                  float* __restrict__ o, long long n) {
  const long long tid = (long long)blockIdx.x * NT + threadIdx.x;
  const long long stride = (long long)gridDim.x * NT;
  const long long head = min(n, (long long)(((16 - ((uintptr_t)x & 15)) & 15) >> 2));
  const long long nvec = (n - head) >> 2;
  const long long tail = head + 4 * nvec;
  const float4* x4 = reinterpret_cast<const float4*>(x + head);
  float4* o4 = reinterpret_cast<float4*>(o + head);
  if (nvec <= stride) {  // at most one vector a thread: no unrolled guards
    if (tid < nvec) o4[tid] = __ldg(x4 + tid);
  } else {
    for (long long j = tid; j < nvec; j += COPY_UNROLL * stride) {
      float4 v[COPY_UNROLL];
#pragma unroll
      for (int k = 0; k < COPY_UNROLL; ++k) {
        if (j + k * stride < nvec) v[k] = __ldg(x4 + j + k * stride);
      }
#pragma unroll
      for (int k = 0; k < COPY_UNROLL; ++k) {
        if (j + k * stride < nvec) o4[j + k * stride] = v[k];
      }
    }
  }
  if (tid < head) o[tid] = x[tid];
  if (tid < n - tail) o[tail + tid] = x[tail + tid];
}

__global__ void __launch_bounds__(NT) iota_kernel(int* __restrict__ o, long long n) {
  const long long tid = (long long)blockIdx.x * NT + threadIdx.x;
  const long long stride = (long long)gridDim.x * NT;
  const long long head = min(n, (long long)(((16 - ((uintptr_t)o & 15)) & 15) >> 2));
  const long long nvec = (n - head) >> 2;
  const long long tail = head + 4 * nvec;
  int4* o4 = reinterpret_cast<int4*>(o + head);
  for (long long j = tid; j < nvec; j += IOTA_UNROLL * stride) {
#pragma unroll
    for (int k = 0; k < IOTA_UNROLL; ++k) {
      const long long v = j + k * stride;
      if (v < nvec) {
        const int i = (int)(head + 4 * v);
        o4[v] = make_int4(i, i + 1, i + 2, i + 3);
      }
    }
  }
  if (tid < head) o[tid] = (int)tid;
  if (tid < n - tail) o[tail + tid] = (int)(tail + tid);
}

extern "C" {

// o = x; x and o start at the same offset modulo 16 bytes.  The grid is
// the blocks co-resident on the current device, no more than one vector a
// thread needs.
int fixture_copy(const void* x, void* o, long long n, void* stream) {
  if ((((uintptr_t)x ^ (uintptr_t)o) & 15) != 0) return (int)cudaErrorInvalidValue;
  int blocks = 1;
  const int err = resident_blocks(copy_kernel, 0, (n + 4LL * NT - 1) / (4LL * NT), &blocks);
  if (err != 0) return err;
  copy_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>((const float*)x, (float*)o, n);
  return (int)cudaGetLastError();
}

// o[i] = i for i < n, o at any 4-byte offset.  The grid is the blocks
// co-resident on the current device, no more than one vector a thread needs.
int fixture_iota(void* o, long long n, void* stream) {
  int blocks = 1;
  const int err = resident_blocks(iota_kernel, 0, (n + 4LL * NT - 1) / (4LL * NT), &blocks);
  if (err != 0) return err;
  iota_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>((int*)o, n);
  return (int)cudaGetLastError();
}

// Kernel `which` of this file's resource table rows, in the order of
// repro_torch/analysis/smem.py: kernel_attributes' four numbers.
int fixtures_attributes(int which, int dynamic_smem, int* out) {
  switch (which) {
    case 0: return kernel_attributes(copy_kernel, dynamic_smem, out);
    case 1: return kernel_attributes(iota_kernel, dynamic_smem, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The current card's limits, in the order of repro_torch/analysis/smem.py's
// CARD_LIMITS: opt-in shared memory per block, shared memory per block
// without opt-in, shared memory per SM, shared memory reserved per block,
// registers per SM, threads per SM, blocks per SM, SMs.
int fixtures_device_limits(int* out) {
  const cudaDeviceAttr attrs[] = {
      cudaDevAttrMaxSharedMemoryPerBlockOptin,   cudaDevAttrMaxSharedMemoryPerBlock,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor, cudaDevAttrReservedSharedMemoryPerBlock,
      cudaDevAttrMaxRegistersPerMultiprocessor,  cudaDevAttrMaxThreadsPerMultiProcessor,
      cudaDevAttrMaxBlocksPerMultiprocessor,     cudaDevAttrMultiProcessorCount};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  for (int i = 0; err == cudaSuccess && i < 8; ++i) err = cudaDeviceGetAttribute(&out[i], attrs[i], dev);
  return (int)err;
}

}  // extern "C"
