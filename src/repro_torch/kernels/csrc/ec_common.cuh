// Pieces shared by the EC kernels (ec_sorted.cu, ec_onehot.cu).
//
// Launch layout, common to all three kernels: the grid has one CUDA block
// per entry of `run_starts` (built by kernels/_build.py::tile_runs). Block
// i owns the run of consecutive kernel blocks [run_starts[i],
// run_starts[i+1]) that all map to one output tile; a block whose start is
// `nblocks` has no run and returns at once. By the partition contract the
// blocks of a tile are consecutive, so every visited tile is one run and
// exactly one CUDA block writes it: no atomics, and each output row's sum
// runs in slot order.
//
// Arithmetic is written with __fmul_rn / __fadd_rn so that nvcc cannot
// contract a multiply and an add into an FMA: the products and sums must
// round exactly as the plain f32 reference rounds them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define EC_THREADS 256
#define EC_MAX_NIN 4

// Row pointers of the nin input operands: factor matrices (padded_w, R)
// for the in-kernel gather, or pre-gathered (nnz, R) rows for ec_blocked.
template <typename T>
struct EcInputs {
  const T* p[EC_MAX_NIN];
};

__device__ __forceinline__ float ec_to_f32(float x) { return x; }
__device__ __forceinline__ float ec_to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The run this CUDA block owns; false if it owns none.
__device__ __forceinline__ bool ec_block_run(const int* run_starts,
                                             int nblocks, int* b0, int* b1) {
  *b0 = run_starts[blockIdx.x];
  if (*b0 >= nblocks) return false;
  *b1 = run_starts[blockIdx.x + 1];
  return true;
}

// E[p*R + r] = ((val[p] * F_0[idx[p,0], r]) * F_1[idx[p,1], r]) ... for the
// block_p slots starting at slot0, gathering factor rows in the kernel.
// Consecutive threads take consecutive columns of one row, so a warp reads
// a 128-byte factor row per load at R = 32; each slot's value and indices
// are one broadcast load per warp.
template <int NIN>
__device__ __forceinline__ void ec_gather_products(
    float* E, const float* __restrict__ values,
    const int* __restrict__ input_indices, EcInputs<float> F, int64_t slot0,
    int block_p, int R) {
  const int n = block_p * R;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int p = i / R;
    const int r = i - p * R;
    const int64_t slot = slot0 + p;
    float e = values[slot];
#pragma unroll
    for (int w = 0; w < NIN; ++w) {
      const int64_t row = input_indices[slot * NIN + w];
      e = __fmul_rn(e, F.p[w][row * R + r]);
    }
    E[i] = e;
  }
}

// The same products from rows gathered before the kernel: G_w is (nnz, R)
// in T (f32 or bf16), cast to f32 here.
template <int NIN, typename T>
__device__ __forceinline__ void ec_pregathered_products(
    float* E, const float* __restrict__ values, EcInputs<T> G, int64_t slot0,
    int block_p, int R) {
  const int n = block_p * R;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int p = i / R;
    const int64_t slot = slot0 + p;
    const int64_t at = slot0 * R + i;
    float e = values[slot];
#pragma unroll
    for (int w = 0; w < NIN; ++w) e = __fmul_rn(e, ec_to_f32(G.p[w][at]));
    E[i] = e;
  }
}

// Launch `kernel` with `smem` bytes of dynamic shared memory, raising the
// per-kernel limit first where it exceeds the 48 KiB default.
template <typename Kernel, typename... Args>
static cudaError_t ec_launch(Kernel kernel, int grid, int smem,
                             cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, EC_THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

extern "C" const char* ec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
