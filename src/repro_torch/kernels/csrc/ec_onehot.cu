// ec_blocked for Hopper: tile-accumulator EC over rows gathered before the
// kernel, replacing the TPU kernel `_ec_kernel` / `ec_blocked`
// (src/repro/kernels/mttkrp_pallas.py).
//
// On the TPU it commits each block as onehot(row_in_tile)^T @ E on the
// matrix unit into a (tile, R) output tile kept resident across the
// consecutive blocks of that tile. Here there is no one-hot product: in f32
// on tensor cores it would run in TF32 and lose f32 parity, and it is pure
// scatter overhead. Instead one CUDA block owns each run of consecutive
// kernel blocks of one tile (see ec_common.cuh) and keeps the (tile, R)
// accumulator in shared memory. For each kernel block in its run, in order:
//   1. all threads form the products E = val ⊙ rows_0 ⊙ rows_1 ... in shared
//      memory from the (nnz, R) rows gathered before the kernel, and stage
//      the block's row_in_tile;
//   2. for each column r, one thread adds E[p, r] into acc[row_in_tile[p], r]
//      for p in slot order.
// At the end of the run the accumulator is stored into the tile once.
// A hot tile's run is walked by one CUDA block; splitting it as ec_sorted
// and ec_fused do is queued work.
#include "ec_common.cuh"

// E[p*R + r] = ((val[p] * G_0[slot, r]) * G_1[slot, r]) ... for the block_p
// slots starting at slot0, from rows gathered before the kernel: G_w is
// (nnz, R) in T (f32 or bf16), cast to f32 here.
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

// Shared-memory layout: E (block_p, R) f32 | acc (tile, R) f32 |
// rit (block_p) int32. kernels/_build.py::variant_smem_bytes mirrors it.
template <int NIN, typename T>
__global__ void __launch_bounds__(EC_THREADS) ec_onehot_kernel(
    const float* __restrict__ values, const int* __restrict__ row_in_tile,
    const int* __restrict__ block_to_tile, const int* __restrict__ run_starts,
    EcInputs<T> in, float* __restrict__ out, int nblocks, int block_p,
    int tile, int R) {
  extern __shared__ float smem[];
  float* E = smem;
  float* acc = E + block_p * R;
  int* rit = reinterpret_cast<int*>(acc + tile * R);
  int b0, b1;
  if (!ec_block_run(run_starts, nblocks, &b0, &b1)) return;
  for (int i = threadIdx.x; i < tile * R; i += blockDim.x) acc[i] = 0.0f;
  for (int b = b0; b < b1; ++b) {
    const int64_t slot0 = (int64_t)b * block_p;
    ec_pregathered_products<NIN, T>(E, values, in, slot0, block_p, R);
    for (int p = threadIdx.x; p < block_p; p += blockDim.x)
      rit[p] = row_in_tile[slot0 + p];
    __syncthreads();
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      for (int p = 0; p < block_p; ++p) {
        float* a = acc + rit[p] * R + r;
        *a = __fadd_rn(*a, E[p * R + r]);
      }
    }
    __syncthreads();
  }
  float* o = out + (int64_t)block_to_tile[b0] * tile * R;
  for (int i = threadIdx.x; i < tile * R; i += blockDim.x) o[i] = acc[i];
}

template <int NIN, typename T>
static cudaError_t launch(const float* values, const int* row_in_tile,
                          const int* block_to_tile, const int* run_starts,
                          EcInputs<T> in, float* out, int nblocks,
                          int block_p, int tile, int R, int smem,
                          cudaStream_t stream) {
  return ec_launch(ec_onehot_kernel<NIN, T>, nblocks, EC_THREADS, smem,
                   stream, values, row_in_tile, block_to_tile, run_starts, in,
                   out, nblocks, block_p, tile, R);
}

template <typename T>
static cudaError_t dispatch(int nin, const float* values,
                            const int* row_in_tile, const int* block_to_tile,
                            const int* run_starts, EcInputs<T> in, float* out,
                            int nblocks, int block_p, int tile, int R,
                            int smem, cudaStream_t st) {
  switch (nin) {
    case 1:
      return launch<1, T>(values, row_in_tile, block_to_tile, run_starts, in,
                          out, nblocks, block_p, tile, R, smem, st);
    case 2:
      return launch<2, T>(values, row_in_tile, block_to_tile, run_starts, in,
                          out, nblocks, block_p, tile, R, smem, st);
    case 3:
      return launch<3, T>(values, row_in_tile, block_to_tile, run_starts, in,
                          out, nblocks, block_p, tile, R, smem, st);
    case 4:
      return launch<4, T>(values, row_in_tile, block_to_tile, run_starts, in,
                          out, nblocks, block_p, tile, R, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ec_blocked: g0..g3 are pre-gathered (nnz, R) rows, f32 (bf16 == 0) or
// bf16 (bf16 == 1).
extern "C" int ec_blocked_launch(const float* values, const int* row_in_tile,
                                 const int* block_to_tile,
                                 const int* run_starts, const void* g0,
                                 const void* g1, const void* g2,
                                 const void* g3, float* out, int nin,
                                 int bf16, int nblocks, int block_p, int tile,
                                 int R, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    EcInputs<T> in = {{static_cast<const T*>(g0), static_cast<const T*>(g1),
                       static_cast<const T*>(g2), static_cast<const T*>(g3)}};
    return dispatch<T>(nin, values, row_in_tile, block_to_tile, run_starts,
                       in, out, nblocks, block_p, tile, R, smem, st);
  }
  EcInputs<float> in = {{static_cast<const float*>(g0),
                         static_cast<const float*>(g1),
                         static_cast<const float*>(g2),
                         static_cast<const float*>(g3)}};
  return dispatch<float>(nin, values, row_in_tile, block_to_tile,
                         run_starts, in, out, nblocks, block_p, tile, R, smem,
                         st);
}
