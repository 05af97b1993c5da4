// ec_sorted for Hopper: segmented-reduction EC on the row-sorted block
// layout, replacing the TPU kernel `_sorted_kernel` / `ec_sorted` of
// src/repro/kernels/mttkrp_sorted.py.
//
// One CUDA block per run of consecutive kernel blocks of one output tile
// (see ec_common.cuh). For each kernel block in its run, in order:
//   1. all threads gather the block's factor rows and form the products
//      E = val ⊙ F_0[idx_0] ⊙ F_1[idx_1] ... into shared memory;
//   2. for each column r, one thread walks the block's row segments
//      (seg_starts / seg_rows, at most tile + 1 of them) and, per segment,
//      loads the output row's current partial, adds the segment's products
//      in slot order and stores the row once.
// The output is zeroed by the caller, so a row's first segment starts from
// 0 exactly as the reference's scatter-add does: the result is bitwise that
// of the plain f32 reference on the CPU.
//
// `num_buffers` is validated by the Python wrapper as on the TPU but unused
// here: this first kernel has no cp.async prefetch ring.
#include "ec_common.cuh"

template <int NIN>
__global__ void __launch_bounds__(EC_THREADS) ec_sorted_kernel(
    const float* __restrict__ values, const int* __restrict__ seg_starts,
    const int* __restrict__ seg_rows, const int* __restrict__ block_to_tile,
    const int* __restrict__ run_starts, const int* __restrict__ input_indices,
    EcInputs<float> F, float* __restrict__ out, int nblocks, int block_p,
    int tile, int R, int nseg) {
  extern __shared__ float E[];  // (block_p, R)
  int b0, b1;
  if (!ec_block_run(run_starts, nblocks, &b0, &b1)) return;
  const int64_t tile_row0 = (int64_t)block_to_tile[b0] * tile;
  for (int b = b0; b < b1; ++b) {
    ec_gather_products<NIN>(E, values, input_indices, F, (int64_t)b * block_p,
                            block_p, R);
    __syncthreads();
    const int* ss = seg_starts + (int64_t)b * (nseg + 1);
    const int* sr = seg_rows + (int64_t)b * nseg;
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      for (int s = 0; s < nseg; ++s) {
        const int start = ss[s];
        const int end = ss[s + 1];
        if (end <= start) continue;  // unused descriptor slot
        float* o = out + (tile_row0 + sr[s]) * R + r;
        float acc = *o;
        for (int p = start; p < end; ++p) acc = __fadd_rn(acc, E[p * R + r]);
        *o = acc;
      }
    }
    __syncthreads();
  }
}

template <int NIN>
static cudaError_t launch(const float* values, const int* seg_starts,
                          const int* seg_rows, const int* block_to_tile,
                          const int* run_starts, const int* input_indices,
                          EcInputs<float> F, float* out, int nblocks,
                          int block_p, int tile, int R, int nseg, int smem,
                          cudaStream_t stream) {
  return ec_launch(ec_sorted_kernel<NIN>, nblocks, smem, stream, values,
                   seg_starts, seg_rows, block_to_tile, run_starts,
                   input_indices, F, out, nblocks, block_p, tile, R, nseg);
}

extern "C" int ec_sorted_launch(
    const float* values, const int* seg_starts, const int* seg_rows,
    const int* block_to_tile, const int* run_starts, const int* input_indices,
    const float* f0, const float* f1, const float* f2, const float* f3,
    float* out, int nin, int nblocks, int block_p, int tile, int R, int nseg,
    int smem, void* stream) {
  EcInputs<float> F = {{f0, f1, f2, f3}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nin) {
    case 1:
      return launch<1>(values, seg_starts, seg_rows, block_to_tile, run_starts,
                       input_indices, F, out, nblocks, block_p, tile, R, nseg,
                       smem, st);
    case 2:
      return launch<2>(values, seg_starts, seg_rows, block_to_tile, run_starts,
                       input_indices, F, out, nblocks, block_p, tile, R, nseg,
                       smem, st);
    case 3:
      return launch<3>(values, seg_starts, seg_rows, block_to_tile, run_starts,
                       input_indices, F, out, nblocks, block_p, tile, R, nseg,
                       smem, st);
    case 4:
      return launch<4>(values, seg_starts, seg_rows, block_to_tile, run_starts,
                       input_indices, F, out, nblocks, block_p, tile, R, nseg,
                       smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}
