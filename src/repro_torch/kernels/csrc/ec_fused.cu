// ec_fused for Hopper: tile-accumulator EC with the factor gather in the
// kernel, replacing the TPU kernel `_fused_kernel` / `ec_fused` of
// src/repro/kernels/mttkrp_fused.py.
//
// Bound by bytes: per slot a value, nin indices, a row index and nin factor
// rows of R f32 against (nin + 1) * R flops; at the smoke's size the factors
// fit in L2, so the gather's L2 traffic is the working limit.
//
// On the TPU each block's commit was onehot(row_in_tile)^T @ E on the matrix
// unit into a VMEM-resident (tile, R) tile. Here there is no one-hot product
// (on tensor cores in f32 it would be TF32 and lose parity; it is pure
// scatter overhead). Design (see ec_common.cuh): runs of blocks of one tile
// are cut into work items of at most CHUNK_BLOCKS blocks, one warp each. The
// warp gathers its slots' factor rows, values and row_in_tile through a
// cp.async ring of `num_buffers` stages and adds each slot's products into
// its row in slot order: a register sum per column while consecutive slots
// share a row, the warp's (tile, R) shared accumulator between rows. The
// tile (or the item's partial, for a run longer than CHUNK_BLOCKS blocks) is
// written once per item; ec_combine adds a split run's partials in item
// order. A run of at most CHUNK_BLOCKS blocks keeps slot order; a longer run
// gives up strict slot order for the fixed two-level order, the same on
// every run and card.
#include "ec_common.cuh"

// One ring entry per stage: its slots' row_in_tile.
struct FusedMeta {
  const int* row_in_tile;  // (nnz,)

  __host__ __device__ static int words(int tile, int nbuf) {
    return nbuf * EC_STAGE_SLOTS;
  }
  __device__ __forceinline__ void issue(int* m, int u, int blk, int q, int ns,
                                        int64_t s0, int lane, int nbuf,
                                        int tile) const {
    if (lane < ns)
      ec_cp_async4(m + (u % nbuf) * EC_STAGE_SLOTS + lane,
                   row_in_tile + s0 + lane);
  }
  __device__ __forceinline__ int row(const int* m, int u, int blk, int q,
                                      int j, int nbuf, int tile) const {
    return m[(u % nbuf) * EC_STAGE_SLOTS + j];
  }
};

extern "C" int ec_fused_launch(
    const float* values, const int* row_in_tile, const int* block_to_tile,
    const int* item_starts, const int* item_part, const int* split,
    const int* input_indices, const float* f0, const float* f1,
    const float* f2, const float* f3, float* out, float* partials, int nin,
    int n_items, int n_split, int nblocks, int block_p, int tile, int R,
    int nbuf, int vec, int smem, void* stream) {
  EcItemArgs a = {values, input_indices, block_to_tile, item_starts,
                  item_part, out, partials, n_items, nblocks, block_p,
                  tile, R, nbuf, 0};
  return ec_items_and_combine(a, EcInputs<float>{{f0, f1, f2, f3}},
                              FusedMeta{row_in_tile}, nin, vec, split,
                              n_split, smem,
                              static_cast<cudaStream_t>(stream));
}
