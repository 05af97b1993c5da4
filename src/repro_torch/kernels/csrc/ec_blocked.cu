// ec_blocked for Hopper: tile-accumulator EC over rows gathered before the
// kernel, replacing the TPU kernel `_ec_kernel` / `ec_blocked`
// (src/repro/kernels/mttkrp_pallas.py).
//
// Bound by bytes: per slot a value, a row_in_tile and nin pre-gathered rows
// of R f32 against (nin + 1) * R flops. The rows are read once, in order,
// from device memory (not L2, as the in-kernel gathers of ec_sorted and
// ec_fused mostly are), so 3.35 TB/s is the limit that counts.
//
// On the TPU each block's commit was onehot(row_in_tile)^T @ E on the matrix
// unit into a VMEM-resident (tile, R) tile. Here there is no one-hot product
// (on tensor cores in f32 it would be TF32 and lose parity; it is pure
// scatter overhead). Design: ec_fused's, with one difference. The item
// kernel, its cp.async ring, the per-stage row_in_tile (RowInTileMeta), the
// register run-sum, the (tile, R) shared accumulator and ec_combine are all
// ec_common.cuh's; only the input source differs (PRE = true): operand w of
// slot s is row s of the pre-gathered array g_w, so no index is loaded and a
// ring stage is one contiguous stretch of EC_STAGE_SLOTS rows of each array.
// The sums therefore run in ec_fused's order, bit for bit: slot order on
// runs of at most CHUNK_BLOCKS blocks, per-item partials added in item order
// beyond that.
//
// bf16 rows: the wrapper casts them to f32 before the launch. The f32 image
// of a bf16 is exact, so the bits are those of an in-kernel cast; one ring
// type keeps one kernel body for the three variants, and no preset feeds
// bf16 rows.
#include "ec_common.cuh"

// g0..g3 are the pre-gathered (nnz, R) f32 rows, one per input mode.
extern "C" int ec_blocked_launch(
    const float* values, const int* row_in_tile, const int* block_to_tile,
    const int* item_starts, const int* item_part, const int* split,
    const float* g0, const float* g1, const float* g2, const float* g3,
    float* out, float* partials, int nin, int n_items, int n_split,
    int nblocks, int block_p, int tile, int R, int nbuf, int vec, int smem,
    void* stream) {
  EcItemArgs a = {values, nullptr, block_to_tile, item_starts, item_part,
                  out, partials, n_items, nblocks, block_p, tile, R, nbuf,
                  0};
  return ec_items_and_combine<true>(a, EcInputs{{g0, g1, g2, g3}},
                                    RowInTileMeta{row_in_tile}, nin, vec,
                                    split, n_split, smem,
                                    static_cast<cudaStream_t>(stream));
}
