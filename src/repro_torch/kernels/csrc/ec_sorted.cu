// ec_sorted for Hopper: segmented-reduction EC on the row-sorted block
// layout, replacing the TPU kernel `_sorted_kernel` / `ec_sorted` of
// src/repro/kernels/mttkrp_sorted.py.
//
// Bound by bytes: per slot a value, nin indices and nin factor rows of R
// f32 against (nin + 1) * R flops. The factors fit in L2 at the smoke's
// size, so the gather's L2 traffic, not device memory, is the working limit.
//
// Design (see ec_common.cuh): runs of blocks of one tile are cut into work
// items of at most CHUNK_BLOCKS blocks, one warp each, so a hot tile is
// spread over many SMs. The warp gathers its slots' factor rows through a
// cp.async ring of `num_buffers` stages, walks each block's row segments
// (seg_starts / seg_rows, delivered through the same ring) and adds a
// segment's products in slot order into a register sum per column, which
// moves to the warp's (tile, R) shared accumulator when the row changes; the
// tile (or the item's partial, for a run longer than CHUNK_BLOCKS blocks) is
// written once per item. ec_combine adds a split run's partials in item
// order. A run of at most CHUNK_BLOCKS blocks keeps the slot order and so the
// reference's bits; a longer run gives up strict slot order for the fixed
// two-level order, the same on every run and card.
#include "ec_common.cuh"

// Segment descriptors of one block: seg_starts row (nseg + 1 words) then
// seg_rows row (nseg words), nseg = tile + 1, one ring entry per block in
// flight (consecutive blocks take consecutive entries).
struct SortedMeta {
  const int* seg_starts;  // (nblocks, nseg + 1)
  const int* seg_rows;    // (nblocks, nseg)
  int nseg;
  // walk state: the block's descriptors, current segment, its end, its row
  const int* d;
  int sg, next, row_now;

  __host__ __device__ static int words(int tile, int nbuf) {
    return nbuf * (2 * tile + 3);
  }
  __device__ __forceinline__ void issue(int* m, int u, int blk, int q, int ns,
                                        int64_t s0, int lane, int nbuf,
                                        int tile) const {
    if (q != 0) return;  // a block's descriptors come with its first stage
    int* dst = m + (blk % nbuf) * (2 * nseg + 1);
    for (int k = lane; k < 2 * nseg + 1; k += 32) {
      const int* src = k <= nseg
                           ? seg_starts + (int64_t)blk * (nseg + 1) + k
                           : seg_rows + (int64_t)blk * nseg + (k - nseg - 1);
      ec_cp_async4(dst + k, src);
    }
  }
  __device__ __forceinline__ int row(const int* m, int u, int blk, int q,
                                      int j, int nbuf, int tile) {
    const int p = q + j;
    if (p == 0) {
      d = m + (blk % nbuf) * (2 * nseg + 1);
      sg = -1;
      next = 0;
    }
    if (p == next) {  // skip empty descriptor slots; d[nseg] == block_p
      do {
        ++sg;
      } while (d[sg + 1] <= p);
      next = d[sg + 1];
      row_now = d[nseg + 1 + sg];
    }
    return row_now;
  }
};

extern "C" int ec_sorted_launch(
    const float* values, const int* seg_starts, const int* seg_rows,
    const int* block_to_tile, const int* item_starts, const int* item_part,
    const int* split, const int* input_indices, const float* f0,
    const float* f1, const float* f2, const float* f3, float* out,
    float* partials, int nin, int n_items, int n_split, int nblocks,
    int block_p, int tile, int R, int nbuf, int vec, int smem,
    void* stream) {
  EcItemArgs a = {values, input_indices, block_to_tile, item_starts,
                  item_part, out, partials, n_items, nblocks, block_p,
                  tile, R, nbuf, 0};
  SortedMeta meta = {seg_starts, seg_rows, tile + 1, nullptr, 0, 0, 0};
  return ec_items_and_combine<false>(a, EcInputs{{f0, f1, f2, f3}}, meta,
                                     nin, vec, split, n_split, smem,
                                     static_cast<cudaStream_t>(stream));
}
