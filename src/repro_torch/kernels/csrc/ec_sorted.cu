// ec_sorted for Hopper: segmented-reduction EC on the row-sorted block
// layout, replacing the TPU kernel `_sorted_kernel` / `ec_sorted` of
// src/repro/kernels/mttkrp_sorted.py.
//
// What bounds it: per slot a value, nin indices and nin factor rows of R f32
// against (nin + 1) * R flops, so bytes in principle. A one-column-a-lane
// walk that stages its rows through shared memory spends ~100 warp
// instructions a slot on addresses, divisions, descriptor walks and
// predicated-off columns, and is then bound by instruction issue instead
// (PERF.md §6). This kernel spends a few a slot.
//
// Work items (kernels/_build.py::tile_chunks) as for every EC kernel: a run
// of blocks of one output tile is cut into items of at most CHUNK_BLOCKS
// blocks, one warp each, EC_ITEM_WARPS a CUDA block. An item writes its tile
// (a run of at most CHUNK_BLOCKS blocks: the bits of the slot-order
// reference) or, for a longer run, a (tile, R) partial that ec_combine adds
// in item order: the fixed two-level order of ref.ec_rows_chunked.
//
// The walk. An item's slots are one stretch of memory, its blocks'; the warp
// walks them up to its last slot whose value is not 0 (ec_last_nonzero on
// the last block, stepping back over blocks of pads only) and no further, in
// steps of G slots. The warp is cut into G lane groups of L lanes: with R %
// 4 == 0 and 16-byte rows a lane holds 4 columns (L = R / 4: 8 lanes and 4
// slots a step at R = 32, 2 slots at R = 64, 1 at R = 128), else one column
// (L = min(R, 32); above R = 32 a lane holds up to 4 columns 32 apart).
// The item's values and indices are read 32 slots at a time, a slot a
// lane, with coalesced streaming loads, a chunk ahead of use; group g takes
// slot g of the step's value and nin indices from them by shuffles, then
// its nin factor rows, whole, as read-only vector loads that L1 caches (a
// hot row, such as the year rows of a 46-row mode or a Zipf head's index 0,
// is served from L1). The rows are requested `nbuf` - 1 steps ahead into
// registers; no depth changes a bit. At R = 32 with 16-byte rows (the
// paper's rank) the kernel is compiled for that rank, so the groups, the
// step and every offset are constants.
//
// The sum. Each group forms e = ((v * r_0) * r_1) ... (__fmul_rn) and puts it
// in a per-warp staging row of shared memory; after a __syncwarp every lane
// holds the columns lane + 32 * k and adds the step's products into its
// running sum in slot order (__fadd_rn). The running sum belongs to one row:
// the block's segment descriptors (seg_starts / seg_rows, copied to shared
// memory a block ahead with cp.async) name each segment's row, and the warp
// compares each slot's position with the next segment start in a register,
// reading the descriptors only where a segment begins. Where the row
// changes the sum moves to the warp's (tile, R) accumulator in shared
// memory and the new row's sum is read from it, so a row that recurs in a
// later block of the item (a tile's rows recur in each block of its run)
// goes on from where it stopped: every row is ((+0 + e_s0) + e_s1) + ...
// over its slots in slot order. The accumulator is written once per item.
// Pad slots past the last nonzero add 0 * rows = +-0 in the plain version,
// which changes no finite sum; a non-finite row 0 of a factor reaches the
// pads' row through 0 * inf there and not here, a known divergence.
#include "ec_common.cuh"

// Floats of one step's staging row: G * R <= 128 for every lane layout.
// Mirrored in kernels/_build.py (STEP_FLOATS).
#define EC_STEP_FLOATS 128

// A step's loads of one lane: its slot's value and its chunk of each of the
// slot's nin factor rows (4 columns, or up to 4 single columns L apart).
template <int NIN>
struct EcStep {
  float v;
  float4 r[NIN];
};

// The lane's chunk of factor row `idx`, f being the factor offset to the
// lane's first column: 4 columns (VEC 4), or the columns 0, L, 2L, 3L from
// there below R (VEC 1).
template <int VEC>
__device__ __forceinline__ float4 ec_row_chunk(const float* f, int idx, int R,
                                               int c, int L) {
  const float* r = f + (int64_t)idx * R;
  if constexpr (VEC == 4) {
    return __ldg(reinterpret_cast<const float4*>(r));
  } else {
    float4 x = make_float4(__ldg(r), 0.0f, 0.0f, 0.0f);
    if (c + L < R) x.y = __ldg(r + L);
    if (c + 2 * L < R) x.z = __ldg(r + 2 * L);
    if (c + 3 * L < R) x.w = __ldg(r + 3 * L);
    return x;
  }
}

// One warp per work item. NBUF is the load pipeline's depth in steps; VEC
// the columns of a row a lane loads together (4: 16-byte rows); RT the rank
// where it is fixed at compile time (32, with VEC 4: the lane groups, the
// step and every staging offset are constants), else 0.
template <int NIN, int NBUF, int RT, int VEC>
__global__ void __launch_bounds__(EC_ITEM_THREADS)
    ec_sorted_kernel(EcItemArgs a, EcInputs F, const int* seg_starts,
                     const int* seg_rows) {
  // columns a lane sums: lane + 32 * k, k < NC, the last ones masked
  constexpr int NC = RT ? (RT + 31) / 32 : EC_MAX_COLS;
  // slots a step where RT fixes them, else 0
  constexpr int GT = RT ? 32 / (VEC == 4 ? RT / 4 : (RT < 32 ? RT : 32)) : 0;
  extern __shared__ __align__(16) float ec_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * EC_ITEM_WARPS + warp;
  if (item >= a.n_items) return;
  const int b0 = a.item_starts[item];
  if (b0 >= a.nblocks) return;  // past the last item
  const int b1 = a.item_starts[item + 1];
  const int part = a.item_part[item];
  const int out_tile = a.block_to_tile[b0];
  const int R = RT ? RT : a.R, tile = a.tile, block_p = a.block_p;
  const int nseg = tile + 1, dw = 2 * nseg + 1;

  float* tacc = ec_smem + (int64_t)warp * a.warp_words;
  float* stage = tacc + ec_words16(tile * R);
  int* desc = reinterpret_cast<int*>(stage + 2 * EC_STEP_FLOATS);

  // Block b0 + bi's descriptors into ring entry bi % 2: seg_starts' row,
  // then seg_rows'.
  auto fetch_desc = [&](int bi) {
    const int64_t blk = b0 + bi;
    int* dst = desc + (bi & 1) * dw;
    for (int k = lane; k < dw; k += 32)
      ec_cp_async4(dst + k, k <= nseg
                                ? seg_starts + blk * (nseg + 1) + k
                                : seg_rows + blk * nseg + (k - nseg - 1));
    ec_cp_async_commit();
  };

  // The lane's group and its place in it.
  const int L = VEC == 4 ? R / 4 : min(R, 32);
  const int G = 32 / L;
  const int g = lane / L, c = lane - g * L;
  const bool gathers = g < G;
  const float* fc[NIN];  // each factor, offset to the lane's first column
#pragma unroll
  for (int w = 0; w < NIN; ++w) fc[w] = F.p[w] + VEC * c;
  const int soff = g * R + VEC * c;  // the lane's first column, staged
  const int64_t s0 = (int64_t)b0 * block_p;  // the item's first slot

  // The item's values and indices come 32 slots at a time, one slot a
  // lane, coalesced: the chunk `ca` and the next one live in registers (A,
  // B) and a step's groups take their slots' words from them by shuffles,
  // so the indices are loaded a chunk ahead of the rows they name.
  int nslots = (b1 - b0) * block_p;  // bound for the first chunks' loads
  float va = 0.0f, vb = 0.0f;
  int ia[NIN], ib[NIN];
  auto load_chunk = [&](float& v, int (&ix)[NIN], int ck) {
    const int j = 32 * ck + lane;
    if (j >= nslots) return;
    v = __ldcs(a.values + s0 + j);  // read once: evict first
    const int* ip = a.input_indices + (s0 + j) * NIN;
#pragma unroll
    for (int w = 0; w < NIN; ++w) ix[w] = __ldcs(ip + w);
  };
  int ca = 0;
  auto issue = [&](EcStep<NIN>& b, int u) {
    const int j0 = u * G;  // the step's first slot, the same on every lane
    if (j0 >= nslots) return;
    if ((j0 >> 5) > ca) {  // the step enters chunk B: B becomes A
      va = vb;
#pragma unroll
      for (int w = 0; w < NIN; ++w) ia[w] = ib[w];
      ++ca;
      load_chunk(vb, ib, ca + 1);
    }
    const int j = j0 + g, src = j & 31;
    float v = __shfl_sync(EC_FULL_MASK, va, src);
    int idx[NIN];
#pragma unroll
    for (int w = 0; w < NIN; ++w) idx[w] = __shfl_sync(EC_FULL_MASK, ia[w], src);
    if (32 % G != 0 && ((j0 + G - 1) >> 5) > ca) {  // it ends in chunk B
      const float v2 = __shfl_sync(EC_FULL_MASK, vb, src);
      const bool in_b = (j >> 5) > ca;
      if (in_b) v = v2;
#pragma unroll
      for (int w = 0; w < NIN; ++w) {
        const int x = __shfl_sync(EC_FULL_MASK, ib[w], src);
        if (in_b) idx[w] = x;
      }
    }
    if (!gathers || j >= nslots) return;
    b.v = v;
#pragma unroll
    for (int w = 0; w < NIN; ++w)
      b.r[w] = ec_row_chunk<VEC>(fc[w], idx[w], R, c, L);
  };

  // Block b0's descriptors and the first two chunks are in flight beside
  // the last block's values, so finding the end adds no load ahead of the
  // first gather. A last block of pads only steps back.
  fetch_desc(0);
  load_chunk(va, ia, 0);
  load_chunk(vb, ib, 1);
  if ((tile * R) % 4 == 0) {
    for (int i = lane * 4; i < tile * R; i += 128)
      *reinterpret_cast<float4*>(tacc + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = lane; i < tile * R; i += 32) tacc[i] = 0.0f;
  }
  int nbl = b1 - 1 - b0;  // the walk's last block, from b0
  int last = ec_last_nonzero(a.values, b0 + nbl, block_p, lane);
  while (last < 0 && nbl > 0)
    last = ec_last_nonzero(a.values, b0 + --nbl, block_p, lane);
  nslots = last < 0 ? 0 : nbl * block_p + last + 1;
  const int nst = (nslots + G - 1) / G;

  EcStep<NIN> buf[NBUF];
#pragma unroll
  for (int u = 0; u < NBUF - 1; ++u) issue(buf[u], u);

  // The sum's walk state, the same on every lane: the block (from b0) and
  // the slot's position in it, its descriptors, the next segment's start,
  // the current segment and its row, whose running sum is in acc.
  ec_cp_async_wait_all();
  __syncwarp();  // block b0's descriptors and the zeroed tacc are visible
  if (nbl > 0) fetch_desc(1);
  int bi = 0, p = 0, sg = 0;
  const int* d = desc;
  int next = d[1], row = d[nseg + 1];
  float acc[NC];
  bool cok[NC];
#pragma unroll
  for (int ci = 0; ci < NC; ++ci) {
    acc[ci] = 0.0f;
    cok[ci] = lane + 32 * ci < R;
  }

  // e: the lane's first column of a slot's products in the staging row
  auto add_slot = [&](const float* e) {
#pragma unroll
    for (int ci = 0; ci < NC; ++ci)
      if (cok[ci]) acc[ci] = __fadd_rn(acc[ci], e[32 * ci]);
  };
  auto consume = [&](const EcStep<NIN>& b, int t) {
    float* st = stage + (t & 1) * EC_STEP_FLOATS;
    if (gathers && t * G + g < nslots) {
      float4 e = make_float4(b.v, b.v, b.v, b.v);
#pragma unroll
      for (int w = 0; w < NIN; ++w) {
        e.x = __fmul_rn(e.x, b.r[w].x);
        e.y = __fmul_rn(e.y, b.r[w].y);
        e.z = __fmul_rn(e.z, b.r[w].z);
        e.w = __fmul_rn(e.w, b.r[w].w);
      }
      float* sr = st + soff;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(sr) = e;
      } else {
        sr[0] = e.x;
        if (c + L < R) sr[L] = e.y;
        if (c + 2 * L < R) sr[2 * L] = e.z;
        if (c + 3 * L < R) sr[3 * L] = e.w;
      }
    }
    __syncwarp();  // the step's products are visible to every lane
    const int kn = min(G, nslots - t * G);
    const float* e = st + lane;
    if (p + kn <= next) {  // no segment starts inside the step
      if constexpr (GT > 0) {
        if (kn == GT) {
#pragma unroll
          for (int k = 0; k < GT; ++k) add_slot(e + k * R);
          p += GT;
          return;
        }
      }
      for (int k = 0; k < kn; ++k, e += R) add_slot(e);
      p += kn;
      return;
    }
    for (int k = 0; k < kn; ++k, ++p, e += R) {
      if (p == next) {
        if (p == block_p) {  // the item's next block
          ++bi;
          p = sg = 0;
          ec_cp_async_wait_all();
          __syncwarp();
          d = desc + (bi & 1) * dw;
          if (bi < nbl) fetch_desc(bi + 1);
        } else {
          ++sg;
        }
        next = d[sg + 1];  // segments are never empty; d[nseg] == block_p
        const int nr = d[nseg + 1 + sg];
        if (nr != row) {
#pragma unroll
          for (int ci = 0; ci < NC; ++ci) {
            if (cok[ci]) {
              tacc[row * R + lane + 32 * ci] = acc[ci];
              acc[ci] = tacc[nr * R + lane + 32 * ci];
            }
          }
          row = nr;
        }
      }
      add_slot(e);
    }
  };

  // Step t's rows were requested NBUF - 1 steps earlier, into
  // buf[t % NBUF];
  // the loop is unrolled NBUF times so that every index is a constant.
  for (int t0 = 0; t0 < nst; t0 += NBUF) {
#pragma unroll
    for (int j = 0; j < NBUF; ++j) {
      const int t = t0 + j;
      if (t >= nst) break;
      issue(buf[(j + NBUF - 1) % NBUF], t + NBUF - 1);
      consume(buf[j], t);
    }
  }
  if (nslots > 0) {
#pragma unroll
    for (int ci = 0; ci < NC; ++ci)
      if (cok[ci]) tacc[row * R + lane + 32 * ci] = acc[ci];
  }
  ec_cp_async_wait_all();  // no descriptor copy outlives the item
  __syncwarp();

  float* dst = part < 0 ? a.out + (int64_t)out_tile * tile * R
                        : a.partials + (int64_t)part * tile * R;
  if ((tile * R) % 4 == 0) {
    for (int i = lane * 4; i < tile * R; i += 128)
      *reinterpret_cast<float4*>(dst + i) =
          *reinterpret_cast<const float4*>(tacc + i);
  } else {
    for (int i = lane; i < tile * R; i += 32) dst[i] = tacc[i];
  }
}

// Per-warp shared memory, in 4-byte words, each part 16-byte aligned
// (kernels/_build.py::variant_smem_bytes mirrors it): the (tile, R) tile
// accumulator, two staging rows of EC_STEP_FLOATS, and a ring of two
// blocks' descriptors of 2 * (tile + 1) + 1 words each.
static int ec_sorted_warp_words(int tile, int R) {
  return ec_words16(tile * R) + 2 * EC_STEP_FLOATS +
         ec_words16(2 * (2 * (tile + 1) + 1));
}

template <int NIN, int NBUF>
static cudaError_t ec_sorted_nin_nbuf(EcItemArgs a, EcInputs F,
                                      const int* seg_starts,
                                      const int* seg_rows, int vec, int smem,
                                      cudaStream_t st) {
  const int grid = (a.n_items + EC_ITEM_WARPS - 1) / EC_ITEM_WARPS;
  if (vec != 4)
    return ec_launch(ec_sorted_kernel<NIN, NBUF, 0, 1>, grid,
                     EC_ITEM_THREADS, smem, st, a, F, seg_starts, seg_rows);
  if (a.R == 32)
    return ec_launch(ec_sorted_kernel<NIN, NBUF, 32, 4>, grid,
                     EC_ITEM_THREADS, smem, st, a, F, seg_starts, seg_rows);
  return ec_launch(ec_sorted_kernel<NIN, NBUF, 0, 4>, grid, EC_ITEM_THREADS,
                   smem, st, a, F, seg_starts, seg_rows);
}

template <int NIN>
static cudaError_t ec_sorted_nin(EcItemArgs a, EcInputs F,
                                 const int* seg_starts, const int* seg_rows,
                                 int vec, int smem, cudaStream_t st) {
  switch (a.nbuf) {
    case 2:
      return ec_sorted_nin_nbuf<NIN, 2>(a, F, seg_starts, seg_rows, vec,
                                        smem, st);
    case 3:
      return ec_sorted_nin_nbuf<NIN, 3>(a, F, seg_starts, seg_rows, vec,
                                        smem, st);
    default:
      return ec_sorted_nin_nbuf<NIN, 4>(a, F, seg_starts, seg_rows, vec,
                                        smem, st);
  }
}

// Raises (returns an error) unless `smem` is exactly what the Python model
// (variant_smem_bytes) computed for this geometry; then ec_combine on the
// same stream where the launch has split runs (n_split > 0).
extern "C" int ec_sorted_launch(
    const float* values, const int* seg_starts, const int* seg_rows,
    const int* block_to_tile, const int* item_starts, const int* item_part,
    const int* split, const int* input_indices, const float* f0,
    const float* f1, const float* f2, const float* f3, float* out,
    float* partials, int nin, int n_items, int n_split, int nblocks,
    int block_p, int tile, int R, int nbuf, int vec, int smem,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  EcItemArgs a = {values, input_indices, block_to_tile, item_starts,
                  item_part, out, partials, n_items, nblocks, block_p,
                  tile, R, nbuf, ec_sorted_warp_words(tile, R)};
  if (smem != EC_ITEM_WARPS * a.warp_words * 4 || nbuf < 2 || nbuf > 4 ||
      R < 1 || R > 32 * EC_MAX_COLS || (vec != 1 && vec != 4) ||
      (vec == 4 && R % 4 != 0))
    return cudaErrorInvalidValue;
  const EcInputs F{{f0, f1, f2, f3}};
  cudaError_t e;
  switch (nin) {
    case 1: e = ec_sorted_nin<1>(a, F, seg_starts, seg_rows, vec, smem, st); break;
    case 2: e = ec_sorted_nin<2>(a, F, seg_starts, seg_rows, vec, smem, st); break;
    case 3: e = ec_sorted_nin<3>(a, F, seg_starts, seg_rows, vec, smem, st); break;
    case 4: e = ec_sorted_nin<4>(a, F, seg_starts, seg_rows, vec, smem, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || n_split == 0) return e;
  return ec_launch(ec_combine_kernel, n_split, EC_THREADS, 0, st, a.partials,
                   split, a.out, n_split, a.tile, a.R);
}
