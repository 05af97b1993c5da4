// Pieces shared by the EC kernels (ec_sorted.cu, ec_fused.cu, ec_blocked.cu).
//
// Arithmetic is written with __fmul_rn / __fadd_rn so that nvcc cannot
// contract a multiply and an add into an FMA: the products and sums must
// round exactly as the plain f32 versions round them.
//
// Work items, the same for all three: one warp per work item
// (kernels/_build.py::tile_chunks), EC_ITEM_WARPS items per CUDA block. An
// item is at most CHUNK_BLOCKS consecutive kernel blocks of one run (the
// blocks of one output tile). A run of at most that many blocks is one item,
// which sums each row in slot order and writes its tile: the same bits as
// the slot-order reference. A longer run is split; each item writes a
// (tile, R) f32 partial (0 where it touched no row), and ec_combine then
// sets out[row] = ((0 + p_0) + p_1) + ... over the run's partials in item
// order. That fixed two-level order is what the plain versions reproduce
// (kernels/ref.py::ec_rows_chunked), so the result is deterministic and does
// not depend on the card. Each item stops after its last slot whose value is
// not 0 (ec_last_nonzero). ec_sorted walks its items with a kernel of its
// own (ec_sorted.cu: lane groups over whole rows, the segment descriptors);
// the one-hot variants share ec_item_kernel below.
//
// Inside an item (ec_item_kernel: ec_fused, ec_blocked) the warp walks its
// slots in stages of EC_STAGE_SLOTS, up to the stage that holds the item's
// last slot whose value is not 0 and no further. Pad slots (value 0) lie at
// the end of a tile's run (core/partition.py::block_device_rows), so only a
// run's last item holds them: its last block's padded tail, and on a shard
// padded to the mesh's longest, whole trailing blocks. The warp finds that
// slot from the values themselves (ec_last_nonzero, read beside stage 0's
// indices) and issues no copy past it. A skipped slot adds 0 * rows = +-0 to
// a row's sum, which changes no finite sum (a -0 sum may end as -0 instead
// of +0), so the bits are those of the plain versions, which sum every slot,
// wherever the factors are finite. Not so where a pad slot's input row holds
// an inf or a NaN: the plain versions carry its 0 * inf = NaN into the pads'
// row, the kernels no longer do. Mid-run zero values are walked as any other
// slot.
//
// A ring of `nbuf` stages in shared memory is filled with cp.async: each
// slot's nin input rows (16 bytes a thread where R % 4 == 0), its value, and
// its row_in_tile (RowInTileMeta). Where the rows come from is fixed at
// compile time: rows of the factor matrices named by input_indices
// (ec_fused; a stage's indices are loaded one step before its rows are
// requested, so no row load waits on its index at use time), or row `slot`
// of the (nnz, R) arrays gathered before the kernel (ec_blocked; a stage is
// then one contiguous stretch of each array). Lanes span the R columns; the
// warp sums each row in slot order in registers, moving a row's running sum
// to the shared (tile, R) accumulator only when the row changes. No tensor
// cores (a one-hot product in TF32 would lose f32 parity and is pure scatter
// overhead) and no TMA (it moves tiles, not scattered rows).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define EC_THREADS 256
#define EC_MAX_NIN 4
// Mirrored in kernels/_build.py (STAGE_SLOTS, ITEM_WARPS, MAX_ITEM_RANK).
#define EC_STAGE_SLOTS 8
#define EC_ITEM_WARPS 4
#define EC_ITEM_THREADS (EC_ITEM_WARPS * 32)
#define EC_MAX_COLS 4  // columns per lane: R <= 128
#define EC_FULL_MASK 0xffffffffu

// Row pointers of the nin input operands, f32: factor matrices (padded_w, R)
// for the in-kernel gather, or pre-gathered (nnz, R) rows for ec_blocked.
struct EcInputs {
  const float* p[EC_MAX_NIN];
};

// ---------------------------------------------------------------- cp.async

__device__ __forceinline__ void ec_cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void ec_cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void ec_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void ec_cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Wait until at most `pending` (nbuf - 1, in [1, 3]) groups are in flight.
__device__ __forceinline__ void ec_cp_async_wait(int pending) {
  switch (pending) {
    case 1:
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      break;
    case 2:
      asm volatile("cp.async.wait_group 2;\n" ::: "memory");
      break;
    default:
      asm volatile("cp.async.wait_group 3;\n" ::: "memory");
      break;
  }
}

// ------------------------------------------------------------- work items

// Everything an item kernel reads, shared by the three variants.
struct EcItemArgs {
  const float* values;         // (nnz,)
  const int* input_indices;    // (nnz, nin); unread for pre-gathered rows
  const int* block_to_tile;    // (nblocks,)
  const int* item_starts;      // (n_items + 1,), see tile_chunks
  const int* item_part;        // (n_items,)
  float* out;                  // (num_rows, R), zeroed by the caller
  float* partials;             // (n_parts, tile, R) scratch
  int n_items, nblocks, block_p, tile, R, nbuf;
  int warp_words;              // shared-memory words per warp
};

__host__ __device__ __forceinline__ int ec_words16(int n) {
  return (n + 3) / 4 * 4;
}

// Per-warp shared-memory region, in 4-byte words, each part 16-byte
// aligned (kernels/_build.py::variant_smem_bytes mirrors it):
//   rows  nbuf * EC_STAGE_SLOTS * nin * R f32   the slots' input rows
//   vals  nbuf * EC_STAGE_SLOTS f32             the slots' values
//   meta  meta_words int32                      the variant's metadata
//   tacc  tile * R f32                          the tile accumulator
__host__ __device__ __forceinline__ int ec_warp_words(int nin, int R,
                                                      int tile, int nbuf,
                                                      int meta_words) {
  return ec_words16(nbuf * EC_STAGE_SLOTS * nin * R) +
         ec_words16(nbuf * EC_STAGE_SLOTS) + ec_words16(meta_words) +
         ec_words16(tile * R);
}

// The highest slot of kernel block `blk` whose value is not 0 (a NaN counts
// as not 0), or -1 where every value is 0; the same on every lane. Each lane
// reads block_p / 32 values, as 16-byte loads where the block's values are
// 16-byte aligned.
__device__ __forceinline__ int ec_last_nonzero(const float* values,
                                               int64_t blk, int block_p,
                                               int lane) {
  const float* v = values + blk * block_p;
  int last = -1;
  if (block_p % 4 == 0 && (reinterpret_cast<uintptr_t>(v) & 15) == 0) {
    for (int p = lane * 4; p < block_p; p += 128) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(v + p));
      if (x.x != 0.0f) last = p;
      if (x.y != 0.0f) last = p + 1;
      if (x.z != 0.0f) last = p + 2;
      if (x.w != 0.0f) last = p + 3;
    }
  } else {
    for (int p = lane; p < block_p; p += 32)
      if (__ldg(v + p) != 0.0f) last = p;
  }
  return __reduce_max_sync(EC_FULL_MASK, last);
}

// The item kernel. `Meta` supplies the variant's part:
//   static int words(int tile, int nbuf): its shared-memory words per warp;
//   void issue(int* m, int u, int blk, int q, int ns, int64_t s0, int lane,
//              int nbuf, int tile): request stage u's metadata (stage u is
//              slots [q, q + ns) of kernel block blk, global slot s0);
//   int row(const int* m, int u, int blk, int q, int j, int nbuf,
//           int tile): the tile row of slot j of stage u (warp-uniform),
//           called for j = 0, 1, ... of every stage in order.
// PRE: operand w of slot s is row s of the pre-gathered F.p[w] (ec_blocked),
// not row input_indices[s, w] of the factor matrix F.p[w].
// VEC is 4 (16-byte copies; R % 4 == 0 and 16-byte aligned rows) or 1.
template <int NIN, int VEC, bool PRE, typename Meta>
__global__ void __launch_bounds__(EC_ITEM_THREADS)
    ec_item_kernel(EcItemArgs a, EcInputs F, Meta meta) {
  extern __shared__ __align__(16) float ec_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * EC_ITEM_WARPS + warp;
  if (item >= a.n_items) return;
  const int b0 = a.item_starts[item];
  if (b0 >= a.nblocks) return;  // past the last item
  const int b1 = a.item_starts[item + 1];
  const int R = a.R, tile = a.tile, nbuf = a.nbuf, block_p = a.block_p;
  Meta m = meta;  // the variant's walk state lives in this warp's registers

  float* rows = ec_smem + (int64_t)warp * a.warp_words;
  float* vals = rows + ec_words16(nbuf * EC_STAGE_SLOTS * NIN * R);
  int* mw = reinterpret_cast<int*>(vals + ec_words16(nbuf * EC_STAGE_SLOTS));
  float* tacc = reinterpret_cast<float*>(mw) +
                ec_words16(Meta::words(tile, nbuf));

  const int spb = (block_p + EC_STAGE_SLOTS - 1) / EC_STAGE_SLOTS;
  // Stages to walk: every stage of the item until the value read below
  // ends the walk at the last slot whose value is not 0.
  int nst = (b1 - b0) * spb;
  const int stage_rows = EC_STAGE_SLOTS * NIN * R;
  const int cpr = R / VEC;  // copies per factor row

  // Lane l < ns * NIN holds index l of the stage: slot l / NIN, operand
  // l % NIN, as input_indices is laid out. Pre-gathered rows need none.
  int idx = 0;
  auto load_idx = [&](int u) {
    if constexpr (!PRE) {
      if (u >= nst) return;
      const int blk = b0 + u / spb, q = (u % spb) * EC_STAGE_SLOTS;
      const int ns = min(EC_STAGE_SLOTS, block_p - q);
      const int64_t s0 = (int64_t)blk * block_p + q;
      if (lane < ns * NIN) idx = __ldg(a.input_indices + s0 * NIN + lane);
    }
  };
  // Request stage u into ring buffer u % nbuf; always commit a group, so
  // the wait below counts stages.
  auto issue = [&](int u) {
    if (u < nst) {
      const int blk = b0 + u / spb, q = (u % spb) * EC_STAGE_SLOTS;
      const int ns = min(EC_STAGE_SLOTS, block_p - q);
      const int64_t s0 = (int64_t)blk * block_p + q;
      float* dst = rows + (u % nbuf) * stage_rows;
      const int ncopy = ns * NIN * cpr;
      for (int base = 0; base < ncopy; base += 32) {
        const int c = base + lane;
        const int jw = c / cpr;  // slot * NIN + operand
        int64_t row;
        if constexpr (PRE)
          row = s0 + jw / NIN;
        else
          row = __shfl_sync(EC_FULL_MASK, idx, jw & 31);
        if (c < ncopy) {
          const int k = (c - jw * cpr) * VEC;
          const int w = jw % NIN;
          const float* f = F.p[0];
#pragma unroll
          for (int o = 1; o < NIN; ++o)
            if (w == o) f = F.p[o];
          const float* src = f + row * R + k;
          if (VEC == 4)
            ec_cp_async16(dst + jw * R + k, src);
          else
            ec_cp_async4(dst + jw * R + k, src);
        }
      }
      if (lane < ns)
        ec_cp_async4(vals + (u % nbuf) * EC_STAGE_SLOTS + lane,
                     a.values + s0 + lane);
      m.issue(mw, u, blk, q, ns, s0, lane, nbuf, tile);
    }
    ec_cp_async_commit();
  };

  // Stage 0's indices and the item's last block's values are in flight
  // together, so finding the end adds no load ahead of the first gather. A
  // last block of pads only (a shard's trailing pad blocks) steps back.
  load_idx(0);
  for (int i = lane; i < tile * R; i += 32) tacc[i] = 0.0f;
  int blk_end = b1 - 1;
  int last = ec_last_nonzero(a.values, blk_end, block_p, lane);
  while (last < 0 && blk_end > b0)
    last = ec_last_nonzero(a.values, --blk_end, block_p, lane);
  nst = last < 0 ? 0 : (blk_end - b0) * spb + last / EC_STAGE_SLOTS + 1;

  for (int u = 0; u < nbuf - 1; ++u) {
    issue(u);
    load_idx(u + 1);
  }

  const int ncol = (R + 31) / 32;
  float acc[EC_MAX_COLS];
  int cur = -1;  // the row whose running sum is in acc
  for (int t = 0; t < nst; ++t) {
    issue(t + nbuf - 1);  // its indices arrived during the last step
    load_idx(t + nbuf);
    ec_cp_async_wait(nbuf - 1);
    __syncwarp();  // every lane's copies of stage t are visible

    const int blk = b0 + t / spb, q = (t % spb) * EC_STAGE_SLOTS;
    const int ns = min(EC_STAGE_SLOTS, block_p - q);
    const float* rb = rows + (t % nbuf) * stage_rows;
    const float* vb = vals + (t % nbuf) * EC_STAGE_SLOTS;
    for (int j = 0; j < ns; ++j) {
      const int row = m.row(mw, t, blk, q, j, nbuf, tile);
      if (row != cur) {
#pragma unroll
        for (int ci = 0; ci < EC_MAX_COLS; ++ci) {
          const int col = lane + 32 * ci;
          if (ci < ncol && col < R) {
            if (cur >= 0) tacc[cur * R + col] = acc[ci];
            acc[ci] = tacc[row * R + col];
          }
        }
        cur = row;
      }
      const float v = vb[j];
#pragma unroll
      for (int ci = 0; ci < EC_MAX_COLS; ++ci) {
        const int col = lane + 32 * ci;
        if (ci < ncol && col < R) {
          float e = v;
#pragma unroll
          for (int w = 0; w < NIN; ++w)
            e = __fmul_rn(e, rb[(j * NIN + w) * R + col]);
          acc[ci] = __fadd_rn(acc[ci], e);
        }
      }
    }
    __syncwarp();  // stage t's buffer may be refilled from the next step
  }
  if (cur >= 0) {
#pragma unroll
    for (int ci = 0; ci < EC_MAX_COLS; ++ci) {
      const int col = lane + 32 * ci;
      if (ci < ncol && col < R) tacc[cur * R + col] = acc[ci];
    }
  }
  __syncwarp();

  const int part = a.item_part[item];
  float* dst = part < 0
                   ? a.out + (int64_t)a.block_to_tile[b0] * tile * R
                   : a.partials + (int64_t)part * tile * R;
  for (int i = lane; i < tile * R; i += 32) dst[i] = tacc[i];
}

// The one-hot variants' metadata (ec_fused, ec_blocked): one ring entry per
// stage, its slots' row_in_tile.
struct RowInTileMeta {
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

// ec_combine: one CUDA block per split run (split is (3, n_split): first
// partial, partial count, tile; -1 past the last). Each element of the
// run's tile is the sum of its partials in item order, from 0.
__global__ void __launch_bounds__(EC_THREADS)
    ec_combine_kernel(const float* __restrict__ partials,
                      const int* __restrict__ split, float* __restrict__ out,
                      int n_split, int tile, int R) {
  const int first = split[blockIdx.x];
  if (first < 0) return;
  const int n = split[n_split + blockIdx.x];
  const int64_t tr = (int64_t)tile * R;
  float* o = out + (int64_t)split[2 * n_split + blockIdx.x] * tr;
  const float* p = partials + (int64_t)first * tr;
  for (int i = threadIdx.x; i < tile * R; i += blockDim.x) {
    float s = 0.0f;
#pragma unroll 16
    for (int k = 0; k < n; ++k) s = __fadd_rn(s, p[k * tr + i]);
    o[i] = s;
  }
}

// Launch `kernel` with `smem` bytes of dynamic shared memory, raising the
// per-kernel limit first where it exceeds the 48 KiB default.
template <typename Kernel, typename... Args>
static cudaError_t ec_launch(Kernel kernel, int grid, int threads, int smem,
                             cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The item kernel for nin in [1, 4] and the copy width, then ec_combine on
// the same stream where the launch has split runs (n_split > 0).
template <int NIN, bool PRE, typename Meta>
static cudaError_t ec_items_nin(EcItemArgs a, EcInputs F, Meta meta, int vec,
                                int smem, cudaStream_t st) {
  const int grid = (a.n_items + EC_ITEM_WARPS - 1) / EC_ITEM_WARPS;
  if (vec == 4)
    return ec_launch(ec_item_kernel<NIN, 4, PRE, Meta>, grid,
                     EC_ITEM_THREADS, smem, st, a, F, meta);
  return ec_launch(ec_item_kernel<NIN, 1, PRE, Meta>, grid, EC_ITEM_THREADS,
                   smem, st, a, F, meta);
}

// Raises (returns an error) unless `smem` is exactly what the Python model
// (variant_smem_bytes) computed for this geometry.
template <bool PRE, typename Meta>
static cudaError_t ec_items_and_combine(EcItemArgs a, EcInputs F, Meta meta,
                                        int nin, int vec, const int* split,
                                        int n_split, int smem,
                                        cudaStream_t st) {
  a.warp_words = ec_warp_words(nin, a.R, a.tile, a.nbuf,
                               Meta::words(a.tile, a.nbuf));
  if (smem != EC_ITEM_WARPS * a.warp_words * 4 || a.nbuf < 2 ||
      a.nbuf > 4 || a.R > 32 * EC_MAX_COLS)
    return cudaErrorInvalidValue;
  cudaError_t e;
  switch (nin) {
    case 1: e = ec_items_nin<1, PRE>(a, F, meta, vec, smem, st); break;
    case 2: e = ec_items_nin<2, PRE>(a, F, meta, vec, smem, st); break;
    case 3: e = ec_items_nin<3, PRE>(a, F, meta, vec, smem, st); break;
    case 4: e = ec_items_nin<4, PRE>(a, F, meta, vec, smem, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || n_split == 0) return e;
  return ec_launch(ec_combine_kernel, n_split, EC_THREADS, 0, st, a.partials,
                   split, a.out, n_split, a.tile, a.R);
}

extern "C" const char* ec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
