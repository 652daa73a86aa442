// K1: Y (n, d) = A · X for a CSR matrix A and a row-major X, fp32 sums.
//
// Replaces the TPU kernel ndcn_tpu/kernels/coo_spmv.py::_make_kernel
// (seg_kernel). That kernel reduced row-sorted COO slices into resident row
// tiles with a one-hot MXU matmul, in bf16 splits and a feature-major (d, n)
// layout: all of that answered the TPU's slow scatter and its (8, 128) lane
// padding. On Hopper the same product is a plain gather-scale-reduce.
//
// Bound: bytes. One call must move nnz · 8 bytes of column indices and
// values, the row pointer, X once and Y once: 50 MB at the 200k-node /
// 2.2M-edge operator and d = 20, 15 µs at 3.35 TB/s (X, 16 MB, sits in the
// 50 MB L2). What a kernel pays above that is latency: each gathered row
// is a dependent load behind its column index, so the time goes with the
// number of independent loads in flight and the bytes each lane asks for.
//
// Design (the gather itself is spmv_gather.cuh, shared with K1-fm):
// - One warp per row. A row of X is read with the widest load that divides
//   its bytes (16 bytes a lane at d = 20 fp32: 5 lanes a row), and the
//   other lanes of the warp carry further edges (6 in flight at d = 20,
//   where a lane-per-feature layout had one, on 4-byte loads). At d = 1 a
//   warp walks 4 rows at once. Lane sums are fp32 FMAs in registers; the
//   groups fold by shuffles in a fixed order and group 0 stores the row
//   with vector stores.
// - Rows longer than the split limit (hub rows of power-law graphs) are
//   skipped here and written as zeros; two further launches on the same
//   stream sum their chunks, one warp a chunk, into a scratch and fold them
//   in chunk order into Y. An operator without long rows is one launch.
// - No (nnz, d) intermediate touches device memory, and no atomics are
//   used: the order of every sum is fixed by (operator, d), so results
//   repeat bit for bit from run to run, which the adaptive step controller
//   needs for repeatable NFE.
// - The bf16 instance (the JAX package's GATHER_BF16 mode) gathers a bf16
//   copy of X and rounds each value of A to bf16 as it reads it, as the TPU
//   kernel folds vals into its bf16 one-hot; the product of two bf16 values
//   is exact in fp32, and the sums stay fp32.
// - Replicas (the batched entries): R states (R, n, d) against the one
//   shared A, in one launch per pass. gridDim.y is the replica; each CTA
//   offsets X, Y and the long rows' scratch by its replica's stride and
//   does exactly the work of a one-replica launch on that slice, so a
//   replica's result is bit-equal to its own launch's. A and its chunk
//   index are read by every replica (from L2 after the first). X's stride
//   is its own row count times d: on a rank's row block of the mesh path
//   X holds every node's rows (the gathered table) and Y the block's.
//
// The wide form (csr_wide_kernel), for rows wider than one warp's 32-lane
// segment (d / E > 32: the raw features of the citation graphs, d = 1433
// and 3703, take 4-byte loads, so 45 and 116 segments a row). In the form
// above one warp walks such a row's segments one after another, and every
// segment walks all the row's edges again: one dependent chain as long as
// segments x edges, and the whole cora call (2,708 rows) is 2,708 warps, a
// fraction of what the card holds. Here:
// - The grid is over (row, column tile): a warp takes one tile of one row,
//   32 · C row lanes (C = 1, 2 or 4: a lane takes C of them, 32 apart),
//   the warps of a row side by side, so a wide row is as many warps as it
//   has tiles, all in flight at once (gridDim.y the replica, as above).
//   The host's plan (kernels/coo_spmv.py::gather_plan) picks the form, C
//   and the grid; the entry checks them.
// - A warp reads its row's column indices and values once, 32 edges a
//   load, coalesced, and hands them out by shuffle; a lane issues the
//   gathers of K edges (C coalesced loads each, K · C loads of 32 words in
//   all) before their FMAs. A warp's time is a short chain of dependent
//   loads (row pointer, indices, gathers) and, on a long row, its edges
//   over K: larger C cuts the waves of warps, larger K a long row's chain
//   (and costs every short row its unrolled turns: K = 8 won).
// - The rows of more than HEAVY_EDGES edges (the operator's list, built with
//   its chunk index) get the grid's first warps, so that their longer
//   chains run beside the short rows' rather than after the last wave.
// - Every output value is fp32 fmaf over the row's edges in CSR order from
//   0, the order the form above takes when a row has one group (every
//   width past 32 lanes), so the two forms give the same bits.
// - Rows past the split limit are zeros here; the chunk pass of the same
//   kernel (each chunk a row of the scratch, the same tiles) sums their
//   chunks, and fold_chunks_kernel adds them in chunk order, as above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "spmv_gather.cuh"

namespace {

using ndcn::kGatherThreads;

template <typename T, int E>
__global__ void __launch_bounds__(kGatherThreads, ndcn::kGatherBlocksPerSm)
csr_rows_kernel(const int32_t* __restrict__ row_ptr,
                const int32_t* __restrict__ cols,
                const float* __restrict__ vals, const T* __restrict__ x,
                float* __restrict__ y, int n_rows, int d, int split_limit,
                ndcn::LaneShape shape, int64_t x_bs, int64_t y_bs) {
  x += blockIdx.y * x_bs;  // this CTA's replica
  y += blockIdx.y * y_bs;
  const int64_t first = (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5)
                        * shape.rows;
  if (first >= n_rows) return;  // uniform across the warp
  const ndcn::WarpLanes w(shape, threadIdx.x & 31);
  const int64_t row = first + w.row;
  const bool valid = row < n_rows;
  const int start = valid ? row_ptr[row] : 0;
  int end = valid ? row_ptr[row + 1] : 0;
  if (end - start > split_limit) {
    end = start;  // a split row: zeros here, its sum from the fold
  }
  for (int seg = 0; seg < w.segments; ++seg) {
    const int j = valid ? w.row_lane(seg) : -1;
    float acc[E];
    ndcn::warp_gather<T, E>(cols, vals, x, d, start, end, w, j, acc);
    if (w.group == 0 && j >= 0) {
      ndcn::store_values<E>(y + row * d + j * E, acc);
    }
  }
}

// 3 blocks of 256 threads an SM, 85 registers a thread: a lane holds
// kWideWords 4-byte words of loads in flight
constexpr int kWideBlocksPerSm = 3;
constexpr int kWideWords = 32;

// Warp (slot, tile) of the wide form: row lanes j = tile · 32 · C + lane +
// 32 · c (c < C) of one row (a CSR row, or with CHUNKS a chunk of a long
// row: `bounds` is then the (n, 2) chunk_bounds and y the scratch), into
// y[row · d + j · E]. The first n_heavy slots are the heavy rows (more than
// heavy_edges edges), the rest every row in order, the heavy ones skipped
// there. A lane issues the loads of K edges (C each) before their FMAs:
// K · C loads of E · sizeof(T) bytes are kWideWords words.
template <typename T, int E, int C, bool CHUNKS>
__global__ void __launch_bounds__(kGatherThreads, kWideBlocksPerSm)
csr_wide_kernel(const int32_t* __restrict__ bounds,
                const int32_t* __restrict__ cols,
                const float* __restrict__ vals, const T* __restrict__ x,
                float* __restrict__ y, int64_t n_slots,
                const int32_t* __restrict__ heavy, int n_heavy,
                int heavy_edges, int d, int row_lanes, int tiles,
                int split_limit, int64_t x_bs, int64_t y_bs) {
  using Word = typename ndcn::LoadWord<E * sizeof(T)>::type;
  constexpr int kWords = E * sizeof(T) < 4 ? 1 : E * sizeof(T) / 4;
  constexpr int K = kWideWords / (C * kWords);
  x += blockIdx.y * x_bs;  // this CTA's replica
  y += blockIdx.y * y_bs;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (warp >= n_slots * tiles) return;  // uniform across the warp
  const int64_t slot = warp / tiles;
  const int64_t item = slot < n_heavy ? heavy[slot] : slot - n_heavy;
  const int lane = threadIdx.x & 31;
  const int j0 = (int)(warp - slot * tiles) * 32 * C + lane;
  int start, end;
  if (CHUNKS) {
    start = bounds[2 * item];
    end = bounds[2 * item + 1];
  } else {
    start = bounds[item];
    end = bounds[item + 1];
    if (end - start > split_limit) end = start;  // summed by the chunk pass
    // a heavy row's own slot came first (uniform across the warp)
    if (slot >= n_heavy && n_heavy > 0 && end - start > heavy_edges) return;
  }
  float acc[C][E];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int k = 0; k < E; ++k) acc[c][k] = 0.0f;
  }
  for (int base = start; base < end; base += 32) {
    const int n = min(32, end - base);
    const int my_col = lane < n ? __ldg(cols + base + lane) : 0;
    const float my_val = lane < n ? ndcn::edge_val<T>(vals + base + lane)
                                  : 0.0f;
#pragma unroll 1
    for (int k0 = 0; k0 < n; k0 += K) {
      Word words[K][C];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T* row = x + (int64_t)__shfl_sync(0xffffffffu, my_col, k0 + k)
                               * d;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = j0 + 32 * c;
          words[k][c] = k0 + k < n && j < row_lanes
                            ? __ldg(reinterpret_cast<const Word*>(row + j * E))
                            : Word{};
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float a = __shfl_sync(0xffffffffu, my_val, k0 + k);
        if (k0 + k < n) {  // in order: no fma for an edge past the row
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const T* v = reinterpret_cast<const T*>(&words[k][c]);
#pragma unroll
            for (int i = 0; i < E; ++i) {
              acc[c][i] = fmaf(a, ndcn::to_float(v[i]), acc[c][i]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + 32 * c;
    if (j < row_lanes) ndcn::store_values<E>(y + item * d + j * E, acc[c]);
  }
}

// Warps of 32 lanes over `items` rows of `tiles` tiles, 8 a block.
inline int64_t wide_blocks(int64_t items, int tiles) {
  return (items * tiles + kGatherThreads / 32 - 1) / (kGatherThreads / 32);
}

// The wide form's two passes and the fold (the chunk index's), on `stream`.
template <typename T, int E, int C>
void launch_wide(const int32_t* row_ptr, const int32_t* cols,
                 const float* vals, const T* x, float* y, int n_rows, int d,
                 const ndcn::RowSplit& split, const int32_t* heavy,
                 int n_heavy, int heavy_edges, int replicas, int table_rows,
                 int tiles, cudaStream_t stream) {
  const int64_t x_bs = (int64_t)table_rows * d;
  const int64_t y_bs = (int64_t)n_rows * d;
  const int row_lanes = d / E;
  const int64_t slots = (int64_t)n_rows + n_heavy;
  csr_wide_kernel<T, E, C, false>
      <<<dim3((unsigned)wide_blocks(slots, tiles), replicas), kGatherThreads,
         0, stream>>>(row_ptr, cols, vals, x, y, slots, heavy, n_heavy,
                      heavy_edges, d, row_lanes, tiles, split.limit, x_bs,
                      y_bs);
  if (split.n_chunks <= 0) return;
  csr_wide_kernel<T, E, C, true>
      <<<dim3((unsigned)wide_blocks(split.n_chunks, tiles), replicas),
         kGatherThreads, 0, stream>>>(split.chunk_bounds, cols, vals, x,
                                      split.partial, split.n_chunks, nullptr,
                                      0, 0, d, row_lanes, tiles, 0, x_bs,
                                      (int64_t)split.n_chunks * d);
  ndcn::fold_chunks_kernel<<<dim3(split.n_long, replicas), kGatherThreads, 0,
                             stream>>>(split.long_rows, split.chunk_ptr,
                                       split.partial, y, d, d, 1,
                                       split.n_chunks, y_bs);
}

// Calls f(std::integral_constant<int, C>{}) for the row lanes a wide lane
// takes, 1, 2 or 4, where C loads of kWords 4-byte words are at most 4
// words (8 edges in flight at least); false for any other.
template <int kWords, typename F>
bool for_wide_columns(int columns, F f) {
  if (columns == 1) {
    f(std::integral_constant<int, 1>{});
    return true;
  }
  if constexpr (2 * kWords <= 4) {
    if (columns == 2) {
      f(std::integral_constant<int, 2>{});
      return true;
    }
  }
  if constexpr (4 * kWords <= 4) {
    if (columns == 4) {
      f(std::integral_constant<int, 4>{});
      return true;
    }
  }
  return false;
}

template <typename T, int E>
void launch_width(const int32_t* row_ptr, const int32_t* cols,
                  const float* vals, const T* x, float* y, int n_rows, int d,
                  const ndcn::RowSplit& split, int replicas, int table_rows,
                  cudaStream_t stream) {
  const ndcn::LaneShape shape = ndcn::lane_shape(d, E);
  const int64_t x_bs = (int64_t)table_rows * d;  // one replica's X
  const int64_t y_bs = (int64_t)n_rows * d;      // and its Y
  const dim3 grid(ndcn::gather_blocks(n_rows, shape.rows), replicas);
  csr_rows_kernel<T, E><<<grid, kGatherThreads, 0, stream>>>(
      row_ptr, cols, vals, x, y, n_rows, d, split.limit, shape, x_bs, y_bs);
  ndcn::launch_long_rows<T, E>(split, cols, vals, x, y, d, d, 1, stream,
                               replicas, x_bs, y_bs);
}

template <typename T>
int launch(const void* row_ptr, const void* cols, const void* vals,
           const void* x, void* y, int n_rows, int d, int width,
           const ndcn::RowSplit& split, int replicas, int table_rows,
           void* stream) {
  if (n_rows <= 0 || d <= 0 || replicas <= 0) return (int)cudaGetLastError();
  if (replicas > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
  if (table_rows <= 0) return (int)cudaErrorInvalidValue;
  if (!ndcn::gather_width_ok<T>(x, d, width)) {
    return (int)cudaErrorInvalidValue;
  }
  ndcn::for_lane_values<T>(width, [&](auto lane_values) {
    launch_width<T, decltype(lane_values)::value>(
        (const int32_t*)row_ptr, (const int32_t*)cols, (const float*)vals,
        (const T*)x, (float*)y, n_rows, d, split, replicas, table_rows,
        (cudaStream_t)stream);
  });
  return (int)cudaGetLastError();
}

// The wide form: `columns` (the row lanes a lane takes), `tiles` and
// `blocks` are the host's plan (tiles of 32 · columns lanes a row,
// gridDim.x of the rows pass over n_heavy + n_rows slots), refused unless
// they are the kernel's.
template <typename T>
int launch_wide_plan(const void* row_ptr, const void* cols, const void* vals,
                     const void* x, void* y, int n_rows, int d, int width,
                     const ndcn::RowSplit& split, const void* heavy,
                     int n_heavy, int heavy_edges, int replicas,
                     int table_rows, int columns, int tiles, long long blocks,
                     void* stream) {
  if (n_rows <= 0 || d <= 0 || replicas <= 0) return (int)cudaGetLastError();
  if (replicas > 65535 || table_rows <= 0 || columns < 1 || n_heavy < 0 ||
      n_heavy > n_rows || !ndcn::gather_width_ok<T>(x, d, width)) {
    return (int)cudaErrorInvalidValue;
  }
  const int row_lanes = d / (width / (int)sizeof(T));
  const int tile_lanes = 32 * columns;
  if (row_lanes <= 32 || tiles != (row_lanes + tile_lanes - 1) / tile_lanes ||
      blocks != wide_blocks((int64_t)n_rows + n_heavy, tiles) ||
      blocks > 0x7fffffffLL ||
      wide_blocks(split.n_chunks, tiles) > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  bool taken = false;
  ndcn::for_lane_values<T>(width, [&](auto lane_values) {
    using LaneValues = decltype(lane_values);
    constexpr int kBytes = LaneValues::value * (int)sizeof(T);
    taken = for_wide_columns<kBytes < 4 ? 1 : kBytes / 4>(
        columns, [&](auto lane_columns) {
          launch_wide<T, LaneValues::value, decltype(lane_columns)::value>(
              (const int32_t*)row_ptr, (const int32_t*)cols,
              (const float*)vals, (const T*)x, (float*)y, n_rows, d, split,
              (const int32_t*)heavy, n_heavy, heavy_edges, replicas,
              table_rows, tiles, (cudaStream_t)stream);
        });
  });
  return taken ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

}  // namespace

// Both launch on `stream`, allocate nothing and do not synchronise; they
// return cudaGetLastError() (0 when every launch was accepted). `width` is
// the bytes of one lane's load (16, 8, 4 or 2; it divides a row of x and x's
// address). The chunk index (long_rows .. partial) is the operator's; with
// n_chunks == 0 the pointers are not read.
extern "C" int ndcn_coo_spmv_f32(
    const void* row_ptr, const void* cols, const void* vals, const void* x,
    void* y, int n_rows, int d, int width, int split_limit,
    const void* long_rows, const void* chunk_ptr, const void* chunk_bounds,
    int n_long, int n_chunks, void* partial, void* stream) {
  const ndcn::RowSplit split = ndcn::row_split(
      split_limit, long_rows, chunk_ptr, chunk_bounds, n_long, n_chunks,
      partial);
  return launch<float>(row_ptr, cols, vals, x, y, n_rows, d, width, split,
                       1, n_rows, stream);
}

// x is a bf16 (n, d) copy of X; vals stay fp32 and are rounded in the kernel.
extern "C" int ndcn_coo_spmv_bf16(
    const void* row_ptr, const void* cols, const void* vals, const void* x,
    void* y, int n_rows, int d, int width, int split_limit,
    const void* long_rows, const void* chunk_ptr, const void* chunk_bounds,
    int n_long, int n_chunks, void* partial, void* stream) {
  const ndcn::RowSplit split = ndcn::row_split(
      split_limit, long_rows, chunk_ptr, chunk_bounds, n_long, n_chunks,
      partial);
  return launch<__nv_bfloat16>(row_ptr, cols, vals, x, y, n_rows, d, width,
                               split, 1, n_rows, stream);
}

// The batched forms: x is `replicas` row-major (table_rows, d) states one
// after another, y `replicas` (n_rows, d) results, and partial (with
// n_chunks > 0) `replicas` scratches of (n_chunks, d). table_rows is n_rows
// for a square A, and every node's row count for a row block's CSR (the
// mesh path). Each replica's y is what the one-replica entry writes for its
// x.
extern "C" int ndcn_coo_spmv_batched_f32(
    const void* row_ptr, const void* cols, const void* vals, const void* x,
    void* y, int n_rows, int d, int width, int split_limit,
    const void* long_rows, const void* chunk_ptr, const void* chunk_bounds,
    int n_long, int n_chunks, void* partial, int replicas, int table_rows,
    void* stream) {
  const ndcn::RowSplit split = ndcn::row_split(
      split_limit, long_rows, chunk_ptr, chunk_bounds, n_long, n_chunks,
      partial);
  return launch<float>(row_ptr, cols, vals, x, y, n_rows, d, width, split,
                       replicas, table_rows, stream);
}

extern "C" int ndcn_coo_spmv_batched_bf16(
    const void* row_ptr, const void* cols, const void* vals, const void* x,
    void* y, int n_rows, int d, int width, int split_limit,
    const void* long_rows, const void* chunk_ptr, const void* chunk_bounds,
    int n_long, int n_chunks, void* partial, int replicas, int table_rows,
    void* stream) {
  const ndcn::RowSplit split = ndcn::row_split(
      split_limit, long_rows, chunk_ptr, chunk_bounds, n_long, n_chunks,
      partial);
  return launch<__nv_bfloat16>(row_ptr, cols, vals, x, y, n_rows, d, width,
                               split, replicas, table_rows, stream);
}

// The wide form, one replica or `replicas` (the batched forms' layout; one
// replica: replicas 1, table_rows n_rows), for d / E > 32. heavy_rows
// (n_heavy of them, int32; null with 0) are the rows of more than
// heavy_edges edges walked whole, whose warps start first. `columns` (C,
// the row lanes a lane takes), `tiles` (tiles of 32 · C lanes a row) and
// `blocks` (gridDim.x of the rows pass) are
// kernels/coo_spmv.py::gather_plan's. y is bit-equal to the entries above.
extern "C" int ndcn_coo_spmv_wide_f32(
    const void* row_ptr, const void* cols, const void* vals, const void* x,
    void* y, int n_rows, int d, int width, int split_limit,
    const void* long_rows, const void* chunk_ptr, const void* chunk_bounds,
    int n_long, int n_chunks, void* partial, const void* heavy_rows,
    int n_heavy, int heavy_edges, int replicas, int table_rows, int columns,
    int tiles, long long blocks, void* stream) {
  const ndcn::RowSplit split = ndcn::row_split(
      split_limit, long_rows, chunk_ptr, chunk_bounds, n_long, n_chunks,
      partial);
  return launch_wide_plan<float>(row_ptr, cols, vals, x, y, n_rows, d, width,
                                 split, heavy_rows, n_heavy, heavy_edges,
                                 replicas, table_rows, columns, tiles, blocks,
                                 stream);
}

extern "C" int ndcn_coo_spmv_wide_bf16(
    const void* row_ptr, const void* cols, const void* vals, const void* x,
    void* y, int n_rows, int d, int width, int split_limit,
    const void* long_rows, const void* chunk_ptr, const void* chunk_bounds,
    int n_long, int n_chunks, void* partial, const void* heavy_rows,
    int n_heavy, int heavy_edges, int replicas, int table_rows, int columns,
    int tiles, long long blocks, void* stream) {
  const ndcn::RowSplit split = ndcn::row_split(
      split_limit, long_rows, chunk_ptr, chunk_bounds, n_long, n_chunks,
      partial);
  return launch_wide_plan<__nv_bfloat16>(row_ptr, cols, vals, x, y, n_rows,
                                         d, width, split, heavy_rows,
                                         n_heavy, heavy_edges, replicas,
                                         table_rows, columns, tiles, blocks,
                                         stream);
}
