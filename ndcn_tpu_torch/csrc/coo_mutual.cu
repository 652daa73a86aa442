// K1-w's warp form (coo_mutual.cuh has the sums, the TPU kernel it
// replaces, and which form runs where).
//
// Bound: bytes. A call must read A's row pointer, columns and values (8
// bytes an edge), x (and g in the backward) once and write y once; at the
// 50k-node graph of the scale driver (499,948 entries) and d = 1 that is
// 4.6 MB, 1.4 µs at 3.35 TB/s.
// What a kernel pays above that is the latency of the dependent gathers, as
// for K1, so the design is K1's (spmv_gather.cuh):
// - One warp (at d = 1 a quarter warp) per row, the lanes laid out by the
//   host's LaneShape: each lane loads its E features of the row endpoint
//   x[r] (and g[r] on the row side) once, then its group walks every
//   groups-th edge, gathering the column endpoint x[c] (and g[c] on the
//   column side) with the widest load that divides a row.
// - The pair term and its two partials are evaluated in registers; lane
//   sums are fp32 FMAs and the groups fold by shuffles in a fixed order
//   (warp_fold).
// - Rows longer than the split limit are zeros in the rows kernel; a chunk
//   kernel sums each chunk of the operator's RowSplit (the row endpoint is
//   the chunk's row, read from the expanded rows array) into a scratch,
//   and a fold adds a row's chunks to y in chunk order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "coo_mutual.cuh"
#include "spmv_gather.cuh"

namespace {

using ndcn::kGatherThreads;

using ndcn::mutual::Coef;
using ndcn::mutual::kColumnSide;
using ndcn::mutual::kForward;
using ndcn::mutual::kRowSide;
using ndcn::mutual::safe_div;

// 4 blocks of 256 threads an SM: up to 64 registers a thread, for the row
// endpoint, the gathered endpoint and its cotangent, and the sums
constexpr int kMutualBlocksPerSm = 4;

// The lane's E features of row `row` of a row-major (n, d) table.
template <int E>
__device__ __forceinline__ void row_values(const float* table, int64_t row,
                                           int d, int j, float (&out)[E]) {
  ndcn::load_values<float, E>(table + row * d + j * E, out);
}

// The lane's share of the sum over edges [start, end), folded over the
// row's groups (group 0 holds the result). xr and gr are the row
// endpoint's state and cotangent at this lane's features (gr is read on
// the row side only). Every lane of the warp must call this.
template <int SIDE, int E>
__device__ __forceinline__ void pair_sum(
    const int32_t* __restrict__ cols, const float* __restrict__ vals,
    const float* __restrict__ x, const float* __restrict__ g, int d,
    int start, int end, const ndcn::WarpLanes& w, int j,
    const float (&xr)[E], const float (&gr)[E], Coef c, float (&acc)[E]) {
#pragma unroll
  for (int k = 0; k < E; ++k) {
    acc[k] = 0.0f;
  }
  if (j >= 0) {
    for (int e = start + w.group; e < end; e += w.groups) {
      const float v = __ldg(vals + e);
      const int64_t col = __ldg(cols + e);
      float xc[E], gc[E];
      row_values<E>(x, col, d, j, xc);
      if constexpr (SIDE == kColumnSide) {
        row_values<E>(g, col, d, j, gc);
      }
#pragma unroll
      for (int k = 0; k < E; ++k) {
        float term;
        if constexpr (SIDE == kForward) {
          term = safe_div(xr[k] * xc[k], c.d + c.e * xr[k] + c.h * xc[k]);
        } else if constexpr (SIDE == kRowSide) {
          const float den = c.d + c.e * xr[k] + c.h * xc[k];
          term = v * gr[k] * safe_div(xc[k] * (c.d + c.h * xc[k]), den * den);
        } else {
          // the gathered endpoint is the edge's row i, this row its column
          const float den = c.d + c.e * xc[k] + c.h * xr[k];
          term = v * gc[k] * safe_div(xc[k] * (c.d + c.e * xc[k]), den * den);
        }
        acc[k] = SIDE == kForward ? fmaf(v, term, acc[k]) : acc[k] + term;
      }
    }
  }
  ndcn::warp_fold<E>(w, acc);
}

template <int SIDE, int E>
__global__ void __launch_bounds__(kGatherThreads, kMutualBlocksPerSm)
mutual_rows_kernel(const int32_t* __restrict__ row_ptr,
                   const int32_t* __restrict__ cols,
                   const float* __restrict__ vals, const float* __restrict__ x,
                   const float* __restrict__ g, float* __restrict__ y,
                   int n_rows, int d, int split_limit, ndcn::LaneShape shape,
                   Coef c, int accumulate) {
  const int64_t first = (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5)
                        * shape.rows;
  if (first >= n_rows) return;  // uniform across the warp
  const ndcn::WarpLanes w(shape, threadIdx.x & 31);
  const int64_t row = first + w.row;
  const bool valid = row < n_rows;
  const int start = valid ? row_ptr[row] : 0;
  int end = valid ? row_ptr[row + 1] : 0;
  if (end - start > split_limit) {
    end = start;  // a split row: nothing here, its sum from the chunks
  }
  for (int seg = 0; seg < w.segments; ++seg) {
    const int j = valid ? w.row_lane(seg) : -1;
    float xr[E], gr[E], acc[E];
    if (j >= 0) {
      row_values<E>(x, row, d, j, xr);
      if constexpr (SIDE == kRowSide) {
        row_values<E>(g, row, d, j, gr);
      }
    }
    pair_sum<SIDE, E>(cols, vals, x, g, d, start, end, w, j, xr, gr, c, acc);
    if (w.group == 0 && j >= 0) {
      float* out = y + row * d + j * E;
      if (accumulate) {
#pragma unroll
        for (int k = 0; k < E; ++k) {
          acc[k] = out[k] + acc[k];
        }
      }
      ndcn::store_values<E>(out, acc);
    }
  }
}

// One row's share of a warp per chunk of a long row: partial (n_chunks, d).
template <int SIDE, int E>
__global__ void __launch_bounds__(kGatherThreads, kMutualBlocksPerSm)
mutual_chunks_kernel(const int32_t* __restrict__ chunk_bounds,
                     const int64_t* __restrict__ rows,
                     const int32_t* __restrict__ cols,
                     const float* __restrict__ vals,
                     const float* __restrict__ x, const float* __restrict__ g,
                     float* __restrict__ partial, int n_chunks, int d,
                     ndcn::LaneShape shape, Coef c) {
  const int64_t first = (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5)
                        * shape.rows;
  if (first >= n_chunks) return;  // uniform across the warp
  const ndcn::WarpLanes w(shape, threadIdx.x & 31);
  const int64_t chunk = first + w.row;
  const bool valid = chunk < n_chunks;
  const int start = valid ? chunk_bounds[2 * chunk] : 0;
  const int end = valid ? chunk_bounds[2 * chunk + 1] : 0;
  const int64_t row = valid ? rows[start] : 0;  // chunks are never empty
  for (int seg = 0; seg < w.segments; ++seg) {
    const int j = valid ? w.row_lane(seg) : -1;
    float xr[E], gr[E], acc[E];
    if (j >= 0) {
      row_values<E>(x, row, d, j, xr);
      if constexpr (SIDE == kRowSide) {
        row_values<E>(g, row, d, j, gr);
      }
    }
    pair_sum<SIDE, E>(cols, vals, x, g, d, start, end, w, j, xr, gr, c, acc);
    if (w.group == 0 && j >= 0) {
      ndcn::store_values<E>(partial + chunk * d + j * E, acc);
    }
  }
}

// One block per long row: y[row] plus its chunks' sums, in chunk order.
__global__ void __launch_bounds__(kGatherThreads)
fold_add_kernel(const int32_t* __restrict__ long_rows,
                const int32_t* __restrict__ chunk_ptr,
                const float* __restrict__ partial, float* __restrict__ y,
                int d) {
  const int64_t row = long_rows[blockIdx.x];
  const int first = chunk_ptr[blockIdx.x];
  const int last = chunk_ptr[blockIdx.x + 1];
  for (int f = threadIdx.x; f < d; f += blockDim.x) {
    float acc = y[row * d + f];
    for (int c = first; c < last; ++c) {
      acc += partial[(int64_t)c * d + f];
    }
    y[row * d + f] = acc;
  }
}

template <int SIDE, int E>
void launch_side(const int32_t* row_ptr, const int64_t* rows,
                 const int32_t* cols, const float* vals, const float* x,
                 const float* g, float* y, int n_rows, int d, Coef c,
                 int accumulate, const ndcn::RowSplit& split,
                 cudaStream_t stream) {
  const ndcn::LaneShape shape = ndcn::lane_shape(d, E);
  mutual_rows_kernel<SIDE, E>
      <<<ndcn::gather_blocks(n_rows, shape.rows), kGatherThreads, 0,
         stream>>>(row_ptr, cols, vals, x, g, y, n_rows, d, split.limit,
                   shape, c, accumulate);
  if (split.n_chunks <= 0) return;
  mutual_chunks_kernel<SIDE, E>
      <<<ndcn::gather_blocks(split.n_chunks, shape.rows), kGatherThreads, 0,
         stream>>>(split.chunk_bounds, rows, cols, vals, x, g, split.partial,
                   split.n_chunks, d, shape, c);
  fold_add_kernel<<<split.n_long, kGatherThreads, 0, stream>>>(
      split.long_rows, split.chunk_ptr, split.partial, y, d);
}

template <int SIDE>
void launch(const void* row_ptr, const void* rows, const void* cols,
            const void* vals, const void* x, const void* g, void* y,
            int n_rows, int d, int width, Coef c, int accumulate,
            const ndcn::RowSplit& split, cudaStream_t stream) {
  ndcn::for_lane_values<float>(width, [&](auto lane_values) {
    launch_side<SIDE, decltype(lane_values)::value>(
        (const int32_t*)row_ptr, (const int64_t*)rows, (const int32_t*)cols,
        (const float*)vals, (const float*)x, (const float*)g, (float*)y,
        n_rows, d, c, accumulate, split, stream);
  });
}

}  // namespace

// One side of K1-w over one CSR (A's for the forward and the row side, the
// transpose's for the column side): side 0 forward, 1 row side, 2 column
// side. x, g (read on sides 1 and 2) and y are row-major (n, d) fp32;
// `width` is the bytes of one lane's load (16, 8 or 4; it divides a row and
// the addresses of x and g). With `accumulate` the sums are added to y,
// else they replace it. `rows` is the CSR's expanded row of each edge
// (int64), read once per chunk of a long row. The chunk index (long_rows ..
// partial) is the operator's; with n_chunks == 0 it is not read. Launches
// on `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 when every launch was accepted).
extern "C" int ndcn_coo_mutual_f32(
    int side, const void* row_ptr, const void* rows, const void* cols,
    const void* vals, const void* x, const void* g, void* y, int n_rows,
    int d, int width, float dd, float e, float h, int accumulate,
    int split_limit, const void* long_rows, const void* chunk_ptr,
    const void* chunk_bounds, int n_long, int n_chunks, void* partial,
    void* stream) {
  if (n_rows <= 0 || d <= 0) return (int)cudaGetLastError();
  if (side < kForward || side > kColumnSide ||
      !ndcn::gather_width_ok<float>(x, d, width) ||
      (side != kForward && !ndcn::gather_width_ok<float>(g, d, width))) {
    return (int)cudaErrorInvalidValue;
  }
  const ndcn::RowSplit split = ndcn::row_split(
      split_limit, long_rows, chunk_ptr, chunk_bounds, n_long, n_chunks,
      partial);
  const Coef c{dd, e, h};
  const cudaStream_t s = (cudaStream_t)stream;
  if (side == kForward) {
    launch<kForward>(row_ptr, rows, cols, vals, x, g, y, n_rows, d, width, c,
                     accumulate, split, s);
  } else if (side == kRowSide) {
    launch<kRowSide>(row_ptr, rows, cols, vals, x, g, y, n_rows, d, width, c,
                     accumulate, split, s);
  } else {
    launch<kColumnSide>(row_ptr, rows, cols, vals, x, g, y, n_rows, d, width,
                        c, accumulate, split, s);
  }
  return (int)cudaGetLastError();
}
