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
