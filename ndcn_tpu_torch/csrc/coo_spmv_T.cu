// The feature-major SpMV of the million-node solve: yT (d_sub, n) = (A · X)ᵀ
// for xT = Xᵀ (d_sub, n), A in CSR form, fp32 sums; in GATHER_BF16 mode the
// state is rounded to bf16 and vals are rounded to bf16 as they are read.
//
// K1-fm replaces the narrow form of ndcn_tpu/kernels/coo_spmv.py::_spmv_T
// (the XLA gather xT[:, cols] feeding _make_kernel's one-hot reduce). The TPU
// wanted the node dimension minor so that nothing padded to 128 lanes. On
// the card that layout makes every gathered value its own 32-byte sector,
// n · 4 bytes from its neighbour feature: nnz · d_sub sectors a call (8.4 GB
// at 1M nodes / 11M edges, d_sub = 24) over a 96 MB state that does not fit
// the 50 MB L2, whatever the tiling. Only a row-major copy removes that, so
// K1-fm is two launches:
// - `pack_rows_kernel`: (d_sub, n) → a row-major (n, d_sub) scratch, through
//   a shared-memory tile of 64 nodes × 32 features, so that the read (along
//   n) and the write (whole rows) are both coalesced. In bf16 mode it rounds
//   as it packs. It moves the state once in and once out (0.06 ms at 1M).
// - `csr_rows_T_kernel`: the warp gather of spmv_gather.cuh (shared with K1)
//   over the scratch: 16-byte loads, 6 lanes a 96-byte row, 5 edges in
//   flight a warp. A block owns 32 consecutive rows, stages the (32 × d_sub)
//   result tile in shared memory and stores it transposed, so the
//   feature-major output is written coalesced along n. Long rows go through
//   the chunk kernels, as in K1; the fold writes the feature-major layout.
// Bound: bytes. nnz · 8 of indices and values, the row pointer, the state
// once in and once out: 0.085 ms at 1M at 3.35 TB/s. The gather itself
// cannot reach it: a random 96-byte row costs three sectors whoever reads
// it, nnz · 96 bytes = 1.06 GB at 1M, 0.32 ms, plus the pack. No atomics:
// results repeat bit for bit.
//
// K5 replaces ndcn_tpu/kernels/coo_spmv.py::_make_kernel_wide (via
// _spmv_T_wide), the JAX package's wide mode (`GATHER_WIDE`): there the
// gather reads a row-major (n, 128) table that the wrapper materialises
// behind an optimization barrier. Here the wrapper materialises the (n,
// d_sub) table with one PyTorch copy (bf16 rounded as it copies) and K5 is
// K1-fm's gather over it: the same entries, chunk index and fold. Its
// bound is K1-fm's; what it pays over K1-fm is the copy against the pack.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "spmv_gather.cuh"

namespace {

using ndcn::kGatherThreads;

constexpr int kRowsPerBlock = 32;  // output rows a block owns
constexpr int kPackNodes = 64;     // pack tile: 64 nodes × 32 features
constexpr int kPackFeatures = 32;

__device__ __forceinline__ void store_packed(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_packed(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// xT (d_sub, n) fp32 -> table (n, d_sub) of T, row-major.
template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
pack_rows_kernel(const float* __restrict__ xT, T* __restrict__ table, int n,
                 int d_sub) {
  __shared__ float tile[kPackFeatures][kPackNodes + 1];
  const int64_t n0 = (int64_t)blockIdx.x * kPackNodes;
  const int f0 = blockIdx.y * kPackFeatures;
  const int nodes = min((int64_t)kPackNodes, n - n0);
  const int features = min(kPackFeatures, d_sub - f0);
  for (int i = threadIdx.x; i < features * kPackNodes; i += kGatherThreads) {
    const int f = i / kPackNodes;
    const int r = i - f * kPackNodes;
    if (r < nodes) {
      tile[f][r] = xT[(int64_t)(f0 + f) * n + n0 + r];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nodes * features; i += kGatherThreads) {
    const int r = i / features;
    const int f = i - r * features;
    store_packed(table + (n0 + r) * d_sub + f0 + f, tile[f][r]);
  }
}

// table (n, d_sub) of T, row-major -> yT (d_sub, n) fp32.
template <typename T, int E>
__global__ void __launch_bounds__(kGatherThreads, ndcn::kGatherBlocksPerSm)
csr_rows_T_kernel(const int32_t* __restrict__ row_ptr,
                  const int32_t* __restrict__ cols,
                  const float* __restrict__ vals,
                  const T* __restrict__ table, float* __restrict__ yT, int n,
                  int d_sub, int split_limit, ndcn::LaneShape shape) {
  extern __shared__ float tile[];    // (kRowsPerBlock, d_sub + 1)
  const int pitch = d_sub + 1;       // odd pitch: no bank conflicts below
  const int64_t row0 = (int64_t)blockIdx.x * kRowsPerBlock;
  const int warp = threadIdx.x >> 5;
  const ndcn::WarpLanes w(shape, threadIdx.x & 31);

  // shape.rows divides kRowsPerBlock, so a warp's rows stay inside the tile
  for (int r0 = warp * shape.rows; r0 < kRowsPerBlock;
       r0 += (kGatherThreads / 32) * shape.rows) {
    if (row0 + r0 >= n) break;       // uniform across the warp
    const int r = r0 + w.row;
    const int64_t row = row0 + r;
    const bool valid = row < n;
    const int start = valid ? row_ptr[row] : 0;
    int end = valid ? row_ptr[row + 1] : 0;
    if (end - start > split_limit) {
      end = start;  // a split row: zeros here, its sum from the fold
    }
    for (int seg = 0; seg < w.segments; ++seg) {
      const int j = valid ? w.row_lane(seg) : -1;
      float acc[E];
      ndcn::warp_gather<T, E>(cols, vals, table, d_sub, start, end, w, j,
                              acc);
      if (w.group == 0 && j >= 0) {
#pragma unroll
        for (int k = 0; k < E; ++k) {
          tile[r * pitch + j * E + k] = acc[k];
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRowsPerBlock * d_sub; i += kGatherThreads) {
    const int f = i / kRowsPerBlock;
    const int r = i - f * kRowsPerBlock;
    if (row0 + r < n) {
      yT[(int64_t)f * n + row0 + r] = tile[r * pitch + f];
    }
  }
}

template <typename T>
int launch_pack(const void* xT, void* table, int n, int d_sub, void* stream) {
  if (n > 0 && d_sub > 0) {
    const dim3 grid((n + kPackNodes - 1) / kPackNodes,
                    (d_sub + kPackFeatures - 1) / kPackFeatures);
    pack_rows_kernel<T><<<grid, kGatherThreads, 0, (cudaStream_t)stream>>>(
        (const float*)xT, (T*)table, n, d_sub);
  }
  return (int)cudaGetLastError();
}

template <typename T, int E>
void launch_width(const int32_t* row_ptr, const int32_t* cols,
                  const float* vals, const T* table, float* yT, int n,
                  int d_sub, const ndcn::RowSplit& split,
                  cudaStream_t stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t smem = (size_t)kRowsPerBlock * (d_sub + 1) * sizeof(float);
  csr_rows_T_kernel<T, E><<<blocks, kGatherThreads, smem, stream>>>(
      row_ptr, cols, vals, table, yT, n, d_sub, split.limit,
      ndcn::lane_shape(d_sub, E));
  ndcn::launch_long_rows<T, E>(split, cols, vals, table, yT, d_sub, 1, n,
                               stream);
}

template <typename T>
int launch_feature_major(const void* row_ptr, const void* cols,
                         const void* vals, const void* table, void* yT, int n,
                         int d_sub, int width, const ndcn::RowSplit& split,
                         void* stream) {
  if (n <= 0 || d_sub <= 0) return (int)cudaGetLastError();
  // the staged tile must fit the 48 KB of static-sized dynamic shared memory
  if (!ndcn::gather_width_ok<T>(table, d_sub, width) ||
      (size_t)kRowsPerBlock * (d_sub + 1) * sizeof(float) > 48 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  ndcn::for_lane_values<T>(width, [&](auto lane_values) {
    launch_width<T, decltype(lane_values)::value>(
        (const int32_t*)row_ptr, (const int32_t*)cols, (const float*)vals,
        (const T*)table, (float*)yT, n, d_sub, split, (cudaStream_t)stream);
  });
  return (int)cudaGetLastError();
}

}  // namespace

// All launch on `stream`, allocate nothing, do not synchronise, and return
// cudaGetLastError() (0 when every launch was accepted).

// xT (d_sub, n) fp32 -> table (n, d_sub) fp32, row-major.
extern "C" int ndcn_pack_rows_f32(const void* xT, void* table, int n,
                                  int d_sub, void* stream) {
  return launch_pack<float>(xT, table, n, d_sub, stream);
}

// xT (d_sub, n) fp32 -> table (n, d_sub) bf16, row-major, rounded to nearest.
extern "C" int ndcn_pack_rows_bf16(const void* xT, void* table, int n,
                                   int d_sub, void* stream) {
  return launch_pack<__nv_bfloat16>(xT, table, n, d_sub, stream);
}

// The gather of K1-fm and K5: table (n, d_sub) fp32, row-major (K1-fm's
// packed scratch, or K5's copy) -> yT (d_sub, n) fp32. `width` and the
// chunk index as in ndcn_coo_spmv_f32.
extern "C" int ndcn_coo_spmv_T_f32(
    const void* row_ptr, const void* cols, const void* vals,
    const void* table, void* yT, int n, int d_sub, int width,
    int split_limit, const void* long_rows, const void* chunk_ptr,
    const void* chunk_bounds, int n_long, int n_chunks, void* partial,
    void* stream) {
  return launch_feature_major<float>(
      row_ptr, cols, vals, table, yT, n, d_sub, width,
      ndcn::row_split(split_limit, long_rows, chunk_ptr, chunk_bounds, n_long,
                      n_chunks, partial),
      stream);
}

// The same over a bf16 table.
extern "C" int ndcn_coo_spmv_T_bf16(
    const void* row_ptr, const void* cols, const void* vals,
    const void* table, void* yT, int n, int d_sub, int width,
    int split_limit, const void* long_rows, const void* chunk_ptr,
    const void* chunk_bounds, int n_long, int n_chunks, void* partial,
    void* stream) {
  return launch_feature_major<__nv_bfloat16>(
      row_ptr, cols, vals, table, yT, n, d_sub, width,
      ndcn::row_split(split_limit, long_rows, chunk_ptr, chunk_bounds, n_long,
                      n_chunks, partial),
      stream);
}
