// K1: Y (n, d) = A · X for a CSR matrix A and a row-major X, fp32 sums.
//
// Replaces the TPU kernel ndcn_tpu/kernels/coo_spmv.py::_make_kernel
// (seg_kernel). That kernel reduced row-sorted COO slices into resident row
// tiles with a one-hot MXU matmul, in bf16 splits and a feature-major (d, n)
// layout: all of that answered the TPU's slow scatter and its (8, 128) lane
// padding. On Hopper the same product is a plain gather-scale-reduce:
//
// - One warp per row. The warp is cut into groups of v lanes (v = d rounded
//   up to a power of two, at most 32); each group takes every (32/v)-th edge
//   of the row, and each lane of a group one feature, so a group reads
//   x[col, :] as d contiguous values. Widths above 32 loop over features in
//   chunks of 32.
// - Each lane sums in a register (fp32 FMA); the groups are then folded by
//   warp shuffles, and lane group 0 writes the row's result once. No (nnz, d)
//   intermediate touches device memory, and no atomics are used: the order
//   of every sum is fixed by (row, d), so results repeat bit for bit from run
//   to run, which the adaptive step controller needs for repeatable NFE.
// - The bf16 instance (the JAX package's GATHER_BF16 mode) gathers a bf16
//   copy of X and rounds each value of A to bf16 as it reads it, as the TPU
//   kernel folds vals into its bf16 one-hot; the product of two bf16 values
//   is exact in fp32, and the sums stay fp32.
//
// Bound: gather bandwidth. One call moves about nnz·(d·s + 8) + n·d·4 bytes
// (x rows of s = 4 or 2 bytes per value, plus the column index and value,
// plus the output). At the 200k-node / 2.2M-edge operator and d = 20 X is
// 16 MB, so most gathers hit the 50 MB L2. Hub rows of power-law graphs run
// serially on one warp: right, but not load balanced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "spmv_common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps, so 8 rows per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_rowwarp_kernel(const int32_t* __restrict__ row_ptr,
                   const int32_t* __restrict__ cols,
                   const float* __restrict__ vals,
                   const T* __restrict__ x,
                   float* __restrict__ y,
                   int n_rows, int d, int v_log2) {
  const int64_t gtid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row = gtid >> 5;
  if (row >= n_rows) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;
  const int v = 1 << v_log2;          // lanes per edge group
  const int groups = 32 >> v_log2;    // edges in flight per warp
  const int g = lane >> v_log2;
  const int f_lane = lane & (v - 1);
  const int start = row_ptr[row];
  const int end = row_ptr[row + 1];

  for (int f0 = 0; f0 < d; f0 += v) {
    const int f = f0 + f_lane;
    float acc = 0.0f;
    if (f < d) {
      for (int e = start + g; e < end; e += groups) {
        acc = fmaf(ndcn::edge_val<T>(vals + e),
                   ndcn::to_float(x[(int64_t)__ldg(cols + e) * d + f]), acc);
      }
    }
    // fold the edge groups: lanes that share f_lane differ only in bits >= v
    for (int off = 16; off >= v; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (g == 0 && f < d) {
      y[row * d + f] = acc;
    }
  }
}

template <typename T>
int launch(const void* row_ptr, const void* cols, const void* vals,
           const void* x, void* y, int n_rows, int d, void* stream) {
  if (n_rows > 0 && d > 0) {
    int v_log2 = 0;
    while ((1 << v_log2) < d && v_log2 < 5) {
      ++v_log2;
    }
    const int rows_per_block = kThreads / 32;
    const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
    csr_rowwarp_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)row_ptr, (const int32_t*)cols, (const float*)vals,
        (const T*)x, (float*)y, n_rows, d, v_log2);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`, allocates nothing and does not synchronise. Returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int ndcn_coo_spmv_f32(const void* row_ptr, const void* cols,
                                 const void* vals, const void* x, void* y,
                                 int n_rows, int d, void* stream) {
  return launch<float>(row_ptr, cols, vals, x, y, n_rows, d, stream);
}

// x is a bf16 (n, d) copy of X; vals stay fp32 and are rounded in the kernel.
extern "C" int ndcn_coo_spmv_bf16(const void* row_ptr, const void* cols,
                                  const void* vals, const void* x, void* y,
                                  int n_rows, int d, void* stream) {
  return launch<__nv_bfloat16>(row_ptr, cols, vals, x, y, n_rows, d, stream);
}
