// The feature-major SpMV of the million-node solve: yT (d_sub, n) = (A · X)ᵀ
// for xT = Xᵀ (d_sub, n), A in CSR form, fp32 sums; the state may be a bf16
// copy (GATHER_BF16), with vals rounded to bf16 as they are read.
//
// K1-fm replaces the narrow form of ndcn_tpu/kernels/coo_spmv.py::_spmv_T
// (the XLA gather xT[:, cols] feeding _make_kernel's one-hot reduce). The TPU
// wanted the node dimension minor so that nothing padded to 128 lanes; on
// the card the same layout makes every gathered value its own 32-byte
// sector, n·4 bytes from its neighbour feature. The kernel is the plain
// form of that access:
// - A block is 32 rows × 8 feature lanes. Thread (r, f) walks row r's CSR
//   edges in order and sums vals[e] · xT[f, cols[e]] in a register (fp32
//   FMA), for f, f + 8, ... below d_sub; it writes yT[f, r] once. Stores
//   are coalesced along n (32 consecutive rows per warp); gathers are not,
//   by the layout.
// - No atomics: every sum has the order of the row's CSR edges, so results
//   repeat bit for bit.
// Bound: gathered sectors. About nnz · d_sub · 32 bytes of sector traffic
// per call when X (d_sub · n · 4 bytes, 96 MB at 1M nodes) does not fit in
// the 50 MB L2.
//
// K5 replaces ndcn_tpu/kernels/coo_spmv.py::_make_kernel_wide (via
// _spmv_T_wide): the gather reads a row-major (n, d_sub) table instead,
// which the wrapper materialises once per call (a transpose copy; the TPU
// padded it to 128 lanes, which buys nothing here). Then:
// - One warp per row, as K1: groups of v lanes (v = d_sub rounded up to a
//   power of two, at most 32) take every (32/v)-th edge and each lane one
//   feature, so one edge reads d_sub contiguous values. Groups fold by warp
//   shuffles in a fixed order.
// - A block owns 32 consecutive rows: the warps stage the (32 × d_sub)
//   result tile in shared memory, and the block stores it transposed, so the
//   feature-major output is written coalesced along n.
// Bound: about nnz · (d_sub · s + 8) bytes of gathers (s = 4 or 2) plus the
// table's write and read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "spmv_common.cuh"

namespace {

constexpr int kRowsPerBlock = 32;
constexpr int kFeatureLanes = 8;   // K1-fm block: 32 × 8 threads
constexpr int kWideThreads = 256;  // K5 block: 8 warps over 32 rows

template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock * kFeatureLanes)
csr_feature_major_kernel(const int32_t* __restrict__ row_ptr,
                         const int32_t* __restrict__ cols,
                         const float* __restrict__ vals,
                         const T* __restrict__ xT, float* __restrict__ yT,
                         int n, int d_sub) {
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x;
  if (row >= n) return;
  const int start = row_ptr[row];
  const int end = row_ptr[row + 1];
  for (int f = threadIdx.y; f < d_sub; f += kFeatureLanes) {
    const T* xf = xT + (int64_t)f * n;
    float acc = 0.0f;
    for (int e = start; e < end; ++e) {
      acc = fmaf(ndcn::edge_val<T>(vals + e),
                 ndcn::to_float(xf[__ldg(cols + e)]), acc);
    }
    yT[(int64_t)f * n + row] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
csr_wide_kernel(const int32_t* __restrict__ row_ptr,
                const int32_t* __restrict__ cols,
                const float* __restrict__ vals,
                const T* __restrict__ table, float* __restrict__ yT,
                int n, int d_sub, int v_log2) {
  extern __shared__ float tile[];    // (kRowsPerBlock, d_sub + 1)
  const int pitch = d_sub + 1;       // odd pitch: no bank conflicts below
  const int64_t row0 = (int64_t)blockIdx.x * kRowsPerBlock;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int v = 1 << v_log2;
  const int groups = 32 >> v_log2;
  const int g = lane >> v_log2;
  const int f_lane = lane & (v - 1);
  const int warps = kWideThreads / 32;

  for (int r = warp; r < kRowsPerBlock; r += warps) {
    const int64_t row = row0 + r;
    if (row >= n) break;             // uniform across the warp
    const int start = row_ptr[row];
    const int end = row_ptr[row + 1];
    for (int f0 = 0; f0 < d_sub; f0 += v) {
      const int f = f0 + f_lane;
      float acc = 0.0f;
      if (f < d_sub) {
        for (int e = start + g; e < end; e += groups) {
          acc = fmaf(ndcn::edge_val<T>(vals + e),
                     ndcn::to_float(
                         table[(int64_t)__ldg(cols + e) * d_sub + f]),
                     acc);
        }
      }
      for (int off = 16; off >= v; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (g == 0 && f < d_sub) {
        tile[r * pitch + f] = acc;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRowsPerBlock * d_sub; i += kWideThreads) {
    const int f = i / kRowsPerBlock;
    const int r = i - f * kRowsPerBlock;
    if (row0 + r < n) {
      yT[(int64_t)f * n + row0 + r] = tile[r * pitch + f];
    }
  }
}

template <typename T>
int launch_feature_major(const void* row_ptr, const void* cols,
                         const void* vals, const void* xT, void* yT, int n,
                         int d_sub, void* stream) {
  if (n > 0 && d_sub > 0) {
    const dim3 block(kRowsPerBlock, kFeatureLanes);
    const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
    csr_feature_major_kernel<T><<<blocks, block, 0, (cudaStream_t)stream>>>(
        (const int32_t*)row_ptr, (const int32_t*)cols, (const float*)vals,
        (const T*)xT, (float*)yT, n, d_sub);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wide(const void* row_ptr, const void* cols, const void* vals,
                const void* table, void* yT, int n, int d_sub, void* stream) {
  if (n > 0 && d_sub > 0) {
    int v_log2 = 0;
    while ((1 << v_log2) < d_sub && v_log2 < 5) {
      ++v_log2;
    }
    const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
    const size_t smem = (size_t)kRowsPerBlock * (d_sub + 1) * sizeof(float);
    csr_wide_kernel<T><<<blocks, kWideThreads, smem, (cudaStream_t)stream>>>(
        (const int32_t*)row_ptr, (const int32_t*)cols, (const float*)vals,
        (const T*)table, (float*)yT, n, d_sub, v_log2);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// All four launch on `stream`, allocate nothing, do not synchronise, and
// return cudaGetLastError() (0 when the launch was accepted).

// xT (d_sub, n) fp32 -> yT (d_sub, n) fp32.
extern "C" int ndcn_coo_spmv_T_f32(const void* row_ptr, const void* cols,
                                   const void* vals, const void* xT, void* yT,
                                   int n, int d_sub, void* stream) {
  return launch_feature_major<float>(row_ptr, cols, vals, xT, yT, n, d_sub,
                                     stream);
}

// xT (d_sub, n) bf16 -> yT (d_sub, n) fp32.
extern "C" int ndcn_coo_spmv_T_bf16(const void* row_ptr, const void* cols,
                                    const void* vals, const void* xT,
                                    void* yT, int n, int d_sub,
                                    void* stream) {
  return launch_feature_major<__nv_bfloat16>(row_ptr, cols, vals, xT, yT, n,
                                             d_sub, stream);
}

// table (n, d_sub) fp32, row-major -> yT (d_sub, n) fp32.
extern "C" int ndcn_coo_spmv_T_wide_f32(const void* row_ptr, const void* cols,
                                        const void* vals, const void* table,
                                        void* yT, int n, int d_sub,
                                        void* stream) {
  return launch_wide<float>(row_ptr, cols, vals, table, yT, n, d_sub, stream);
}

// table (n, d_sub) bf16, row-major -> yT (d_sub, n) fp32.
extern "C" int ndcn_coo_spmv_T_wide_bf16(const void* row_ptr,
                                         const void* cols, const void* vals,
                                         const void* table, void* yT, int n,
                                         int d_sub, void* stream) {
  return launch_wide<__nv_bfloat16>(row_ptr, cols, vals, table, yT, n, d_sub,
                                    stream);
}
