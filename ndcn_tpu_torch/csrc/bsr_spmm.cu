// K3: Y (n_rows, d) = A · X for a block-sparse A and a row-major X, fp32.
// K4: out (n, d) = relu((A · X) · W + b) for the same A, fp32.
//
// Replace the TPU kernels ndcn_tpu/kernels/bsr_spmm.py::_spmm_kernel and
// ::_spmm_fused_kernel. There a sequential grid walked (row block, slot) over
// an ELL of 128 x 128 blocks padded with a reserved zero block, scalar
// prefetch chose the block and the X row block of each step, and the output
// row block stayed in VMEM across the slots. Here A is plain block-CSR
// (row_ptr over row blocks, block_cols, blocks of B x B floats, row-major),
// so there is no padding slot, and a CTA walks the nonzero blocks of its row
// block in a loop of its own:
//
// - K3: one CTA of 256 threads per (32-row tile of a row block, 32-column
//   slab of d). For each nonzero block it stages a 32 x 32 tile of the block
//   and the matching 32 x 32 chunk of X in shared memory; each thread keeps
//   1 row x 4 columns in registers (fp32 FMA) and stores them once.
// - K4: one CTA per 32-row tile, for all of d. Phase 1 is K3's loop once per
//   32-column slab, its result kept as a 32 x d panel in shared memory (odd
//   row stride), never in device memory; phase 2 is K2's epilogue: the panel
//   times W (staged in 32 x 32 chunks; W may be strided), plus b, relu.
//
// Arithmetic is fp32 FMA, not TF32 (the TPU kernels run at
// Precision.HIGHEST). Every sum has a fixed order and no atomics are used,
// so results repeat bit for bit, which the adaptive controller's NFE needs.
// Ragged edges (B not a multiple of 32, n not a multiple of B, d not a
// multiple of 32) are masked in the loads and stores; nothing is padded in
// device memory.
//
// Bound: at the NDCN widths (d = 20) launch latency; at large d the CUDA-core
// FMA rate, with each block tile read from L2 once per 32-column slab (K3)
// or once per 32-row tile (K4). Tensor cores (wgmma) and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32;        // rows of one tile, inside one row block
constexpr int kBK = 32;        // depth of one staged chunk
constexpr int kBN = 32;        // columns of one slab
constexpr int kThreads = 256;  // ty = tid / 8 picks the row, tx = tid % 8 four columns

struct Bsr {
  const int32_t* row_ptr;     // (n_row_blocks + 1,)
  const int32_t* block_cols;  // (nnzb,)
  const float* blocks;        // (nnzb, B, B)
  int block;                  // B
  int n_rows, n_cols;
};

// acc[j] = (A · X)[row, c0 + 4 tx + j] for row = rb·B + r0 + ty, summed over
// the row block's nonzero blocks in storage order.
__device__ __forceinline__ void slab(const Bsr& a, const float* __restrict__ x,
                                     int d, int rb, int r0, int c0,
                                     float (*a_s)[kBK + 1],
                                     float (*x_s)[kBN], float acc[4]) {
  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int B = a.block;
  const int s_end = a.row_ptr[rb + 1];
  for (int s = a.row_ptr[rb]; s < s_end; ++s) {
    const float* blk = a.blocks + (int64_t)s * B * B;
    const int64_t xrow0 = (int64_t)a.block_cols[s] * B;
    for (int k0 = 0; k0 < B; k0 += kBK) {
      for (int i = tid; i < kBM * kBK; i += kThreads) {
        const int r = i / kBK, c = i % kBK;
        const int br = r0 + r, bc = k0 + c;
        a_s[r][c] = (br < B && bc < B) ? blk[(int64_t)br * B + bc] : 0.0f;
      }
      for (int i = tid; i < kBK * kBN; i += kThreads) {
        const int r = i / kBN, c = i % kBN;
        const int64_t gr = xrow0 + k0 + r;
        const int gc = c0 + c;
        x_s[r][c] = (k0 + r < B && gr < a.n_cols && gc < d) ? x[gr * d + gc]
                                                            : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float av = a_s[ty][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j] = fmaf(av, x_s[kk][tx * 4 + j], acc[j]);
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(Bsr a, const float* __restrict__ x, float* __restrict__ y,
                int d, int tiles_per_block) {
  __shared__ float a_s[kBM][kBK + 1];  // +1: rows land in distinct banks
  __shared__ float x_s[kBK][kBN];
  const int rb = blockIdx.x / tiles_per_block;
  const int r0 = (blockIdx.x % tiles_per_block) * kBM;
  const int c0 = blockIdx.y * kBN;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  slab(a, x, d, rb, r0, c0, a_s, x_s, acc);
  const int ty = threadIdx.x >> 3;
  const int tx = threadIdx.x & 7;
  const int64_t row = (int64_t)rb * a.block + r0 + ty;
  if (r0 + ty < a.block && row < a.n_rows) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c < d) y[row * d + c] = acc[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bsr_fused_rhs_kernel(Bsr a, const float* __restrict__ x,
                     const float* __restrict__ w, const float* __restrict__ b,
                     float* __restrict__ out, int d, int ds, int64_t w_rs,
                     int64_t w_cs, int tiles_per_block) {
  extern __shared__ float ah_s[];       // [kBM][ds]: the tile's A·X
  __shared__ float a_s[kBM][kBK + 1];
  __shared__ float t_s[kBK][kBN];       // X chunk (phase 1) or W chunk (phase 2)
  const int rb = blockIdx.x / tiles_per_block;
  const int r0 = (blockIdx.x % tiles_per_block) * kBM;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;

  // Phase 1: ah_s = (A · X)[tile rows, :]
  for (int c0 = 0; c0 < d; c0 += kBN) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    slab(a, x, d, rb, r0, c0, a_s, t_s, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c < d) ah_s[ty * ds + c] = acc[j];
    }
  }
  __syncthreads();

  // Phase 2: out = relu(ah_s · W + b)
  const int64_t row = (int64_t)rb * a.block + r0 + ty;
  for (int c0 = 0; c0 < d; c0 += kBN) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int m0 = 0; m0 < d; m0 += kBK) {
      for (int i = tid; i < kBK * kBN; i += kThreads) {
        const int r = i / kBN, c = i % kBN;
        const int gr = m0 + r, gc = c0 + c;
        t_s[r][c] = (gr < d && gc < d) ? w[gr * w_rs + gc * w_cs] : 0.0f;
      }
      __syncthreads();
      const int m_end = min(kBK, d - m0);
      for (int mm = 0; mm < m_end; ++mm) {
        const float av = ah_s[ty * ds + m0 + mm];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j] = fmaf(av, t_s[mm][tx * 4 + j], acc[j]);
        }
      }
      __syncthreads();
    }
    if (r0 + ty < a.block && row < a.n_rows) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx * 4 + j;
        if (c < d) out[row * d + c] = fmaxf(acc[j] + b[c], 0.0f);
      }
    }
  }
}

}  // namespace

// Both entries launch on `stream`, allocate nothing and do not synchronise,
// and return cudaGetLastError() (0 when the launch was accepted).
extern "C" int ndcn_bsr_spmm_f32(const void* row_ptr, const void* block_cols,
                                 const void* blocks, const void* x, void* y,
                                 int n_row_blocks, int block, int n_rows,
                                 int n_cols, int d, void* stream) {
  if (n_row_blocks > 0 && block > 0 && d > 0) {
    const Bsr a{(const int32_t*)row_ptr, (const int32_t*)block_cols,
                (const float*)blocks, block, n_rows, n_cols};
    const int tiles = (block + kBM - 1) / kBM;
    const dim3 grid(n_row_blocks * tiles, (d + kBN - 1) / kBN);
    bsr_spmm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        a, (const float*)x, (float*)y, d, tiles);
  }
  return (int)cudaGetLastError();
}

// w may be strided (nn.Linear's weight transposed is a view): element (i, j)
// of W is w[i * w_rs + j * w_cs].
extern "C" int ndcn_bsr_fused_rhs_f32(const void* row_ptr,
                                      const void* block_cols,
                                      const void* blocks, const void* x,
                                      const void* w, const void* b, void* out,
                                      int n_row_blocks, int block, int n_rows,
                                      int n_cols, int d, long long w_rs,
                                      long long w_cs, void* stream) {
  if (n_row_blocks > 0 && block > 0 && d > 0) {
    const Bsr a{(const int32_t*)row_ptr, (const int32_t*)block_cols,
                (const float*)blocks, block, n_rows, n_cols};
    const int ds = (d % 2 == 0) ? d + 1 : d;  // odd stride: rows in distinct banks
    const size_t smem = sizeof(float) * (size_t)kBM * ds;
    if (smem > 32 * 1024) {
      // beyond the default 48 KB (with the static tiles) only after opt-in
      cudaError_t err = cudaFuncSetAttribute(
          bsr_fused_rhs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const int tiles = (block + kBM - 1) / kBM;
    bsr_fused_rhs_kernel<<<n_row_blocks * tiles, kThreads, smem,
                           (cudaStream_t)stream>>>(
        a, (const float*)x, (const float*)w, (const float*)b, (float*)out, d,
        ds, (int64_t)w_rs, (int64_t)w_cs, tiles);
  }
  return (int)cudaGetLastError();
}
