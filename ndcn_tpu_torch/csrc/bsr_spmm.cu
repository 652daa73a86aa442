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
// - K4: one CTA per tile of 16 or 32 rows of a row block, for ALL of d,
//   on the tensor cores: mma_split.cuh's fused_panel, which K2 shares. The
//   depth chunks of phase 1 are the (nonzero block, chunk of its columns)
//   pairs of the row block in storage order, so each stored block is staged
//   once per tile (through the cp.async ring, with the matching rows of X),
//   not once per 32-column slab; the tile's A·X stays in shared memory and
//   phase 2 is K2's: the panel times W (W may be strided), plus b, relu.
//
// K3's arithmetic is fp32 FMA; K4's is the split-TF32 product (three tensor
// core passes, fp32 sums), both for the TPU kernels' Precision.HIGHEST. Every
// sum has a fixed order and no atomics are used, so results repeat bit for
// bit, which the adaptive controller's NFE needs. Ragged edges (B not a
// multiple of the tile, n not a multiple of B, d not a multiple of 8) are
// masked or zero-filled in the loads and masked in the stores; nothing is
// padded in device memory.
//
// Bound: at the NDCN widths (d = 20) launch latency. K3 at large d: the
// CUDA-core FMA rate, with each block tile read from L2 once per 32-column
// slab. K4 at large d: 3 · 2 · (nnzb·B² + n·d) · d tensor-core operations;
// its blocks and X come from L2 (a 2000-node matrix is 16 MB), and what the
// design does about the few row blocks of such a matrix is the narrow tile:
// 16 rows give 8 CTAs a row block (128 at 2000 nodes) where 32 gave 64. The
// other way, d split over a cluster's CTAs with the panel read through
// distributed shared memory, is not taken. What holds K4 back at d = 512:
// every CTA stages all of W, and nn.Linear's transposed view of it goes 4
// bytes a copy (1024 copies a thread).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_split.cuh"

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

// Chunk c of a row tile: nonzero block c / chunks_per_block of the row block,
// columns [kc, kc + bk) of the tile's rows in it, and the matching rows of X.
struct BsrSource {
  Bsr a;
  const float* x;
  int d, bk, chunks_per_block;
  int s0;   // the row block's first stored block
  int r0;   // the tile's first row inside the row block
  __device__ __forceinline__ int depth(int c) const {
    return min(bk, a.block - (c % chunks_per_block) * bk);
  }
  __device__ __forceinline__ ndcn::Chunk chunk(int c) const {
    const int s = s0 + c / chunks_per_block;
    const int kc = (c % chunks_per_block) * bk;
    const int B = a.block;
    const int64_t xrow = (int64_t)a.block_cols[s] * B + kc;
    const int x_rows = (int)max((int64_t)0, min((int64_t)depth(c),
                                                a.n_cols - xrow));
    return ndcn::Chunk{a.blocks + ((int64_t)s * B + r0) * B + kc, B,
                       B - r0, depth(c), x_rows > 0 ? x + xrow * d : x,
                       x_rows};
  }
};

template <int MT, int NT>
__global__ void __launch_bounds__(ndcn::kMmaThreads)
bsr_fused_rhs_kernel(Bsr a, const float* __restrict__ x,
                     const float* __restrict__ w, const float* __restrict__ b,
                     float* __restrict__ out, ndcn::Layout L, int64_t w_rs,
                     int64_t w_cs, int tiles_per_block, bool a_vec, bool x_vec,
                     bool w_vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BM = 16 * MT;
  const int rb = blockIdx.x / tiles_per_block;
  const int r0 = (blockIdx.x % tiles_per_block) * BM;
  const int s0 = a.row_ptr[rb];
  const int chunks_per_block = (a.block + L.bk - 1) / L.bk;
  const BsrSource src{a, x, L.width, L.bk, chunks_per_block, s0, r0};
  const int64_t row0 = (int64_t)rb * a.block + r0;
  const int rows = (int)max((int64_t)0, min((int64_t)min(BM, a.block - r0),
                                            a.n_rows - row0));
  ndcn::fused_panel<MT, NT>(smem, L, src,
                            (a.row_ptr[rb + 1] - s0) * chunks_per_block, a_vec,
                            x_vec, w, w_rs, w_cs, w_vec, b,
                            out + row0 * L.width, rows);
}

template <int MT, int NT>
int launch_fused(const Bsr& a, const float* x, const float* w, const float* b,
                 float* out, int n_row_blocks, const ndcn::Layout& L,
                 size_t smem, int64_t w_rs, int64_t w_cs,
                 cudaStream_t stream) {
  auto kernel = bsr_fused_rhs_kernel<MT, NT>;
  if (smem > 48 * 1024) {  // beyond the default only after opt-in
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = (a.block + 16 * MT - 1) / (16 * MT);
  kernel<<<n_row_blocks * tiles, ndcn::kMmaThreads, smem, stream>>>(
      a, x, w, b, out, L, w_rs, w_cs, tiles,
      a.block % 4 == 0 && ndcn::aligned16(a.blocks),
      L.width % 4 == 0 && ndcn::aligned16(x),
      ndcn::w_vec(w, w_rs, w_cs));
  return (int)cudaGetLastError();
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
// of W is w[i * w_rs + j * w_cs]. rows, nt, wn, bk and smem_bytes are the
// host's plan (tile height, n8 tiles a warp, warps across the columns, chunk
// depth, dynamic shared memory); a plan the kernel does not take returns
// cudaErrorInvalidValue.
extern "C" int ndcn_bsr_fused_rhs_f32(const void* row_ptr,
                                      const void* block_cols,
                                      const void* blocks, const void* x,
                                      const void* w, const void* b, void* out,
                                      int n_row_blocks, int block, int n_rows,
                                      int n_cols, int d, long long w_rs,
                                      long long w_cs, int rows, int nt, int wn,
                                      int bk, long long smem_bytes,
                                      void* stream) {
  if (n_row_blocks <= 0 || block <= 0 || d <= 0) {
    return (int)cudaGetLastError();
  }
  const Bsr a{(const int32_t*)row_ptr, (const int32_t*)block_cols,
              (const float*)blocks, block, n_rows, n_cols};
  ndcn::Layout L;
  size_t smem = 0;
  if (!ndcn::make_layout(&L, &smem, rows, nt, wn, bk, d) ||
      (long long)smem != smem_bytes) {
    return (int)cudaErrorInvalidValue;
  }
#define NDCN_K4_CASE(MT, NT)                                                  \
  if (rows == 16 * MT && nt == NT)                                            \
    return launch_fused<MT, NT>(a, (const float*)x, (const float*)w,          \
                                (const float*)b, (float*)out, n_row_blocks,   \
                                L, smem, (int64_t)w_rs, (int64_t)w_cs,        \
                                (cudaStream_t)stream)
  NDCN_K4_CASE(1, 4);
  NDCN_K4_CASE(2, 4);
  NDCN_K4_CASE(1, 8);
  NDCN_K4_CASE(2, 8);
  NDCN_K4_CASE(1, 16);
#undef NDCN_K4_CASE
  return (int)cudaErrorInvalidValue;
}
