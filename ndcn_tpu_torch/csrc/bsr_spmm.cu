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
// block in a loop of its own. Both run mma_split.cuh's tile product on the
// tensor cores, which K2 shares: the depth chunks are the (nonzero block,
// chunk of its columns) pairs of the row block in storage order, each staged
// once per row tile through the cp.async ring with the matching rows of X,
// and multiplied in split TF32 (three tensor-core passes, fp32 sums folded
// chunk by chunk) for the TPU kernels' Precision.HIGHEST.
//
// - K3: one CTA per (row tile of 16 or 32 rows of a row block, column slab
//   of X), gridDim.y over the slabs: panel_product leaves the tile's A·X for
//   the slab in shared memory, and a warp a row stores it, coalesced. A
//   slab is up to 256 columns (8 warps of 4 n8 tiles, the one warp layout
//   built here), so any d is taken. The host's plan
//   (kernels/bsr_spmm.py::bsr_spmm_plan, from a sweep on the card) cuts
//   them at 128 and narrower, and takes 32-row tiles, until the CTAs
//   number one an SM: a CTA's time is a chain of chunk copies, so CTAs in
//   flight are what shortens a call. Each slab stages the row block's
//   nonzero blocks again: A is read once per slab, from L2 after the
//   first.
// - K4: one CTA per tile of 16 or 32 rows of a row block, for ALL of d:
//   fused_panel, whose phase 1 is K3's panel product; the tile's A·X stays
//   in shared memory and phase 2 is K2's: the panel times W (W may be
//   strided), plus b, relu.
//
// Replicas (the batched entries): R row-major X (R, n_cols, d) against the
// one shared A, in one launch; K4 also with R own W and b. The replica is
// gridDim.z for K3 (y is its slabs) and gridDim.y for K4; a CTA offsets X,
// Y (W, b) by its replica's strides and does exactly the work of a
// one-replica launch on that slice, so each replica is bit-equal to its own
// launch. A's blocks are staged once per replica, from L2 after the first.
//
// K3's replica groups (bsr_spmm_group_kernel), for the batched form where
// the one-replica plan has all 8 warps split the depth of a chunk (wn = 1:
// slabs of up to 32 columns, the NDCN and classification hidden widths).
// There a replica's CTAs stage every nonzero block of their row block
// through the ring, and at R replicas A's blocks are staged R times (cora:
// 468 blocks, 30.7 MB, 25 times at R = 25) while each CTA's X chunk is a
// 16-column sliver. Here a CTA takes a row tile and a group of replicas:
// it stages each chunk of A once and the group's X chunks side by side
// (replica g's columns at g · rep_cols, rep_cols the slab rounded up to 4),
// and the warps multiply the A tile into all of them at once, so the group
// reads A once. Per output element nothing changes: the chunk depth and
// order and the warps' depth split are the one-replica plan's, each warp
// takes the same k8 steps of each chunk into a fragment that starts at
// zero, and the depth split is folded in warp order; a replica's values
// are therefore bit-equal to its own one-replica launch (the panel's
// height and the columns beside it do not enter a value's sum). The host's
// plan (kernels/bsr_spmm.py::bsr_batched_plan) sets the group, the panel
// (32 rows and 8 n8 tiles a warp, or 16 and 16) and the shared memory;
// gridDim.z is the groups.
//
// Every sum has a fixed order and no atomics are used, so results repeat bit
// for bit, which the adaptive controller's NFE needs. Ragged edges (B not a
// multiple of the tile or chunk, n not a multiple of B, d not a multiple of 4
// or of the slab) are zero-filled in the staging copies and masked in the
// stores; nothing is padded in device memory. A row block with no stored
// block gives zero rows.
//
// Bound: K3 and K4 move nnzb·B² + (n_cols + n_rows)·d floats and do
// 3 · 2 · nnzb·B²·d tensor-core operations (K4 another 3 · 2 · n·d² for
// W); at the NDCN widths (d = 20) neither: the launch and a chain of
// dependent chunk copies a CTA (the ring keeps one chunk in flight), as
// many as the row block has nonzero blocks times B / bk. The blocks and X
// come from L2 (a 2000-node matrix is 16 MB). What the design does about the
// few row blocks of such a matrix is the narrow tile (16 rows give 8 CTAs a
// row block) and, for K3, the column slabs; the other way, A·X's depth split
// over a cluster's CTAs and folded through distributed shared memory, is
// not taken. What holds K4 back at d = 512: every CTA stages all of W, and
// nn.Linear's transposed view of it goes 4 bytes a copy (1024 copies a
// thread).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_split.cuh"

namespace {

// n8 tiles a warp keeps for K3: with 8 warps across the columns a slab of up
// to 256 (the plan never asks for another)
constexpr int kSpmmNt = 4;

struct Bsr {
  const int32_t* row_ptr;     // (n_row_blocks + 1,)
  const int32_t* block_cols;  // (nnzb,)
  const float* blocks;        // (nnzb, B, B)
  int block;                  // B
  int n_rows, n_cols;
};

// Chunk c of a row tile: nonzero block c / chunks_per_block of the row block,
// columns [kc, kc + bk) of the tile's rows in it, and the matching rows of X
// (x: the slab's first column of row 0; d: X's row stride).
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
                       B - r0, depth(c), x_rows > 0 ? x + xrow * d : x, d,
                       x_rows};
  }
};

template <int MT>
__global__ void __launch_bounds__(ndcn::kMmaThreads)
bsr_spmm_kernel(Bsr a, const float* __restrict__ x, float* __restrict__ y,
                ndcn::Layout L, int d, int tiles_per_block, bool a_vec,
                bool x_vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BM = 16 * MT;
  x += (int64_t)blockIdx.z * a.n_cols * d;      // the replica's X and Y
  y += (int64_t)blockIdx.z * a.n_rows * d;
  const int rb = blockIdx.x / tiles_per_block;
  const int r0 = (blockIdx.x % tiles_per_block) * BM;
  const int c0 = blockIdx.y * L.width;          // the slab's first column
  const int x_cols = min(L.width, d - c0);
  const int s0 = a.row_ptr[rb];
  const int chunks_per_block = (a.block + L.bk - 1) / L.bk;
  const BsrSource src{a, x + c0, d, L.bk, chunks_per_block, s0, r0};
  ndcn::panel_product<MT, kSpmmNt>(
      smem, L, src, (a.row_ptr[rb + 1] - s0) * chunks_per_block, a_vec,
      x_vec, x_cols);
  const int64_t row0 = (int64_t)rb * a.block + r0;
  const int rows = (int)max((int64_t)0, min((int64_t)min(BM, a.block - r0),
                                            a.n_rows - row0));
  for (int r = threadIdx.x >> 5; r < rows; r += ndcn::kMmaWarps) {
    const float* p = smem + r * L.ldp;
    float* dst = y + (row0 + r) * d + c0;
    for (int c = threadIdx.x & 31; c < x_cols; c += 32) dst[c] = p[c];
  }
}

template <int MT, int NT>
__global__ void __launch_bounds__(ndcn::kMmaThreads)
bsr_spmm_group_kernel(Bsr a, const float* __restrict__ x,
                      float* __restrict__ y, ndcn::Layout L, int d, int slab,
                      int rep_cols, int tiles_per_block, int group,
                      int replicas, bool a_vec, bool x_vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BM = 16 * MT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int first = blockIdx.z * group;          // the group's first replica
  const int live = min(group, replicas - first);
  const int64_t x_rs = (int64_t)a.n_cols * d;    // one replica's X, Y
  const int64_t y_rs = (int64_t)a.n_rows * d;
  const int rb = blockIdx.x / tiles_per_block;
  const int r0 = (blockIdx.x % tiles_per_block) * BM;
  const int c0 = blockIdx.y * slab;              // the slab's first column
  const int x_cols = min(slab, d - c0);
  const int s0 = a.row_ptr[rb];
  const int chunks_per_block = (a.block + L.bk - 1) / L.bk;
  const BsrSource src{a, x + first * x_rs + c0, d, L.bk, chunks_per_block,
                      s0, r0};
  float* ring = smem + BM * L.ldp;

  // as ndcn::panel_product: the pads are zero, not garbage
  for (int i = tid; i < BM * L.ldp + ndcn::kStages * L.stage_floats;
       i += ndcn::kMmaThreads) {
    smem[i] = 0.0f;
  }
  __syncthreads();
  float acc[MT][NT][4];
  ndcn::zero_acc<MT, NT>(acc);
  ndcn::ring_loop(
      (a.row_ptr[rb + 1] - s0) * chunks_per_block,
      [&](int c, int stage) {
        float* st = ring + stage * L.stage_floats;
        const ndcn::Chunk ch = src.chunk(c);   // ch.x: replica `first`'s
        if (ch.depth == L.bk && ch.x_rows == L.bk) {
          ndcn::stage_tile_whole(st, L.lda, ch.a, ch.a_ld, ch.a_rows, L.bk,
                                 BM, a_vec);
          for (int g = 0; g < live; ++g) {
            ndcn::stage_tile_whole(st + BM * L.lda + g * rep_cols, L.ldb,
                                   ch.x + g * x_rs, ch.x_ld, L.bk, x_cols,
                                   L.bk, x_vec);
          }
        } else {   // a ragged chunk, zero filled as deep as it is read
          const int deep = (ch.depth + 7) & ~7;
          ndcn::stage_tile(st, L.lda, ch.a, ch.a_ld, ch.a_rows, ch.depth, BM,
                           deep, a_vec);
          for (int g = 0; g < live; ++g) {
            ndcn::stage_tile(st + BM * L.lda + g * rep_cols, L.ldb,
                             ch.x + g * x_rs, ch.x_ld, ch.x_rows, x_cols,
                             deep, rep_cols, x_vec);
          }
        }
      },
      [&](int c, int stage) {
        // warp w takes the k8 steps w, w + 8, ... of the chunk, as in the
        // one-replica plan (wn = 1), across the whole group's columns
        const float* st = ring + stage * L.stage_floats;
        ndcn::chunk_mma<MT, NT>(acc, st, L.lda, st + BM * L.lda, L.ldb, warp,
                                ndcn::kMmaWarps, (src.depth(c) + 7) >> 3,
                                lane);
      });
  ndcn::store_acc<MT, NT>(acc, ndcn::warp_tile<MT, NT>(smem, L, warp), L.ldp,
                          lane);
  ndcn::fold_panel<MT>(smem, L);
  const int64_t row0 = (int64_t)rb * a.block + r0;
  const int rows = (int)max((int64_t)0, min((int64_t)min(BM, a.block - r0),
                                            a.n_rows - row0));
  for (int r = warp; r < rows; r += ndcn::kMmaWarps) {
    for (int g = 0; g < live; ++g) {
      const float* p = smem + r * L.ldp + g * rep_cols;
      float* dst = y + (first + g) * y_rs + (row0 + r) * d + c0;
      for (int c = lane; c < x_cols; c += 32) dst[c] = p[c];
    }
  }
}

template <int MT, int NT>
__global__ void __launch_bounds__(ndcn::kMmaThreads)
bsr_fused_rhs_kernel(Bsr a, const float* __restrict__ x,
                     const float* __restrict__ w, const float* __restrict__ b,
                     float* __restrict__ out, ndcn::Layout L, int64_t w_rs,
                     int64_t w_cs, int tiles_per_block, bool a_vec, bool x_vec,
                     bool w_vec, int64_t w_bs) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BM = 16 * MT;
  const int64_t rep = blockIdx.y;  // the replica: its X, W, b and output
  x += rep * a.n_cols * L.width;
  w += rep * w_bs;
  b += rep * L.width;
  out += rep * a.n_rows * L.width;
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

// beyond the default 48 KB of dynamic shared memory only after opt-in
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int MT>
int launch_spmm(const Bsr& a, const float* x, float* y, int n_row_blocks,
                int d, const ndcn::Layout& L, size_t smem, int replicas,
                cudaStream_t stream) {
  auto kernel = bsr_spmm_kernel<MT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.block + 16 * MT - 1) / (16 * MT);
  const dim3 grid(n_row_blocks * tiles, (d + L.width - 1) / L.width,
                  replicas);
  kernel<<<grid, ndcn::kMmaThreads, smem, stream>>>(
      a, x, y, L, d, tiles, a.block % 4 == 0 && ndcn::aligned16(a.blocks),
      d % 4 == 0 && ndcn::aligned16(x));
  return (int)cudaGetLastError();
}

template <int MT, int NT>
int launch_group(const Bsr& a, const float* x, float* y, int n_row_blocks,
                 int d, int slab, int rep_cols, const ndcn::Layout& L,
                 size_t smem, int replicas, int group, cudaStream_t stream) {
  auto kernel = bsr_spmm_group_kernel<MT, NT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.block + 16 * MT - 1) / (16 * MT);
  const dim3 grid(n_row_blocks * tiles, (d + slab - 1) / slab,
                  (replicas + group - 1) / group);
  kernel<<<grid, ndcn::kMmaThreads, smem, stream>>>(
      a, x, y, L, d, slab, rep_cols, tiles, group, replicas,
      a.block % 4 == 0 && ndcn::aligned16(a.blocks),
      d % 4 == 0 && ndcn::aligned16(x));
  return (int)cudaGetLastError();
}

template <int MT, int NT>
int launch_fused(const Bsr& a, const float* x, const float* w, const float* b,
                 float* out, int n_row_blocks, const ndcn::Layout& L,
                 size_t smem, int64_t w_rs, int64_t w_cs, int replicas,
                 int64_t w_bs, cudaStream_t stream) {
  auto kernel = bsr_fused_rhs_kernel<MT, NT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.block + 16 * MT - 1) / (16 * MT);
  kernel<<<dim3(n_row_blocks * tiles, replicas), ndcn::kMmaThreads, smem,
           stream>>>(
      a, x, w, b, out, L, w_rs, w_cs, tiles,
      a.block % 4 == 0 && ndcn::aligned16(a.blocks),
      L.width % 4 == 0 && ndcn::aligned16(x),
      ndcn::w_vec(w, w_rs, w_cs) && (replicas == 1 || w_bs % 4 == 0), w_bs);
  return (int)cudaGetLastError();
}

}  // namespace

namespace {

int spmm_plan(const void* row_ptr, const void* block_cols, const void* blocks,
              const void* x, void* y, int n_row_blocks, int block, int n_rows,
              int n_cols, int d, int slab, int rows, int wn, int bk,
              long long smem_bytes, int replicas, void* stream) {
  if (n_row_blocks <= 0 || block <= 0 || d <= 0 || replicas <= 0) {
    return (int)cudaGetLastError();
  }
  const Bsr a{(const int32_t*)row_ptr, (const int32_t*)block_cols,
              (const float*)blocks, block, n_rows, n_cols};
  ndcn::Layout L;
  size_t smem = 0;
  if (replicas > 65535 || slab < 1 || slab > d ||
      (slab != d && slab % 8 != 0) ||
      !ndcn::make_layout(&L, &smem, rows, kSpmmNt, wn, bk, slab) ||
      (long long)smem != smem_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 16) {
    return launch_spmm<1>(a, (const float*)x, (float*)y, n_row_blocks, d, L,
                          smem, replicas, (cudaStream_t)stream);
  }
  return launch_spmm<2>(a, (const float*)x, (float*)y, n_row_blocks, d, L,
                        smem, replicas, (cudaStream_t)stream);
}

int group_plan(const void* row_ptr, const void* block_cols,
               const void* blocks, const void* x, void* y, int n_row_blocks,
               int block, int n_rows, int n_cols, int d, int slab, int rows,
               int nt, int bk, long long smem_bytes, int replicas, int group,
               void* stream) {
  if (n_row_blocks <= 0 || block <= 0 || d <= 0 || replicas <= 0) {
    return (int)cudaGetLastError();
  }
  const Bsr a{(const int32_t*)row_ptr, (const int32_t*)block_cols,
              (const float*)blocks, block, n_rows, n_cols};
  const int rep_cols = ndcn::round_up(slab, 4);
  ndcn::Layout L;
  size_t smem = 0;
  if (group < 1 || group > replicas ||
      (replicas + group - 1) / group > 65535 || slab < 1 || slab > d ||
      (slab != d && slab % 8 != 0) ||
      !ndcn::make_layout(&L, &smem, rows, nt, 1, bk, group * rep_cols) ||
      (long long)smem != smem_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 32 && nt == 8) {
    return launch_group<2, 8>(a, (const float*)x, (float*)y, n_row_blocks, d,
                              slab, rep_cols, L, smem, replicas, group,
                              (cudaStream_t)stream);
  }
  if (rows == 16 && nt == 16) {
    return launch_group<1, 16>(a, (const float*)x, (float*)y, n_row_blocks,
                               d, slab, rep_cols, L, smem, replicas, group,
                               (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

int fused_plan(const void* row_ptr, const void* block_cols,
               const void* blocks, const void* x, const void* w,
               const void* b, void* out, int n_row_blocks, int block,
               int n_rows, int n_cols, int d, long long w_rs, long long w_cs,
               int rows, int nt, int wn, int bk, long long smem_bytes,
               int replicas, long long w_bs, void* stream) {
  if (n_row_blocks <= 0 || block <= 0 || d <= 0 || replicas <= 0) {
    return (int)cudaGetLastError();
  }
  const Bsr a{(const int32_t*)row_ptr, (const int32_t*)block_cols,
              (const float*)blocks, block, n_rows, n_cols};
  ndcn::Layout L;
  size_t smem = 0;
  if (replicas > 65535 || !ndcn::make_layout(&L, &smem, rows, nt, wn, bk, d) ||
      (long long)smem != smem_bytes) {
    return (int)cudaErrorInvalidValue;
  }
#define NDCN_K4_CASE(MT, NT)                                                  \
  if (rows == 16 * MT && nt == NT)                                            \
    return launch_fused<MT, NT>(a, (const float*)x, (const float*)w,          \
                                (const float*)b, (float*)out, n_row_blocks,   \
                                L, smem, (int64_t)w_rs, (int64_t)w_cs,        \
                                replicas, (int64_t)w_bs,                      \
                                (cudaStream_t)stream)
  NDCN_K4_CASE(1, 4);
  NDCN_K4_CASE(2, 4);
  NDCN_K4_CASE(1, 8);
  NDCN_K4_CASE(2, 8);
  NDCN_K4_CASE(1, 16);
#undef NDCN_K4_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Every entry launches on `stream`, allocates nothing and does not
// synchronise, and returns cudaGetLastError() (0 when the launch was
// accepted). rows, nt, wn, bk and smem_bytes are the host's plan (tile
// height, n8 tiles a warp, warps across the columns, chunk depth, dynamic
// shared memory); a plan the kernel does not take returns
// cudaErrorInvalidValue.

// slab: the columns of X one CTA takes (the plan's slab; gridDim.y is
// ceil(d / slab)): all of d, or whole n8 tiles, so that every slab starts on
// a 16-byte boundary of X's rows. K3 is built for kSpmmNt n8 tiles a warp
// and takes no nt.
extern "C" int ndcn_bsr_spmm_f32(const void* row_ptr, const void* block_cols,
                                 const void* blocks, const void* x, void* y,
                                 int n_row_blocks, int block, int n_rows,
                                 int n_cols, int d, int slab, int rows, int wn,
                                 int bk, long long smem_bytes, void* stream) {
  return spmm_plan(row_ptr, block_cols, blocks, x, y, n_row_blocks, block,
                   n_rows, n_cols, d, slab, rows, wn, bk, smem_bytes, 1,
                   stream);
}

// The batched K3: x is `replicas` row-major (n_cols, d) states one after
// another, y `replicas` (n_rows, d).
extern "C" int ndcn_bsr_spmm_batched_f32(
    const void* row_ptr, const void* block_cols, const void* blocks,
    const void* x, void* y, int n_row_blocks, int block, int n_rows,
    int n_cols, int d, int slab, int rows, int wn, int bk,
    long long smem_bytes, int replicas, void* stream) {
  return spmm_plan(row_ptr, block_cols, blocks, x, y, n_row_blocks, block,
                   n_rows, n_cols, d, slab, rows, wn, bk, smem_bytes,
                   replicas, stream);
}

// The batched K3 in replica groups (the layout of the entry above): `group`
// replicas a CTA, gridDim.z = ceil(replicas / group); slab and bk are the
// one-replica plan's, rows and nt the group's panel (32 rows and 8 n8 tiles
// a warp, or 16 and 16), smem_bytes its shared memory.
extern "C" int ndcn_bsr_spmm_grouped_f32(
    const void* row_ptr, const void* block_cols, const void* blocks,
    const void* x, void* y, int n_row_blocks, int block, int n_rows,
    int n_cols, int d, int slab, int rows, int nt, int bk,
    long long smem_bytes, int replicas, int group, void* stream) {
  return group_plan(row_ptr, block_cols, blocks, x, y, n_row_blocks, block,
                    n_rows, n_cols, d, slab, rows, nt, bk, smem_bytes,
                    replicas, group, stream);
}

// w may be strided (nn.Linear's weight transposed is a view): element (i, j)
// of W is w[i * w_rs + j * w_cs].
extern "C" int ndcn_bsr_fused_rhs_f32(const void* row_ptr,
                                      const void* block_cols,
                                      const void* blocks, const void* x,
                                      const void* w, const void* b, void* out,
                                      int n_row_blocks, int block, int n_rows,
                                      int n_cols, int d, long long w_rs,
                                      long long w_cs, int rows, int nt, int wn,
                                      int bk, long long smem_bytes,
                                      void* stream) {
  return fused_plan(row_ptr, block_cols, blocks, x, w, b, out, n_row_blocks,
                    block, n_rows, n_cols, d, w_rs, w_cs, rows, nt, wn, bk,
                    smem_bytes, 1, 0, stream);
}

// The batched K4: x and out are `replicas` (n, d) states one after another,
// b `replicas` rows of d, and replica r's W starts w_bs floats after
// replica r - 1's.
extern "C" int ndcn_bsr_fused_rhs_batched_f32(
    const void* row_ptr, const void* block_cols, const void* blocks,
    const void* x, const void* w, const void* b, void* out, int n_row_blocks,
    int block, int n_rows, int n_cols, int d, long long w_rs, long long w_cs,
    int rows, int nt, int wn, int bk, long long smem_bytes, int replicas,
    long long w_bs, void* stream) {
  return fused_plan(row_ptr, block_cols, blocks, x, w, b, out, n_row_blocks,
                    block, n_rows, n_cols, d, w_rs, w_cs, rows, nt, wn, bk,
                    smem_bytes, replicas, w_bs, stream);
}
