// The product A · X for one panel of rows (panel_product) and the fused
// right-hand side relu((A · X) · W + b) built on it (fused_panel), on the
// tensor cores with fp32 answers. K2 (dense A, fused_rhs.cu) and K4
// (block-sparse A, bsr_spmm.cu) run fused_panel, K3 (bsr_spmm.cu) runs
// panel_product over a column slab of X; they differ only in how a depth
// chunk of A and X is found (their `Source`).
//
// The tile product is a split-TF32 product. Each fp32 operand is split in
// registers into hi = tf32(x) (cvt.rna, 10 mantissa bits) and
// lo = tf32(x - hi); three mma.sync.m16n8k8 tf32 products lo·hi + hi·lo +
// hi·hi go into one fp32 fragment (lo·lo is below fp32's last bit). This is
// what Precision.HIGHEST does on the TPU's matrix unit with bf16 passes, and
// it keeps max|Δ| / max|y| <= 1e-5 against the plain fp32 version. One TF32
// pass would keep three digits and does not.
//
// The tensor core adds into its fp32 accumulator by truncation, so a sum
// chained through thousands of mma steps drifts low by more than 1e-5 on
// inputs of one sign. The products of one staged chunk are therefore chained
// into a fragment that starts at zero, and that fragment is added to the
// running sum with a rounded fp32 add on the CUDA cores: the truncations
// then act on a chunk's share of the sum, not on the sum. (Compiled with
// NDCN_MMA_CHAINED the running sum is the mma accumulator itself: the variant
// that tools/probe_mma_accumulate.py measures, built by nothing else.)
//
// One CTA of 8 warps owns a panel of 16·MT rows for ALL columns (K3: for its
// slab of them), so A is read from device memory once (K3: once a slab).
// The running sums stay in registers. The warps split the columns (wn of
// them, NT n8-tiles each; a warp wholly beyond the width only helps with
// the copies) and, where the panel is narrow, the depth of a chunk (wk =
// 8 / wn of them, folded in warp order through shared memory at the end of
// a phase). A tiles and X chunks arrive
// through a ring of two shared-memory stages filled by cp.async (16-byte copies
// where the source allows; a whole chunk copies only its valid pieces into a
// stage whose pads were zeroed once, a ragged one zero-fills) while the
// tensor cores work on the stage before. The finished A·X panel goes to shared
// memory, never to device memory, and runs through the same loop against W,
// whose chunks take the ring's place; then + b, relu and a coalesced store.
//
// Shared-memory row strides keep fragment loads free of bank conflicts: 4 mod
// 32 (an odd multiple of 4) for the operand read along rows (the A tile, the
// panel), 8 mod 32 for the operand read along depth (X and W chunks).
//
// Every sum has a fixed order and there are no atomics: two calls on the same
// inputs agree bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ndcn {

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr size_t kSmemLimit = 232448;  // 227 KB: what one block may use
// The ring's depth. Deeper rings were measured and won at no shape: what a
// chunk costs is its fixed part, which deeper chunks cut and more stages do
// not, and a third stage takes the room of a deeper chunk.
constexpr int kStages = 2;

// Shapes of one launch, worked out on the host (make_layout) from the plan
// that the Python wrapper chose.
struct Layout {
  int width;         // columns of X, of the panel, of W and of the output
  int cols;          // width rounded up to whole warps' shares (8·nt columns)
  int bk;            // depth of one staged chunk
  int wn, wk;        // warps across the columns, and across a chunk's depth
  int lda, ldb, ldp; // row strides of the A tile, the X / W chunk, the panel
  int stage_floats;  // one ring stage: the A tile, then the chunk
};

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Fills `layout` and the dynamic shared memory it needs; false if the plan
// is not one the kernels take or does not fit a block.
inline bool make_layout(Layout* layout, size_t* smem_bytes, int rows, int nt,
                        int wn, int bk, int width) {
  if (wn != 1 && wn != 2 && wn != 4 && wn != 8) return false;
  const int wk = kMmaWarps / wn;
  if ((rows != 16 && rows != 32) || bk < 8 * wk || bk % (8 * wk) != 0 ||
      bk > 128 || width < 1 || wn * nt * 8 < width) {
    return false;
  }
  Layout& l = *layout;
  l.width = width;
  l.cols = round_up(width, 8 * nt);
  l.bk = bk;
  l.wn = wn;
  l.wk = wk;
  l.lda = bk + 4;
  l.ldb = round_up(l.cols, 32) + 8;
  const int depth2 = round_up(width, bk);  // the panel's columns as depth
  l.ldp = round_up(l.cols > depth2 ? l.cols : depth2, 32) + 4;
  // a chunk of X or W is (bk x ldb); a chunk of a transposed W is staged as
  // it lies in memory, (cols x lda)
  const int chunk = bk * l.ldb > l.cols * l.lda ? bk * l.ldb : l.cols * l.lda;
  l.stage_floats = rows * l.lda + chunk;
  const size_t panel = (size_t)rows * l.ldp;
  const size_t ring = (size_t)kStages * l.stage_floats;
  const size_t scratch = (size_t)(wk - 1) * rows * l.ldp;
  *smem_bytes = sizeof(float) * (panel + (ring > scratch ? ring : scratch));
  return *smem_bytes <= kSmemLimit;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Whether W's staged runs (its rows, or its columns for a transposed view)
// take 16-byte copies.
inline bool w_vec(const void* w, int64_t w_rs, int64_t w_cs) {
  const int64_t run_stride = w_cs == 1 ? w_rs : w_cs;
  return (w_cs == 1 || w_rs == 1) && run_stride % 4 == 0 && aligned16(w);
}

// One staged depth chunk of phase 1.
struct Chunk {
  const float* a;   // the A tile: panel row 0, the chunk's first depth column
  int64_t a_ld;     // A's row stride
  int a_rows;       // valid rows of the tile (of 16·MT); the rest is zero
  int depth;        // valid depth columns (of bk); the rest is zero
  const float* x;   // the X chunk: its first row, the slab's first column
  int64_t x_ld;     // X's row stride
  int x_rows;       // valid rows (of bk); the rest is zero
};

#ifdef __CUDACC__

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// c (16 x 8) += a (16 x 8, row) · b (8 x 8, col), TF32 operands, fp32 sum.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Asynchronous copies into shared memory; `bytes` of the source are read
// (0: none) and the rest of the destination is zero.
__device__ __forceinline__ void cp_async_4(float* dst, const float* src,
                                           int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_16(float* dst, const float* src,
                                            int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

// Whole copies to a shared-memory address (as cvta gives it).
__device__ __forceinline__ void cp_async_16_whole(uint32_t dst,
                                                  const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_4_whole(uint32_t dst,
                                                 const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until every copy this thread has committed has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// ceil(log2(x)) for 1 <= x, at most 5: how many lanes (a power of two, up to
// a warp) share one row of a staged tile.
__device__ __forceinline__ int lanes_shift(int x) {
  return min(5, 32 - __clz(max(x, 1) - 1));
}

// Stage the valid (rows x cols) part of a row-major tile at src (row stride
// ld_src) into the (tile_rows x tile_cols) tile at dst (row stride ld_dst),
// zero elsewhere. tile_cols is a multiple of 4. `vec`: src is 16-byte aligned
// and ld_src a multiple of 4, so a row's float4s are aligned. A power of two
// of lanes shares a row and the thread groups stride over the rows, so no
// index is divided.
__device__ __forceinline__ void stage_tile(float* dst, int ld_dst,
                                           const float* __restrict__ src,
                                           int64_t ld_src, int rows, int cols,
                                           int tile_rows, int tile_cols,
                                           bool vec) {
  const int units = vec ? tile_cols >> 2 : tile_cols;  // copies a row
  const int sh = lanes_shift(units);
  const int lanes = 1 << sh;
  const int u0 = threadIdx.x & (lanes - 1);
  for (int r = threadIdx.x >> sh; r < tile_rows; r += kMmaThreads >> sh) {
    float* drow = dst + r * ld_dst;
    const float* srow = src + (int64_t)r * ld_src;
    if (vec) {
      for (int u = u0; u < units; u += lanes) {
        const int c = u << 2;
        const int left = (r < rows) ? min(4, cols - c) : 0;
        cp_async_16(drow + c, left > 0 ? srow + c : src,
                    left > 0 ? 4 * left : 0);
      }
    } else {
      for (int c = u0; c < units; c += lanes) {
        const bool ok = r < rows && c < cols;
        cp_async_4(drow + c, ok ? srow + c : src, ok ? 4 : 0);
      }
    }
  }
}

// The same tile for a whole chunk: its first `rows` rows are valid over all
// of `cols` (with `vec`, a multiple of 4) and the rest of the destination
// already holds zeros. Only the valid pieces are copied, with one pointer
// step a copy: this is the copy of all but a ragged last chunk, so its
// address arithmetic is kept out of the loop.
__device__ __forceinline__ void stage_tile_whole(float* dst, int ld_dst,
                                                 const float* __restrict__ src,
                                                 int64_t ld_src, int rows,
                                                 int cols, int tile_rows,
                                                 bool vec) {
  const int units = vec ? cols >> 2 : cols;   // copies a valid row
  const int sh = lanes_shift(units);
  const int lanes = 1 << sh;
  const int step = kMmaThreads >> sh;
  const int r0 = threadIdx.x >> sh;
  const int last = min(rows, tile_rows);
  for (int u = threadIdx.x & (lanes - 1); u < units; u += lanes) {
    const int c = vec ? u << 2 : u;
    uint32_t d = (uint32_t)__cvta_generic_to_shared(dst + r0 * ld_dst + c);
    const float* s = src + (int64_t)r0 * ld_src + c;
    const uint32_t d_step = (uint32_t)(step * ld_dst) * sizeof(float);
    const int64_t s_step = (int64_t)step * ld_src;
    if (!vec) {
      for (int r = r0; r < last; r += step, d += d_step, s += s_step) {
        cp_async_4_whole(d, s);
      }
    } else {
      for (int r = r0; r < last; r += step, d += d_step, s += s_step) {
        cp_async_16_whole(d, s);
      }
    }
  }
}

// Stage rows [i0, i0 + bk) of W (element (i, j) at w[i·w_rs + j·w_cs]), zero
// beyond W's edge (down to the next multiple of 8 rows: no k8 step reads
// further). A W whose columns are contiguous lands as a (bk x tile_cols)
// tile, row stride ld_dst. A transposed view (nn.Linear's weight: w_rs == 1)
// is copied as it lies in memory, a column of W a row of the tile (tile_cols
// x bk, row stride ld_t), and chunk_mma reads it transposed. Any other
// strides go 4 bytes a copy into the first form.
__device__ __forceinline__ void stage_w(float* dst, int ld_dst, int ld_t,
                                        const float* __restrict__ w,
                                        int64_t w_rs, int64_t w_cs, int i0,
                                        int width, int bk, int tile_cols,
                                        bool vec) {
  const int rows = min(bk, width - i0);
  bk = min(bk, (rows + 7) & ~7);   // as deep as the k8 steps that are read
  if (w_cs == 1) {
    stage_tile(dst, ld_dst, w + (int64_t)i0 * w_rs, w_rs, rows, width, bk,
               tile_cols, vec);
    return;
  }
  if (w_rs == 1) {
    stage_tile(dst, ld_t, w + i0, w_cs, width, rows, tile_cols, bk, vec);
    return;
  }
  const int sh = lanes_shift(bk);   // bk is a power of two, 8 to 128
  const int lanes = 1 << sh;
  const int i_first = threadIdx.x & (lanes - 1);
  for (int j = threadIdx.x >> sh; j < tile_cols; j += kMmaThreads >> sh) {
    for (int i = i_first; i < bk; i += lanes) {
      const bool ok = i < rows && j < width;
      cp_async_4(dst + i * ld_dst + j,
                 ok ? w + (int64_t)(i0 + i) * w_rs + (int64_t)j * w_cs : w,
                 ok ? 4 : 0);
    }
  }
}

// Chunks 0 .. nchunks-1 through the ring's two stages: load(c, s) issues
// chunk c's copies into stage s = c % 2 and compute(c, s) works on it while
// chunk c + 1 is in flight. One barrier a chunk: it publishes chunk c and
// frees the stage that chunk c - 1 used, which the next load overwrites.
// Ends with every copy landed and a barrier.
template <class Load, class Compute>
__device__ __forceinline__ void ring_loop(int nchunks, Load load,
                                          Compute compute) {
  static_assert(kStages == 2, "the loop keeps one chunk in flight");
  if (nchunks > 0) load(0, 0);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_all();
    __syncthreads();
    if (c + 1 < nchunks) load(c + 1, (c + 1) & 1);
    cp_async_commit();
    compute(c, c & 1);
  }
  cp_async_wait_all();
  __syncthreads();
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    }
  }
}

// acc += a_s (16·MT rows, row stride lda) · b_s (row stride ldb, this warp's
// first column; with BT the chunk lies transposed, a row a column, and b_s
// is this warp's first row of it) over the k8 steps ks0, ks0 + ks_step, ...
// < ks_end of one staged chunk, for the warp's NT n8 tiles. The chunk's
// products chain into a fragment that starts at zero; one rounded add folds
// it in. The three passes run as three sweeps over the warp's tiles (four
// n8 tiles at a time), so that consecutive mma do not wait for each other.
template <int MT, int NT, bool BT = false>
__device__ __forceinline__ void chunk_mma(float (&acc)[MT][NT][4],
                                          const float* __restrict__ a_s,
                                          int lda,
                                          const float* __restrict__ b_s,
                                          int ldb, int ks0, int ks_step,
                                          int ks_end, int lane) {
  constexpr int NB = NT < 4 ? NT : 4;   // n8 tiles split and multiplied at once
  const int g = lane >> 2, tig = lane & 3;
#ifdef NDCN_MMA_CHAINED
  float (&t)[MT][NT][4] = acc;
#else
  float t[MT][NT][4];
  zero_acc<MT, NT>(t);
#endif
  for (int ks = ks0; ks < ks_end; ks += ks_step) {
    float a_raw[MT][4];
    const float* ap = a_s + g * lda + ks * 8 + tig;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* p = ap + mt * 16 * lda;
      a_raw[mt][0] = p[0];
      a_raw[mt][1] = p[8 * lda];
      a_raw[mt][2] = p[4];
      a_raw[mt][3] = p[8 * lda + 4];
    }
    uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        split_tf32(a_raw[mt][i], a_hi[mt][i], a_lo[mt][i]);
      }
    }
    const float* bp = BT ? b_s + g * ldb + ks * 8 + tig
                         : b_s + (ks * 8 + tig) * ldb + g;
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += NB) {
      float b_raw[NB][2];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        b_raw[j][0] = bp[BT ? (n0 + j) * 8 * ldb : (n0 + j) * 8];
        b_raw[j][1] = bp[BT ? (n0 + j) * 8 * ldb + 4 : 4 * ldb + (n0 + j) * 8];
      }
      uint32_t b_hi[NB][2], b_lo[NB][2];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        split_tf32(b_raw[j][0], b_hi[j][0], b_lo[j][0]);
        split_tf32(b_raw[j][1], b_hi[j][1], b_lo[j][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < NB; ++j) mma_tf32(t[mt][n0 + j], a_lo[mt], b_hi[j]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < NB; ++j) mma_tf32(t[mt][n0 + j], a_hi[mt], b_lo[j]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < NB; ++j) mma_tf32(t[mt][n0 + j], a_hi[mt], b_hi[j]);
      }
    }
  }
#ifndef NDCN_MMA_CHAINED
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] += t[mt][nt][i];
    }
  }
#endif
}

// The warp's fragments to a row-major tile at dst (its first column).
template <int MT, int NT>
__device__ __forceinline__ void store_acc(const float (&acc)[MT][NT][4],
                                          float* dst, int ld, int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* p = dst + (mt * 16 + g) * ld + nt * 8 + 2 * tig;
      *reinterpret_cast<float2*>(p) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(p + 8 * ld) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// Where this warp's tile of a phase's sum goes: the panel itself for the
// first depth split, a scratch tile over the ring for the others (at the
// warp's first column).
template <int MT, int NT>
__device__ __forceinline__ float* warp_tile(float* smem, const Layout& L,
                                            int warp) {
  constexpr int BM = 16 * MT;
  const int wkk = warp / L.wn;
  float* ring = smem + BM * L.ldp;
  return (wkk == 0 ? smem : ring + (wkk - 1) * BM * L.ldp) +
         (warp % L.wn) * NT * 8;
}

// The depth-split warps' tiles into the panel, in warp order.
template <int MT>
__device__ __forceinline__ void fold_panel(float* smem, const Layout& L) {
  constexpr int BM = 16 * MT;
  const int tid = threadIdx.x;
  float* panel = smem;
  const float* ring = smem + BM * L.ldp;
  __syncthreads();
  if (L.wk > 1) {
    const int sh = lanes_shift(L.cols);
    for (int r = tid >> sh; r < BM; r += kMmaThreads >> sh) {
      for (int c = tid & ((1 << sh) - 1); c < L.cols; c += 1 << sh) {
        const int at = r * L.ldp + c;
        float v = panel[at];
        for (int s = 0; s < L.wk - 1; ++s) v += ring[s * BM * L.ldp + at];
        panel[at] = v;
      }
    }
    __syncthreads();
  }
}

// Phase 1 of a panel of 16·MT rows: panel = Σ_chunks A_chunk · X_chunk, left
// in shared memory (the panel's first x_cols columns; the rest of its L.cols
// are zero). `smem` is the block's dynamic shared memory (16-byte aligned),
// laid out as the panel (16·MT x ldp), then the ring, which the depth-split
// warps' partial tiles reuse once the copies have landed. src.chunk(c) names
// chunk c of `nchunks` and src.depth(c) is its valid depth; a_vec and x_vec
// say whether the rows of A and X take 16-byte copies (with x_vec, x_cols is
// a multiple of 4). K3 stores the panel as it is; fused_panel goes on to the
// second product.
template <int MT, int NT, class Source>
__device__ __forceinline__ void panel_product(float* smem, const Layout& L,
                                              const Source& src, int nchunks,
                                              bool a_vec, bool x_vec,
                                              int x_cols) {
  constexpr int BM = 16 * MT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wkk = warp / L.wn;      // which k8 steps of a chunk
  const int col0 = (warp % L.wn) * NT * 8;
  const bool active = col0 < L.cols;  // a warp beyond the width only copies
  float* ring = smem + BM * L.ldp;
  float* mine = warp_tile<MT, NT>(smem, L, warp);

  // the panel's pad columns are read as depth by phase 2, and the ring's pad
  // rows and columns are never copied by a whole chunk: zero, not garbage
  for (int i = tid; i < BM * L.ldp + kStages * L.stage_floats;
       i += kMmaThreads) {
    smem[i] = 0.0f;
  }
  __syncthreads();

  float acc[MT][NT][4];
  zero_acc<MT, NT>(acc);
  ring_loop(
      nchunks,
      [&](int c, int stage) {
        float* st = ring + stage * L.stage_floats;
        const Chunk ch = src.chunk(c);
        if (ch.depth == L.bk && ch.x_rows == L.bk) {
          stage_tile_whole(st, L.lda, ch.a, ch.a_ld, ch.a_rows, L.bk, BM,
                           a_vec);
          stage_tile_whole(st + BM * L.lda, L.ldb, ch.x, ch.x_ld, L.bk,
                           x_cols, L.bk, x_vec);
        } else {   // a ragged chunk: zero fill over what the stage held,
                   // as deep as the k8 steps that will be read
          const int deep = (ch.depth + 7) & ~7;
          stage_tile(st, L.lda, ch.a, ch.a_ld, ch.a_rows, ch.depth, BM, deep,
                     a_vec);
          stage_tile(st + BM * L.lda, L.ldb, ch.x, ch.x_ld, ch.x_rows,
                     x_cols, deep, L.cols, x_vec);
        }
      },
      [&](int c, int stage) {
        const float* st = ring + stage * L.stage_floats;
        const int ks_end = (src.depth(c) + 7) >> 3;
        if (active) {
          chunk_mma<MT, NT>(acc, st, L.lda, st + BM * L.lda + col0, L.ldb,
                            wkk, L.wk, ks_end, lane);
        }
      });
  if (active) store_acc<MT, NT>(acc, mine, L.ldp, lane);
  fold_panel<MT>(smem, L);
}

// The whole fused right-hand side for one panel of 16·MT rows:
// out[r, :] = relu((Σ_chunks A_chunk · X_chunk) · W + b) for r < out_rows.
// Phase 1 is panel_product over all of X's L.width columns; phase 2 runs the
// panel through the same loop against W, whose chunks take the ring's place;
// w_vec says whether W's rows take 16-byte copies.
template <int MT, int NT, class Source>
__device__ __forceinline__ void fused_panel(
    float* smem, const Layout& L, const Source& src, int nchunks, bool a_vec,
    bool x_vec, const float* __restrict__ w, int64_t w_rs, int64_t w_cs,
    bool w_vec, const float* __restrict__ b, float* __restrict__ out,
    int out_rows) {
  constexpr int BM = 16 * MT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wkk = warp / L.wn;
  const int col0 = (warp % L.wn) * NT * 8;
  const bool active = col0 < L.cols;
  float* panel = smem;
  float* ring = smem + BM * L.ldp;
  float* mine = warp_tile<MT, NT>(smem, L, warp);

  panel_product<MT, NT>(smem, L, src, nchunks, a_vec, x_vec, L.width);

  // Phase 2: panel · W, W's chunks through the ring
  float acc[MT][NT][4];
  zero_acc<MT, NT>(acc);
  const bool w_t = w_cs != 1 && w_rs == 1;   // staged as it lies: transposed
  ring_loop(
      (L.width + L.bk - 1) / L.bk,
      [&](int c, int stage) {
        stage_w(ring + stage * L.stage_floats + BM * L.lda, L.ldb, L.lda, w,
                w_rs, w_cs, c * L.bk, L.width, L.bk, L.cols, w_vec);
      },
      [&](int c, int stage) {
        const float* st = ring + stage * L.stage_floats + BM * L.lda;
        const int ks_end = (min(L.bk, L.width - c * L.bk) + 7) >> 3;
        if (active && w_t) {
          chunk_mma<MT, NT, true>(acc, panel + c * L.bk, L.ldp,
                                  st + col0 * L.lda, L.lda, wkk, L.wk, ks_end,
                                  lane);
        } else if (active) {
          chunk_mma<MT, NT>(acc, panel + c * L.bk, L.ldp, st + col0, L.ldb,
                            wkk, L.wk, ks_end, lane);
        }
      });
  if (active) store_acc<MT, NT>(acc, mine, L.ldp, lane);
  fold_panel<MT>(smem, L);

  // + b, relu (a NaN stays a NaN), store
  for (int i = tid; i < out_rows * L.width; i += kMmaThreads) {
    const int r = i / L.width;
    const int c = i - r * L.width;
    const float v = panel[r * L.ldp + c] + b[c];
    out[(int64_t)r * L.width + c] = v < 0.0f ? 0.0f : v;
  }
}

#endif  // __CUDACC__

}  // namespace ndcn
