// K1-w's edge form (coo_mutual.cuh has the sums, the TPU kernel it
// replaces, and which form runs where): threads walk edges, not rows, so
// no load waits on the row pointer and every load of a thread is issued at
// once.
//
// Bound: bytes, as the warp form's (coo_mutual.cu). What holds both forms
// above it is the gather of the column endpoint: each is its own 32-byte
// sector from L2 (a 200k-node state does not stay in L1), and both move
// those sectors at about 4 TB/s on an H100 (tools/tune_mutual_plan.py), so
// at d = 1 on a graph of some ten edges a row they take about the same
// time; the edge form wins where the warp form's rows are uneven (hub
// rows), at d = 3 to 8, and at 1M nodes.
// - A CTA owns 1024 consecutive edges of the CSR and a thread 4 of them:
//   their rows, columns and values come in 16-byte loads (scalar where the
//   arrays are not 16-byte aligned, or at the ragged tail), then both
//   endpoints are gathered (the row's once a run). The rows are an int32
//   copy of the operator's sorted rows (kernels/coo_mutual.py, rows32):
//   4 bytes an edge beyond the bound's count, read beside the columns
//   instead of a search of the row pointer, whose dependent loads and
//   barriers made this form's first build 1.4× slower (0.030 ms at 200k /
//   d = 1).
// - The pair term (or its partial times the cotangent) is evaluated in
//   registers. The zeros of the empty rows between two edges are written
//   by the thread of the first, as one run of floats.
// - Runs of equal row are summed in a fixed order: the thread's own edges in
//   order, then a segmented shuffle scan of the lanes' tail runs (P1a's
//   scheme, sparse_bench.cu). A run wholly inside a warp is written by the
//   lane where it ends. Each warp's first and last run go to shared memory,
//   where warp 0 sums them in warp order by the same scan and writes them.
// - A row across a CTA boundary: where the CSR has no long rows (the
//   operator's split index is empty), the CTA where the row starts reads on
//   past its range to the row's end (the last warp, 32 edges a step) and
//   the CTA after skips it: one launch. Otherwise the CTA's first and last
//   run go to a carry scratch (two slots a CTA, the second empty when the
//   CTA is one run) and a second kernel adds each row's carries in CTA
//   order: a hub row is many CTAs' runs, and the chunk index is not read.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "coo_mutual.cuh"
#include "spmv_gather.cuh"

namespace {

using ndcn::mutual::Coef;
using ndcn::mutual::kColumnSide;
using ndcn::mutual::kForward;
using ndcn::mutual::kRowSide;
using ndcn::mutual::safe_div;

constexpr int kEdgeThreads = 256;  // 8 warps a CTA
constexpr int kEdgeWarps = kEdgeThreads / 32;
// edges a thread: 8 lost to 4 at every width, graph and side measured on
// an H100 (tools/tune_mutual_plan.py)
constexpr int kEdgesPerThread = 4;
constexpr unsigned kAll = 0xffffffffu;

// Floats a load of a row of D takes: the largest of 4, 2, 1 dividing D.
template <int D>
constexpr int kRowLoad = D % 4 == 0 ? 4 : D % 2 == 0 ? 2 : 1;

// D consecutive floats of row r of a row-major (n, D) table, in loads of
// kRowLoad<D> floats (the host checked the table's alignment).
template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ table,
                                         int64_t r, float (&out)[D]) {
  constexpr int E = kRowLoad<D>;
#pragma unroll
  for (int k = 0; k < D; k += E) {
    float part[E];
    ndcn::load_values<float, E>(table + r * D + k, part);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      out[k + j] = part[j];
    }
  }
}

// y[r] = v, or y[r] + v with `accumulate`.
template <int D>
__device__ __forceinline__ void write_row(float* __restrict__ y, int64_t r,
                                          const float (&v)[D],
                                          int accumulate) {
  float out[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    out[k] = accumulate ? y[r * D + k] + v[k] : v[k];
  }
  ndcn::store_values<D>(y + r * D, out);
}

// y[a, b) = 0, floats, in 16-byte stores from the first 16-byte boundary:
// a gap of empty rows is one run of floats, written at a quarter of a
// store a float whatever the width. (A store a row, scalar at d = 3 and
// 6, made the hub graph of tools/tune_mutual_plan.py, whose sparse rows
// leave gaps of tens of rows, 2-5x slower there than at d = 4.)
__device__ __forceinline__ void zero_floats(float* __restrict__ y, int64_t a,
                                            int64_t b) {
  for (; a < b && (reinterpret_cast<uintptr_t>(y + a) & 15); ++a) {
    y[a] = 0.0f;
  }
  for (; a + 4 <= b; a += 4) {
    *reinterpret_cast<float4*>(y + a) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (; a < b; ++a) {
    y[a] = 0.0f;
  }
}

// One edge's term at one feature: xr, gr at its row, xc, gc at its column.
template <int SIDE>
__device__ __forceinline__ float edge_term(float v, float xr, float gr,
                                           float xc, float gc, Coef c) {
  if constexpr (SIDE == kForward) {
    return v * safe_div(xr * xc, c.d + c.e * xr + c.h * xc);
  } else if constexpr (SIDE == kRowSide) {
    const float den = c.d + c.e * xr + c.h * xc;
    return v * gr * safe_div(xc * (c.d + c.h * xc), den * den);
  } else {
    // the column is the edge's row i of A, the row its column j
    const float den = c.d + c.e * xc + c.h * xr;
    return v * gc * safe_div(xc * (c.d + c.e * xc), den * den);
  }
}

// The sums of one CTA's edges [1024 · blockIdx.x, + 1024). Rows whose
// runs all lie in the CTA are written here; the CTA's first and last run go
// to carry slots 2 · blockIdx.x and 2 · blockIdx.x + 1 (row -1: empty).
// Without `accumulate` the empty rows are written 0: those between two
// edges by the thread of the first, those after the last edge by its
// thread, those before the first edge by thread 0 of CTA 0.
template <int SIDE, int D>
__global__ void __launch_bounds__(kEdgeThreads)
mutual_edges_kernel(const int32_t* __restrict__ rows,
                    const int32_t* __restrict__ cols,
                    const float* __restrict__ vals,
                    const float* __restrict__ x, const float* __restrict__ g,
                    float* __restrict__ y, int32_t* __restrict__ carry_rows,
                    float* __restrict__ carry_sums, int n, int nnz, Coef c,
                    int accumulate, int vec, int lookahead) {
  constexpr int EPT = kEdgesPerThread;
  constexpr int kCtaEdges = kEdgeThreads * EPT;
  __shared__ int slot_row[2 * kEdgeWarps];  // each warp's first, last run
  __shared__ float slot_sum[2 * kEdgeWarps][D];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cta0 = blockIdx.x * kCtaEdges;
  const int cta_end = nnz - cta0 < kCtaEdges ? nnz : cta0 + kCtaEdges;
  const int e0 = cta0 + tid * EPT;  // < nnz + kCtaEdges
  // with `lookahead`, the row of the edge before the CTA's range (-1: none)
  const int row_before = lookahead && cta0 > 0 ? __ldg(rows + cta0 - 1) : -1;

  // this thread's edges: rows, columns and values (16-byte loads), and the
  // row after them; edges past nnz repeat the last edge's row
  int row[EPT], col[EPT];
  float val[EPT];
  if (vec && e0 + EPT <= nnz) {
#pragma unroll
    for (int k = 0; k < EPT; k += 4) {
      const int4 r4 = __ldg(reinterpret_cast<const int4*>(rows + e0 + k));
      const int4 c4 = __ldg(reinterpret_cast<const int4*>(cols + e0 + k));
      const float4 v4 = __ldg(reinterpret_cast<const float4*>(vals + e0 + k));
      row[k] = r4.x; row[k + 1] = r4.y; row[k + 2] = r4.z; row[k + 3] = r4.w;
      col[k] = c4.x; col[k + 1] = c4.y; col[k + 2] = c4.z; col[k + 3] = c4.w;
      val[k] = v4.x; val[k + 1] = v4.y; val[k + 2] = v4.z; val[k + 3] = v4.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      const int e = min(e0 + k, nnz - 1);
      row[k] = __ldg(rows + e);
      col[k] = __ldg(cols + e);
      val[k] = e0 + k < nnz ? __ldg(vals + e) : 0.0f;
    }
  }
  const int next_row = e0 + EPT < nnz ? __ldg(rows + e0 + EPT) : n;
  // with `lookahead` the last warp's lanes load the first 32 edges past
  // the range beside their own (the row a CTA's last run may run on into),
  // so that reading on costs no dependent load at the CTA's end
  const bool reads_on = lookahead && warp == kEdgeWarps - 1;
  const int ahead = cta_end + lane;
  int ahead_row = -1, ahead_col = 0;
  float ahead_val = 0.0f, ahead_xc[D], ahead_gc[D];
  if (reads_on && ahead < nnz) {
    ahead_row = __ldg(rows + ahead);
    ahead_col = __ldg(cols + ahead);
    ahead_val = __ldg(vals + ahead);
    load_row<D>(x, ahead_col, ahead_xc);
    if constexpr (SIDE == kColumnSide) {
      load_row<D>(g, ahead_col, ahead_gc);
    }
  }

  // the terms, from both endpoints (the row's loaded once a run); edges
  // past nnz add exact zeros
  float t[EPT][D], xr[D], gr[D];
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    float xc[D], gc[D];
    if (k == 0 || row[k] != row[k - 1]) {
      load_row<D>(x, row[k], xr);
      if constexpr (SIDE == kRowSide) {
        load_row<D>(g, row[k], gr);
      }
    }
    load_row<D>(x, col[k], xc);
    if constexpr (SIDE == kColumnSide) {
      load_row<D>(g, col[k], gc);
    }
    const bool in = e0 + k < nnz;
#pragma unroll
    for (int f = 0; f < D; ++f) {
      t[k][f] = in ? edge_term<SIDE>(val[k], xr[f],
                                     SIDE == kRowSide ? gr[f] : 0.0f, xc[f],
                                     SIDE == kColumnSide ? gc[f] : 0.0f, c)
                   : 0.0f;
    }
  }

  // the empty rows after each of this thread's edges (the last edge's
  // thread: to the end), and for the first thread those before edge 0;
  // an edge with no gap after it costs one compare
  if (!accumulate && e0 < nnz) {
    if (e0 == 0 && row[0] > 0) zero_floats(y, 0, (int64_t)row[0] * D);
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      const int upto = k + 1 < EPT ? row[k + 1] : next_row;
      if (row[k] + 1 < upto) {
        zero_floats(y, (int64_t)(row[k] + 1) * D, (int64_t)upto * D);
      }
    }
  }

  // the thread's edges in order: a head run that may have begun in an
  // earlier lane, runs wholly inside the thread (written here), a tail run
  bool single = true;
  float head[D], run[D];
#pragma unroll
  for (int f = 0; f < D; ++f) {
    head[f] = 0.0f;
    run[f] = t[0][f];
  }
  int key = row[0];
#pragma unroll
  for (int k = 1; k < EPT; ++k) {
    if (row[k] == key) {
#pragma unroll
      for (int f = 0; f < D; ++f) run[f] += t[k][f];
    } else {
      if (single) {
#pragma unroll
        for (int f = 0; f < D; ++f) head[f] = run[f];
      } else {
        write_row<D>(y, key, run, accumulate);
      }
      single = false;
#pragma unroll
      for (int f = 0; f < D; ++f) run[f] = t[k][f];
      key = row[k];
    }
  }

  // a segmented inclusive scan of the tail runs over the lanes: a lane that
  // is one run of the previous lane's tail row continues its segment
  const int first = row[0], last = row[EPT - 1];
  const int prev_last = __shfl_up_sync(kAll, last, 1);
  const int next_first = __shfl_down_sync(kAll, first, 1);
  const int warp_first = __shfl_sync(kAll, first, 0);
  bool starts = !(single && lane > 0 && first == prev_last);
  float s[D];
#pragma unroll
  for (int f = 0; f < D; ++f) s[f] = run[f];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const bool starts_up = __shfl_up_sync(kAll, starts, off);
#pragma unroll
    for (int f = 0; f < D; ++f) {
      const float s_up = __shfl_up_sync(kAll, s[f], off);
      if (lane >= off && !starts) s[f] = s_up + s[f];
    }
    if (lane >= off) starts = starts || starts_up;
  }
  float prev_s[D];
#pragma unroll
  for (int f = 0; f < D; ++f) prev_s[f] = __shfl_up_sync(kAll, s[f], 1);

  // the head run ends in this lane; the warp's first run goes to its slot
  if (!single) {
    const bool joined = lane > 0 && prev_last == first;
#pragma unroll
    for (int f = 0; f < D; ++f) {
      head[f] = joined ? prev_s[f] + head[f] : head[f];
    }
    if (first == warp_first) {
      slot_row[2 * warp] = first;
#pragma unroll
      for (int f = 0; f < D; ++f) slot_sum[2 * warp][f] = head[f];
    } else {
      write_row<D>(y, first, head, accumulate);
    }
  }
  // the tail run ends in this lane unless the next lane continues it; the
  // warp's last run (lane 31's tail) goes to its slot
  if (lane == 31 || next_first != last) {
    const int slot = last == warp_first ? 2 * warp
                     : lane == 31       ? 2 * warp + 1
                                        : -1;
    if (slot >= 0) {
      slot_row[slot] = last;
#pragma unroll
      for (int f = 0; f < D; ++f) slot_sum[slot][f] = s[f];
      if (lane == 31 && slot == 2 * warp) slot_row[slot + 1] = -1;
    } else {
      write_row<D>(y, last, s, accumulate);
    }
  }
  // with `lookahead` the CTA's last run is summed to its row's end here,
  // past the range: the last warp reads on, 32 edges a step (the first
  // step's loads made above)
  if (reads_on) {
    const int r = __shfl_sync(kAll, last, 31);
    float more[D], xr_on[D], gr_on[D];
#pragma unroll
    for (int f = 0; f < D; ++f) more[f] = 0.0f;
    load_row<D>(x, r, xr_on);
    if constexpr (SIDE == kRowSide) {
      load_row<D>(g, r, gr_on);
    }
    bool mine = ahead_row == r;
    bool going = __all_sync(kAll, mine);
    for (int base = cta_end;;) {
      if (mine) {
#pragma unroll
        for (int f = 0; f < D; ++f) {
          more[f] += edge_term<SIDE>(
              ahead_val, xr_on[f], SIDE == kRowSide ? gr_on[f] : 0.0f,
              ahead_xc[f], SIDE == kColumnSide ? ahead_gc[f] : 0.0f, c);
        }
      }
      base += 32;
      if (!going || base >= nnz) break;  // uniform across the warp
      const int e = base + lane;         // a row longer than 32 more edges
      mine = e < nnz && __ldg(rows + e) == r;
      going = __all_sync(kAll, mine);
      if (mine) {
        ahead_col = __ldg(cols + e);
        ahead_val = __ldg(vals + e);
        load_row<D>(x, ahead_col, ahead_xc);
        if constexpr (SIDE == kColumnSide) {
          load_row<D>(g, ahead_col, ahead_gc);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < D; ++f) {
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) {
        more[f] += __shfl_xor_sync(kAll, more[f], off);
      }
    }
    if (lane == 31) {
      const int slot = slot_row[2 * warp + 1] >= 0 ? 2 * warp + 1 : 2 * warp;
#pragma unroll
      for (int f = 0; f < D; ++f) slot_sum[slot][f] += more[f];
    }
  }
  __syncthreads();

  // the warps' boundary runs, in warp order, by warp 0: lane i holds slot
  // i (an empty slot takes the row of the one before and adds 0), a
  // segmented scan sums each run, and the lane where a run ends writes it;
  // the CTA's first and last run go to the carry slots
  if (warp == 0) {
    constexpr int kSlots = 2 * kEdgeWarps;
    int r = lane < kSlots ? slot_row[lane] : -2 - lane;  // lanes past: alone
    float v[D];
#pragma unroll
    for (int f = 0; f < D; ++f) {
      v[f] = lane < kSlots && r >= 0 ? slot_sum[lane][f] : 0.0f;
    }
    if (lane < kSlots && r < 0) r = slot_row[lane - 1];  // odd slots only
    const int cta_first = slot_row[0];
    const int cta_last = __shfl_sync(kAll, r, kSlots - 1);
    const int prev_r = __shfl_up_sync(kAll, r, 1);
    const int next_r = __shfl_down_sync(kAll, r, 1);
    bool starts = lane == 0 || prev_r != r;
#pragma unroll
    for (int off = 1; off < kSlots; off <<= 1) {
      const bool starts_up = __shfl_up_sync(kAll, starts, off);
#pragma unroll
      for (int f = 0; f < D; ++f) {
        const float v_up = __shfl_up_sync(kAll, v[f], off);
        if (lane >= off && !starts) v[f] = v_up + v[f];
      }
      if (lane >= off) starts = starts || starts_up;
    }
    const int64_t out = 2 * (int64_t)blockIdx.x;
    if (!lookahead && lane == 0 && cta_first == cta_last) {
      carry_rows[out + 1] = -1;
    }
    if (lane < kSlots && (lane == kSlots - 1 || next_r != r)) {
      if (lookahead) {
        // a first run begun before the range is the CTA before's to write
        if (r != row_before) write_row<D>(y, r, v, accumulate);
      } else if (r == cta_first || r == cta_last) {
        const int64_t at = r == cta_first ? out : out + 1;
        carry_rows[at] = r;
#pragma unroll
        for (int f = 0; f < D; ++f) carry_sums[at * D + f] = v[f];
      } else {
        write_row<D>(y, r, v, accumulate);
      }
    }
  }
}

// Each row's carries, in CTA order, added and written (or added to y with
// `accumulate`): a thread per (slot, feature), the first slot of each row.
__global__ void __launch_bounds__(kEdgeThreads)
mutual_carry_kernel(const int32_t* __restrict__ carry_rows,
                    const float* __restrict__ carry_sums,
                    float* __restrict__ y, int slots, int d, int accumulate) {
  const int64_t at = (int64_t)blockIdx.x * kEdgeThreads + threadIdx.x;
  if (at >= (int64_t)slots * d) return;
  const int i = (int)(at / d), f = (int)(at - (int64_t)i * d);
  const int r = carry_rows[i];
  if (r < 0) return;
  if (i > 0) {
    // only odd slots are empty, and the even slot before is not
    const int prev = carry_rows[i - 1] >= 0 ? carry_rows[i - 1]
                                            : carry_rows[i - 2];
    if (prev == r) return;
  }
  float acc = carry_sums[(int64_t)i * d + f];
  for (int j = i + 1; j < slots; ++j) {
    const int q = carry_rows[j];
    if (q < 0) continue;
    if (q != r) break;
    acc += carry_sums[(int64_t)j * d + f];
  }
  float* out = y + (int64_t)r * d + f;
  *out = accumulate ? *out + acc : acc;
}

template <int SIDE, int D>
void launch_edges(const int32_t* rows, const int32_t* cols,
                  const float* vals, const float* x, const float* g, float* y,
                  int32_t* carry_rows, float* carry_sums, int n, int nnz,
                  Coef c, int accumulate, int vec, int lookahead,
                  cudaStream_t stream) {
  // the kernel keeps no shared memory to speak of: the rest of the SM's
  // 256 KB is L1, which holds the gathered state's rows (a 50k-node state
  // whole)
  static const cudaError_t carveout = cudaFuncSetAttribute(
      mutual_edges_kernel<SIDE, D>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxL1);
  (void)carveout;
  constexpr int kCtaEdges = kEdgeThreads * kEdgesPerThread;
  const int ctas = (int)(((int64_t)nnz + kCtaEdges - 1) / kCtaEdges);
  mutual_edges_kernel<SIDE, D><<<ctas, kEdgeThreads, 0, stream>>>(
      rows, cols, vals, x, g, y, carry_rows, carry_sums, n, nnz, c,
      accumulate, vec, lookahead);
  if (lookahead) return;
  const int64_t threads = 2 * (int64_t)ctas * D;
  mutual_carry_kernel<<<(int)((threads + kEdgeThreads - 1) / kEdgeThreads),
                        kEdgeThreads, 0, stream>>>(carry_rows, carry_sums, y,
                                                   2 * ctas, D, accumulate);
}

// Calls f(side, width) as integral constants for the widths the edge form
// is built for (1 to 8); false for any other.
template <typename F>
bool for_edge_instance(int side, int d, F f) {
  auto by_side = [&](auto dd) {
    using std::integral_constant;
    if (side == kForward) f(integral_constant<int, kForward>{}, dd);
    else if (side == kRowSide) f(integral_constant<int, kRowSide>{}, dd);
    else f(integral_constant<int, kColumnSide>{}, dd);
    return true;
  };
  using std::integral_constant;
  switch (d) {
    case 1: return by_side(integral_constant<int, 1>{});
    case 2: return by_side(integral_constant<int, 2>{});
    case 3: return by_side(integral_constant<int, 3>{});
    case 4: return by_side(integral_constant<int, 4>{});
    case 5: return by_side(integral_constant<int, 5>{});
    case 6: return by_side(integral_constant<int, 6>{});
    case 7: return by_side(integral_constant<int, 7>{});
    case 8: return by_side(integral_constant<int, 8>{});
  }
  return false;
}

}  // namespace

// The edge form of one side over one CSR (as above), for d from 1 to 8,
// kEdgesPerThread edges a thread. `rows` is the CSR's
// row of each edge (int32, sorted), nnz its edge count; `vec` says rows,
// cols and vals are 16-byte aligned. With `lookahead` one launch: the CTA
// where a row starts sums it to its end, reading past its range (the host
// asks for it where no row is long, so that the reading on is short), and
// the carries are not touched. Without it two launches, the CTAs' sums and
// the carries' adds: carry_rows (int32) and carry_sums (fp32, d a slot)
// hold 2 · ceil(nnz / 1024) slots. x and g (read on sides 1 and 2) must be
// aligned to the bytes of kRowLoad<d> floats. Launches on `stream`,
// allocates nothing, does not synchronise, and returns cudaGetLastError().
extern "C" int ndcn_coo_mutual_edges_f32(
    int side, const void* rows, const void* cols, const void* vals,
    const void* x, const void* g, void* y, int n_rows, int nnz, int d,
    float dd, float e, float h, int accumulate,
    int vec, int lookahead, void* carry_rows, void* carry_sums,
    void* stream) {
  if (n_rows <= 0 || d <= 0) return (int)cudaGetLastError();
  const int width = 4 * (d % 4 == 0 ? 4 : d % 2 == 0 ? 2 : 1);
  if (side < kForward || side > kColumnSide ||
      !ndcn::gather_width_ok<float>(x, d, width) ||
      (side != kForward && !ndcn::gather_width_ok<float>(g, d, width))) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (nnz <= 0) {
    if (!accumulate) {
      cudaMemsetAsync(y, 0, (size_t)n_rows * d * sizeof(float), s);
    }
    return (int)cudaGetLastError();
  }
  const Coef c{dd, e, h};
  const bool built = for_edge_instance(
      side, d, [&](auto sd, auto dw) {
        launch_edges<decltype(sd)::value, decltype(dw)::value>(
            (const int32_t*)rows, (const int32_t*)cols,
            (const float*)vals, (const float*)x, (const float*)g, (float*)y,
            (int32_t*)carry_rows, (float*)carry_sums, n_rows, nnz, c,
            accumulate, vec, lookahead, s);
      });
  return built ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}
