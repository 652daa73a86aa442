// The warp-level row gather that K1 (row-major) and K1-fm (feature-major)
// share, and the two passes that spread a long row over many warps.
//
// What bounds the gather on this card is the number of independent loads a
// warp keeps in flight and the bytes each lane asks for. So:
// - A row of the gathered table (d values of type T, row-major) is read with
//   the widest load that divides its bytes: E values a lane, E · sizeof(T) =
//   16, 8, 4 or 2 bytes. A row then needs d / E lanes ("span"), and the
//   32 / span groups of lanes of the warp each take every (32 / span)-th
//   edge: at d = 20 fp32, 5 lanes a row and 6 edges in flight. Rows wider
//   than 32 lanes are walked in segments of 32 lanes. A row of one or two
//   lanes (d = 1, the physics solve) would leave most of a warp idle on a
//   graph of some ten edges a row, and the warp's latency is what such a
//   kernel pays: there a warp walks 4 or 2 rows at once, 8 edges in flight
//   each.
// - Each lane sums E features in registers (fp32 FMA). The groups are then
//   folded by warp shuffles in a fixed order (xor shuffles where span is a
//   power of two, else a tree of down shuffles), so group 0 ends with the
//   sums.
// - A row longer than the operator's split limit is not walked by its warp
//   (it counts as empty there). The host cut it into chunks when the
//   operator was built; `chunk_partials_kernel` sums each chunk with one
//   warp (or one row's share of it) into a scratch row, and `fold_chunks_kernel` adds a row's scratch
//   rows in chunk order and writes the result. A hub row of 20k edges is 77
//   warps' work instead of one warp's.
// No atomics: the order of every sum follows from (operator, d, E) alone,
// so two calls on the same inputs agree bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "spmv_common.cuh"

namespace ndcn {

constexpr int kGatherThreads = 256;  // 8 warps a block

template <int BYTES> struct LoadWord;
template <> struct LoadWord<16> { using type = uint4; };
template <> struct LoadWord<8> { using type = uint2; };
template <> struct LoadWord<4> { using type = unsigned int; };
template <> struct LoadWord<2> { using type = unsigned short; };

// E consecutive values at p (aligned to E · sizeof(T) bytes), as floats.
template <typename T, int E>
__device__ __forceinline__ void load_values(const T* p, float (&out)[E]) {
  using Word = typename LoadWord<E * sizeof(T)>::type;
  const Word word = __ldg(reinterpret_cast<const Word*>(p));
  const T* values = reinterpret_cast<const T*>(&word);
#pragma unroll
  for (int k = 0; k < E; ++k) {
    out[k] = to_float(values[k]);
  }
}

// E consecutive floats to p (aligned to min(16, E · 4) bytes).
template <int E>
__device__ __forceinline__ void store_values(float* p, const float (&v)[E]) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int k = 0; k < E; k += 4) {
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    }
  } else if constexpr (E == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      p[k] = v[k];
    }
  }
}

// 8 blocks of 256 threads an SM: full occupancy, at most 32 registers a
// thread. The gather waits on memory, so resident warps are what hide it.
constexpr int kGatherBlocksPerSm = 8;

// How the 32 lanes of a warp are laid over rows of d values, E a lane; the
// host works it out once per launch, so no thread divides.
struct LaneShape {
  int row_lanes;  // d / E: lanes one row takes
  int span;       // min(row_lanes, 32): lanes per row, or per 32-lane segment
  int segments;   // ceil(row_lanes / 32)
  int sub_log2;   // a row's share of the warp is 1 << sub_log2 lanes
  int rows;       // rows (or chunks) a warp walks at once: 32 >> sub_log2
  int groups;     // edges in flight a row: (1 << sub_log2) / span
  int inv_span;   // ceil(2^16 / span): x / span = (x * inv_span) >> 16
  int fold_from;  // the largest power of two below groups (0: no fold)
  int butterfly;  // span and groups are powers of two: fold by xor shuffles
};

inline LaneShape lane_shape(int d, int E) {
  LaneShape s;
  s.row_lanes = d / E;
  s.span = s.row_lanes < 32 ? s.row_lanes : 32;
  s.segments = (s.row_lanes + 31) / 32;
  // A row of a sparse graph has some ten edges: 8 in flight are enough, so
  // a narrow row (one or two lanes) shares its warp with other rows.
  s.sub_log2 = 5;
  while (s.sub_log2 > 0 && (1 << (s.sub_log2 - 1)) >= 8 * s.span) {
    --s.sub_log2;
  }
  s.rows = 32 >> s.sub_log2;
  s.groups = (1 << s.sub_log2) / s.span;
  s.inv_span = (65536 + s.span - 1) / s.span;
  s.fold_from = 0;
  for (int p = 1; p < s.groups; p *= 2) s.fold_from = p;
  s.butterfly = (s.span & (s.span - 1)) == 0;
  return s;
}

// One lane's place in that layout.
struct WarpLanes {
  int span, groups, row_lanes, segments, fold_from, sub;
  bool butterfly;
  int row;    // which of the warp's rows this lane works on
  int group;  // this lane's group there; lanes with group >= groups idle
  int slot;   // this lane's place in its group

  __device__ __forceinline__ WarpLanes(const LaneShape& s, int lane)
      : span(s.span), groups(s.groups), row_lanes(s.row_lanes),
        segments(s.segments), fold_from(s.fold_from), sub(1 << s.sub_log2),
        butterfly(s.butterfly != 0) {
    row = lane >> s.sub_log2;
    const int sublane = lane & (sub - 1);
    group = (sublane * s.inv_span) >> 16;  // exact: sublane < 32, span <= 32
    slot = sublane - group * span;
  }
  // the lane of the row that this lane reads in a segment, or -1
  __device__ __forceinline__ int row_lane(int segment) const {
    const int j = segment * 32 + slot;
    return (group < groups && j < row_lanes) ? j : -1;
  }
};

// Folds the lane sums of a row's groups in a fixed order: afterwards the
// lanes of group 0 hold the row's sums. Every lane of the warp must call it.
template <int E>
__device__ __forceinline__ void warp_fold(const WarpLanes& w,
                                          float (&acc)[E]) {
  if (w.butterfly) {
    // lanes that share a slot differ in the bits from span up to the row's
    // share of the warp: xor shuffles leave the sum in every group
    for (int off = w.sub >> 1; off >= w.span; off >>= 1) {
#pragma unroll
      for (int k = 0; k < E; ++k) {
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
      }
    }
    return;
  }
  // group g takes group g + s, for s = fold_from, .. 2, 1: a fixed tree
  // (a rolled loop: the shuffle distance stays in a register)
#pragma unroll 1
  for (int s = w.fold_from; s >= 1; s >>= 1) {
    const int distance = s * w.span;
    const bool take = w.group < s && w.group + s < w.groups;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const float other = __shfl_down_sync(0xffffffffu, acc[k], distance);
      if (take) {
        acc[k] += other;
      }
    }
  }
}

// The sums of edges [start, end) for the E features at row lane j (j < 0:
// this lane idles), folded over the row's groups: afterwards the lanes of
// group 0 hold the result. Every lane of the warp must call this, whatever
// its row.
template <typename T, int E>
__device__ __forceinline__ void warp_gather(
    const int32_t* __restrict__ cols, const float* __restrict__ vals,
    const T* __restrict__ table, int d, int start, int end,
    const WarpLanes& w, int j, float (&acc)[E]) {
#pragma unroll
  for (int k = 0; k < E; ++k) {
    acc[k] = 0.0f;
  }
  if (j >= 0) {
    const T* column = table + j * E;
    int e = start + w.group;
    // two edges a turn, so that a long row keeps two loads a lane in flight
    // (written out: an unroll pragma would make every row, short ones too,
    // divide for its trip count); a lane of 8 values has no registers left
    // for a second edge
    constexpr bool kTwoEdges = E < 8;
#pragma unroll 1
    for (; kTwoEdges && e + w.groups < end; e += 2 * w.groups) {
      const float a0 = edge_val<T>(vals + e);
      const float a1 = edge_val<T>(vals + e + w.groups);
      float x0[E], x1[E];
      load_values<T, E>(column + (int64_t)__ldg(cols + e) * d, x0);
      load_values<T, E>(column + (int64_t)__ldg(cols + e + w.groups) * d, x1);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        acc[k] = fmaf(a1, x1[k], fmaf(a0, x0[k], acc[k]));
      }
    }
    for (; e < end; e += w.groups) {  // the last edge, or one edge a turn
      const float a = edge_val<T>(vals + e);
      float x[E];
      load_values<T, E>(column + (int64_t)__ldg(cols + e) * d, x);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        acc[k] = fmaf(a, x[k], acc[k]);
      }
    }
  }
  warp_fold<E>(w, acc);
}

// One row's share of a warp per chunk of a long row: partial (n_chunks, d)
// fp32, row-major.
template <typename T, int E>
__global__ void __launch_bounds__(kGatherThreads, kGatherBlocksPerSm)
chunk_partials_kernel(const int32_t* __restrict__ chunk_bounds,
                      const int32_t* __restrict__ cols,
                      const float* __restrict__ vals,
                      const T* __restrict__ table,
                      float* __restrict__ partial, int n_chunks, int d,
                      LaneShape shape) {
  const int64_t first = (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5)
                        * shape.rows;
  if (first >= n_chunks) return;  // uniform across the warp
  const WarpLanes w(shape, threadIdx.x & 31);
  const int64_t chunk = first + w.row;
  const bool valid = chunk < n_chunks;
  const int start = valid ? chunk_bounds[2 * chunk] : 0;
  const int end = valid ? chunk_bounds[2 * chunk + 1] : 0;
  for (int seg = 0; seg < w.segments; ++seg) {
    const int j = valid ? w.row_lane(seg) : -1;
    float acc[E];
    warp_gather<T, E>(cols, vals, table, d, start, end, w, j, acc);
    if (w.group == 0 && j >= 0) {
      store_values<E>(partial + chunk * d + j * E, acc);
    }
  }
}

// One block per long row: its chunks' partial sums added in chunk order.
// Feature f of row r goes to y[r · row_stride + f · feature_stride], so the
// kernel writes either layout.
static __global__ void __launch_bounds__(kGatherThreads)
fold_chunks_kernel(const int32_t* __restrict__ long_rows,
                   const int32_t* __restrict__ chunk_ptr,
                   const float* __restrict__ partial, float* __restrict__ y,
                   int d, int64_t row_stride, int64_t feature_stride) {
  const int64_t row = long_rows[blockIdx.x];
  const int first = chunk_ptr[blockIdx.x];
  const int last = chunk_ptr[blockIdx.x + 1];
  for (int f = threadIdx.x; f < d; f += blockDim.x) {
    float acc = 0.0f;
    for (int c = first; c < last; ++c) {
      acc += partial[(int64_t)c * d + f];
    }
    y[row * row_stride + f * feature_stride] = acc;
  }
}

// Blocks of kGatherThreads for `items` rows or chunks, `rows` a warp.
inline int gather_blocks(int64_t items, int rows) {
  const int64_t warps = (items + rows - 1) / rows;
  return (int)((warps + kGatherThreads / 32 - 1) / (kGatherThreads / 32));
}

// The operator's chunk index, as the host built it (all device pointers).
struct RowSplit {
  int limit;                    // rows with more edges are split
  const int32_t* long_rows;     // (n_long,)
  const int32_t* chunk_ptr;     // (n_long + 1,)
  const int32_t* chunk_bounds;  // (n_chunks, 2)
  int n_long;
  int n_chunks;
  float* partial;               // (n_chunks, d) scratch
};

inline RowSplit row_split(int limit, const void* long_rows,
                          const void* chunk_ptr, const void* chunk_bounds,
                          int n_long, int n_chunks, void* partial) {
  return RowSplit{limit,
                  (const int32_t*)long_rows,
                  (const int32_t*)chunk_ptr,
                  (const int32_t*)chunk_bounds,
                  n_long,
                  n_chunks,
                  (float*)partial};
}

// The two passes over the long rows, after the rows kernel on the same
// stream (which wrote zeros for them).
template <typename T, int E>
void launch_long_rows(const RowSplit& split, const int32_t* cols,
                      const float* vals, const T* table, float* y, int d,
                      int64_t row_stride, int64_t feature_stride,
                      cudaStream_t stream) {
  if (split.n_chunks <= 0) return;
  const LaneShape shape = lane_shape(d, E);
  chunk_partials_kernel<T, E>
      <<<gather_blocks(split.n_chunks, shape.rows), kGatherThreads, 0,
         stream>>>(split.chunk_bounds, cols, vals, table, split.partial,
                   split.n_chunks, d, shape);
  fold_chunks_kernel<<<split.n_long, kGatherThreads, 0, stream>>>(
      split.long_rows, split.chunk_ptr, split.partial, y, d, row_stride,
      feature_stride);
}

// Does the table (rows of d values of T) take loads of `width` bytes?
template <typename T>
inline bool gather_width_ok(const void* table, int d, int width) {
  return (width == 16 || width == 8 || width == 4 || width == 2) &&
         width >= (int)sizeof(T) && (d * (int)sizeof(T)) % width == 0 &&
         (uintptr_t)table % width == 0;
}

// Calls f(std::integral_constant<int, E>) for the E = width / sizeof(T)
// values one lane loads (E = 8 only for 2-byte T): the kernels are
// instantiated per E.
template <typename T, typename F>
void for_lane_values(int width, F f) {
  switch (width / (int)sizeof(T)) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 8:
      if constexpr (sizeof(T) == 2) {
        f(std::integral_constant<int, 8>{});
      }
      break;
  }
}

}  // namespace ndcn
