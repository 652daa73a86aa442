// The kernels of the sparse microbenchmarks (ndcn_tpu_torch/tools/).
//
// P1a, the sliced-tile reduce, replaces the Pallas kernel of
// tools/microbench_sparse.py:235 (seg_kernel, :210-222): pre-gathered
// feature-major contribs (d_sub, S·E) are reduced into (d_sub, R) output
// tiles, out[f, tile·R + lr[e]] += contrib[f, e] · vals[e], over slices of E
// edge slots, each row-sorted with its pad slots (local row 0, value 0) at
// its end; a tile's slices are consecutive (tile_ptr). The TPU ran the
// slices as a sequential grid, kept the output tile in VMEM and reduced each
// slice with a one-hot matmul.
//
// Here a warp owns one feature row f of one tile (a CTA: the tile and 8
// features, the features of a tile in neighbouring CTAs so that the slots'
// rows and values are read from L2 once): its R accumulators live in shared
// memory, zeroed once and stored once, coalesced. The warp streams the
// tile's slices in steps of 128 slots, lane l holding slots 4l .. 4l + 3
// (16-byte loads where E is a multiple of 4; the next step's loads are in
// flight while this one reduces), and sums each run of equal local row with
// a segmented warp reduction: the lane's own slots in order, then a
// segmented scan of the lanes' tail runs over shuffles; the lane where a run
// ends adds its sum to the row's accumulator. Only the owning warp touches a
// feature's accumulators and it walks slices and steps in order, so every sum
// has a fixed order, no atomics are needed and two calls agree bit for bit.
// The runs of one step have distinct rows but for the pad run (row 0 again,
// and always the step's last run, which the slots past E extend), so the
// last run is added after the others. Pads add exactly 0, as in the plain
// version; a row that spans slices gets one add per step it reaches.
//
// Bound: bytes. The contribs (d_sub · 4 bytes a slot) are read once, from
// device memory, without keeping them in L1 or L2; the rows and values (8
// bytes a slot) once per CTA of the tile, from L2 after the first.

// P1b / P2, the row gather, replaces the in-kernel gathers of
// tools/microbench_sparse.py:288 (take_kernel, :280-281) and
// tools/probe_inkernel_gather.py:60 (its four bodies, :38-55):
// out[e, :] = x[idx[e], :] for a row-major (m, k) fp32 table. One warp per
// output row, 16-byte loads and stores. The TPU probes gathered from a table
// held in VMEM; the tables here (512 KB, 2 MB) would fit in shared memory
// only whole per CTA, which costs more than it saves for one pass, so the
// gather reads through L2, where both tables stay resident.
// Bound: bytes, 2 · E · k · 4 through L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kReduceWarps = 8;   // features of one CTA, a warp each
constexpr int kReduceThreads = 32 * kReduceWarps;
constexpr int kStep = 128;        // slots a warp reduces at a time, 4 a lane
constexpr unsigned kAll = 0xffffffffu;
constexpr int kGatherThreads = 256;  // 8 output rows per block

// A lane's four consecutive slots of one step: local rows and products.
struct Slots {
  int k[4];
  float p[4];
};

// Slots e .. e + 3 of the slice at base: past E they repeat the slice's last
// row with the value 0, so they extend its last run and add nothing.
template <bool kVec>
__device__ __forceinline__ Slots load_slots(const int32_t* __restrict__ lr,
                                            const float* __restrict__ vals,
                                            const float* __restrict__ crow,
                                            int64_t base, int e, int E) {
  Slots sl;
  const int last = __ldg(lr + base + E - 1);
  if (kVec) {   // E % 4 == 0: the four are all in the slice or all past it
    if (e < E) {
      const int64_t at = base + e;
      const int4 k = __ldg(reinterpret_cast<const int4*>(lr + at));
      const float4 v = __ldg(reinterpret_cast<const float4*>(vals + at));
      const float4 c = __ldcs(reinterpret_cast<const float4*>(crow + at));
      sl.k[0] = k.x; sl.k[1] = k.y; sl.k[2] = k.z; sl.k[3] = k.w;
      sl.p[0] = c.x * v.x; sl.p[1] = c.y * v.y;
      sl.p[2] = c.z * v.z; sl.p[3] = c.w * v.w;
      return sl;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sl.k[j] = last;
      sl.p[j] = 0.0f;
    }
    return sl;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool in = e + j < E;
    sl.k[j] = in ? __ldg(lr + base + e + j) : last;
    sl.p[j] = in ? __ldcs(crow + base + e + j) * __ldg(vals + base + e + j)
                 : 0.0f;
  }
  return sl;
}

// acc[k] += the sum of each run of equal k among the warp's 128 slots.
__device__ __forceinline__ void reduce_step(float* acc, const Slots& sl,
                                            int lane) {
  // the lane's own slots in order: a head run that began at or before its
  // first slot, runs wholly inside the lane (added here), the tail run
  bool single = true;   // one run over all four slots
  float head = 0.0f, run = sl.p[0];
  int key = sl.k[0];
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    if (sl.k[j] == key) {
      run += sl.p[j];
    } else {
      if (single) {
        head = run;
      } else {
        acc[key] += run;
      }
      single = false;
      run = sl.p[j];
      key = sl.k[j];
    }
  }
  // a segmented inclusive scan of the tail runs: a lane that is one run of
  // the previous lane's tail row continues that lane's segment
  const int prev_last = __shfl_up_sync(kAll, sl.k[3], 1);
  const int next_first = __shfl_down_sync(kAll, sl.k[0], 1);
  bool starts = !(single && lane > 0 && sl.k[0] == prev_last);
  float s = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float s_up = __shfl_up_sync(kAll, s, off);
    const bool starts_up = __shfl_up_sync(kAll, starts, off);
    if (lane >= off) {
      if (!starts) s = s_up + s;
      starts = starts || starts_up;
    }
  }
  const float prev_s = __shfl_up_sync(kAll, s, 1);
  if (!single) {   // the head run ends here, after the previous lane's tail
    acc[sl.k[0]] += (lane > 0 && prev_last == sl.k[0]) ? prev_s + head : head;
  }
  if (lane < 31 && next_first != sl.k[3]) acc[sl.k[3]] += s;
  __syncwarp();
  if (lane == 31) acc[sl.k[3]] += s;   // the step's last run, alone
  __syncwarp();
}

template <bool kVec>
__global__ void __launch_bounds__(kReduceThreads)
sliced_tile_reduce_kernel(const int32_t* __restrict__ tile_ptr,
                          const int32_t* __restrict__ local_rows,
                          const float* __restrict__ vals,
                          const float* __restrict__ contrib,
                          float* __restrict__ out, int d_sub, int E, int R,
                          int groups, int64_t n_slots, int64_t n_pad) {
  extern __shared__ float acc_all[];   // (kReduceWarps, R)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x / groups;
  const int f = (blockIdx.x - tile * groups) * kReduceWarps + warp;
  if (f >= d_sub) return;   // no barrier below: a warp owns its row
  float* acc = acc_all + warp * R;
  for (int r = lane; r < R; r += 32) acc[r] = 0.0f;
  __syncwarp();
  const float* crow = contrib + (int64_t)f * n_slots;
  const int s0 = tile_ptr[tile];
  const int steps_per_slice = (E + kStep - 1) / kStep;
  const int steps = (tile_ptr[tile + 1] - s0) * steps_per_slice;
  // step i: slice s0 + i / steps_per_slice, its slots from
  // (i % steps_per_slice) · 128 + 4 · lane
  auto load = [&](int i) {
    const int slice = i / steps_per_slice;
    return load_slots<kVec>(local_rows, vals, crow,
                            (int64_t)(s0 + slice) * E,
                            (i - slice * steps_per_slice) * kStep + 4 * lane,
                            E);
  };
  Slots cur;
  if (steps > 0) cur = load(0);
  for (int i = 0; i < steps; ++i) {
    Slots next;
    if (i + 1 < steps) next = load(i + 1);
    reduce_step(acc, cur, lane);
    cur = next;
  }
  float* dst = out + (int64_t)f * n_pad + (int64_t)tile * R;
  for (int r = lane; r < R; r += 32) dst[r] = acc[r];
}

__global__ void __launch_bounds__(kGatherThreads)
row_gather_kernel(const float4* __restrict__ x, const int32_t* __restrict__ idx,
                  float4* __restrict__ out, int rows, int k4) {
  const int64_t row = ((int64_t)blockIdx.x * kGatherThreads + threadIdx.x) >> 5;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t src = (int64_t)__ldg(idx + row) * k4;
  for (int c = lane; c < k4; c += 32) {
    out[row * k4 + c] = __ldg(x + src + c);
  }
}

}  // namespace

// Both launch on `stream`, allocate nothing, do not synchronise, and return
// cudaGetLastError() (0 when the launch was accepted).

// tile_ptr (T+1,) int32 slice ranges per tile; local_rows, vals (S·E,);
// contrib (d_sub, S·E) fp32; out (d_sub, T·R) fp32. Local rows in [0, R).
extern "C" int ndcn_sliced_tile_reduce_f32(const void* tile_ptr,
                                           const void* local_rows,
                                           const void* vals,
                                           const void* contrib, void* out,
                                           int n_tiles, int d_sub, int E,
                                           int R, long long n_slots,
                                           void* stream) {
  if (n_tiles > 0 && d_sub > 0) {
    if (E < 1 || R < 1) return (int)cudaErrorInvalidValue;
    const int groups = (d_sub + kReduceWarps - 1) / kReduceWarps;
    const size_t smem = (size_t)kReduceWarps * R * sizeof(float);
    const bool vec = E % 4 == 0 && (((uintptr_t)local_rows | (uintptr_t)vals
                                     | (uintptr_t)contrib) & 15) == 0;
    auto kernel = vec ? sliced_tile_reduce_kernel<true>
                      : sliced_tile_reduce_kernel<false>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<(unsigned)n_tiles * groups, kReduceThreads, smem,
             (cudaStream_t)stream>>>(
        (const int32_t*)tile_ptr, (const int32_t*)local_rows,
        (const float*)vals, (const float*)contrib, (float*)out, d_sub, E, R,
        groups, (int64_t)n_slots, (int64_t)n_tiles * R);
  }
  return (int)cudaGetLastError();
}

// x (m, k) fp32 row-major, idx (rows,) int32 -> out (rows, k); k % 4 == 0.
extern "C" int ndcn_row_gather_f32(const void* x, const void* idx, void* out,
                                   int rows, int k, void* stream) {
  if (rows > 0 && k > 0) {
    const int rows_per_block = kGatherThreads / 32;
    const int blocks = (rows + rows_per_block - 1) / rows_per_block;
    row_gather_kernel<<<blocks, kGatherThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)x, (const int32_t*)idx, (float4*)out, rows, k / 4);
  }
  return (int)cudaGetLastError();
}
