// The kernels of the sparse microbenchmarks (ndcn_tpu_torch/tools/).
//
// P1a, the sliced-tile reduce, replaces the Pallas kernel of
// tools/microbench_sparse.py:235 (seg_kernel, :210-222): pre-gathered
// feature-major contribs (d_sub, S·E) are reduced into (d_sub, R) output
// tiles, out[f, tile·R + lr[e]] += contrib[f, e] · vals[e], over row-sorted
// slices of E edge slots; a tile's slices are consecutive. The TPU ran the
// slices as a sequential grid, kept the output tile in VMEM and reduced each
// slice with a one-hot matmul. Here one CTA owns one row tile and walks its
// slices itself (tile_ptr gives them; the TPU's `first` flag becomes the
// start of that walk):
// - the (d_sub × R) accumulator lives in shared memory (12 KB at d_sub 24,
//   R 128), zeroed once and written to device memory once, coalesced;
// - each slice's local rows and values are staged in shared memory; thread
//   (r, f-group) scans them in slot order and adds the slots of its row r,
//   so every sum has the slot order (the one-hot contraction's order) and
//   no atomics are needed. The scan is E compares per thread and slice: the
//   one-hot matmul's selection, done by compares instead of an MXU pass.
// Bound: the scan (E · R compares per slice) and the contrib reads, which
// are d_sub separate 4-byte reads per slot.
//
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

constexpr int kReduceThreads = 256;
constexpr int kGatherThreads = 256;  // 8 output rows per block

__global__ void __launch_bounds__(kReduceThreads)
sliced_tile_reduce_kernel(const int32_t* __restrict__ tile_ptr,
                          const int32_t* __restrict__ local_rows,
                          const float* __restrict__ vals,
                          const float* __restrict__ contrib,
                          float* __restrict__ out, int d_sub, int E, int R,
                          int64_t n_slots, int64_t n_pad) {
  extern __shared__ unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);            // (d_sub, R)
  int32_t* lr_s = reinterpret_cast<int32_t*>(acc + d_sub * R);
  float* v_s = reinterpret_cast<float*>(lr_s + E);
  const int tile = blockIdx.x;
  const int r = threadIdx.x % R;
  const int f_group = threadIdx.x / R;
  const int f_groups = kReduceThreads / R;

  for (int f = f_group; f < d_sub; f += f_groups) {
    acc[f * R + r] = 0.0f;
  }
  for (int s = tile_ptr[tile]; s < tile_ptr[tile + 1]; ++s) {
    const int64_t base = (int64_t)s * E;
    __syncthreads();  // the previous slice's scan is done with lr_s / v_s
    for (int e = threadIdx.x; e < E; e += kReduceThreads) {
      lr_s[e] = local_rows[base + e];
      v_s[e] = vals[base + e];
    }
    __syncthreads();
    for (int e = 0; e < E; ++e) {
      if (lr_s[e] == r) {
        const float v = v_s[e];
        for (int f = f_group; f < d_sub; f += f_groups) {
          acc[f * R + r] = fmaf(contrib[(int64_t)f * n_slots + base + e], v,
                                acc[f * R + r]);
        }
      }
    }
  }
  const int64_t col = (int64_t)tile * R + r;
  for (int f = f_group; f < d_sub; f += f_groups) {
    out[(int64_t)f * n_pad + col] = acc[f * R + r];
  }
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
// contrib (d_sub, S·E) fp32; out (d_sub, T·R) fp32. R must divide 256.
extern "C" int ndcn_sliced_tile_reduce_f32(const void* tile_ptr,
                                           const void* local_rows,
                                           const void* vals,
                                           const void* contrib, void* out,
                                           int n_tiles, int d_sub, int E,
                                           int R, long long n_slots,
                                           void* stream) {
  if (n_tiles > 0 && d_sub > 0) {
    const size_t smem = (size_t)d_sub * R * sizeof(float)
        + (size_t)E * (sizeof(int32_t) + sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        sliced_tile_reduce_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    sliced_tile_reduce_kernel<<<n_tiles, kReduceThreads, smem,
                                (cudaStream_t)stream>>>(
        (const int32_t*)tile_ptr, (const int32_t*)local_rows,
        (const float*)vals, (const float*)contrib, (float*)out, d_sub, E, R,
        (int64_t)n_slots, (int64_t)n_tiles * R);
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
