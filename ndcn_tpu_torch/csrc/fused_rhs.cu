// K2: out (n, k) = relu((A · H) · W + b), dense fp32.
//
// Replaces the TPU kernel ndcn_tpu/kernels/fused_rhs.py::_kernel, the whole
// learned NDCN right-hand side in one pass, with A·H kept on chip between the
// two products. Here each block takes a panel of 32 rows of A:
//
// - Phase 1 loops over A's columns in chunks of 32, staging the A tile and
//   the matching H chunk in shared memory; each thread keeps 1 row x 4
//   columns of the panel's A·H in registers. The finished panel goes to
//   shared memory (32 x k floats, row stride odd to spread banks), never to
//   device memory. Widths above 32 repeat phase 1 per 32-column slab.
// - Phase 2 multiplies the panel by W, staged through the same shared tile
//   in 32 x 32 chunks, adds b, applies relu and stores.
//
// Arithmetic is fp32 FMA, not TF32, to match the TPU kernel's
// Precision.HIGHEST. The ragged edges of n and k are masked in the loads and
// stores; nothing is padded in device memory.
//
// Bound: at the NDCN widths (n = 400, k = 20) the work is ~6.4 MFLOP and the
// launch latency dominates. For large n it reads A once per 32-column slab of
// H (n²·4 bytes each) and does 2·n²·k FLOP in CUDA-core fp32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 32;       // rows of A per block
constexpr int kBK = 32;       // depth of one staged chunk
constexpr int kKT = 32;       // output columns per slab
constexpr int kThreads = 256; // ty = tid / 8 picks the row, tx = tid % 8 four columns

__global__ void __launch_bounds__(kThreads)
fused_rhs_kernel(const float* __restrict__ a, const float* __restrict__ h,
                 const float* __restrict__ w, const float* __restrict__ b,
                 float* __restrict__ out, int n, int k, int ks,
                 int64_t w_rs, int64_t w_cs) {
  extern __shared__ float ah_s[];       // [kBM][ks]: the panel's A·H
  __shared__ float a_s[kBM][kBK + 1];   // +1: rows land in distinct banks
  __shared__ float t_s[kBK][kKT];       // H chunk (phase 1) or W chunk (phase 2)

  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int row0 = blockIdx.x * kBM;
  const int64_t row = (int64_t)row0 + ty;

  // Phase 1: ah_s = A[row0:row0 + kBM, :] · H
  for (int c0 = 0; c0 < k; c0 += kKT) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < n; k0 += kBK) {
      for (int i = tid; i < kBM * kBK; i += kThreads) {
        const int r = i / kBK, c = i % kBK;
        const int64_t gr = (int64_t)row0 + r;
        const int gc = k0 + c;
        a_s[r][c] = (gr < n && gc < n) ? a[gr * n + gc] : 0.0f;
      }
      for (int i = tid; i < kBK * kKT; i += kThreads) {
        const int r = i / kKT, c = i % kKT;
        const int64_t gr = (int64_t)k0 + r;
        const int gc = c0 + c;
        t_s[r][c] = (gr < n && gc < k) ? h[gr * k + gc] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float av = a_s[ty][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j] = fmaf(av, t_s[kk][tx * 4 + j], acc[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c < k) ah_s[ty * ks + c] = acc[j];
    }
  }
  __syncthreads();

  // Phase 2: out = relu(ah_s · W + b)
  for (int c0 = 0; c0 < k; c0 += kKT) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int m0 = 0; m0 < k; m0 += kBK) {
      for (int i = tid; i < kBK * kKT; i += kThreads) {
        const int r = i / kKT, c = i % kKT;
        const int gr = m0 + r, gc = c0 + c;
        t_s[r][c] = (gr < k && gc < k) ? w[gr * w_rs + gc * w_cs] : 0.0f;
      }
      __syncthreads();
      const int m_end = min(kBK, k - m0);
      for (int mm = 0; mm < m_end; ++mm) {
        const float av = ah_s[ty * ks + m0 + mm];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j] = fmaf(av, t_s[mm][tx * 4 + j], acc[j]);
        }
      }
      __syncthreads();
    }
    if (row < n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx * 4 + j;
        if (c < k) out[row * k + c] = fmaxf(acc[j] + b[c], 0.0f);
      }
    }
  }
}

}  // namespace

// Launches on `stream`, allocates nothing and does not synchronise. Returns
// cudaGetLastError() (0 when the launch was accepted).
// w may be strided (nn.Linear's weight transposed is a view): element
// (i, j) of W is w[i * w_rs + j * w_cs].
extern "C" int ndcn_fused_rhs_f32(const void* a, const void* h, const void* w,
                                  const void* b, void* out, int n, int k,
                                  long long w_rs, long long w_cs,
                                  void* stream) {
  if (n > 0 && k > 0) {
    const int ks = (k % 2 == 0) ? k + 1 : k;  // odd stride: rows in distinct banks
    const size_t smem = sizeof(float) * (size_t)kBM * ks;
    if (smem > 32 * 1024) {
      // beyond the default 48 KB (with the static tiles) only after opt-in
      cudaError_t err = cudaFuncSetAttribute(
          fused_rhs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const int blocks = (n + kBM - 1) / kBM;
    fused_rhs_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)h, (const float*)w, (const float*)b,
        (float*)out, n, k, ks, (int64_t)w_rs, (int64_t)w_cs);
  }
  return (int)cudaGetLastError();
}
