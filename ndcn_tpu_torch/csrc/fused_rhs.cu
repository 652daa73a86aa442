// K2: out (n, k) = relu((A · H) · W + b), dense fp32 in and out.
//
// Replaces the TPU kernel ndcn_tpu/kernels/fused_rhs.py::_kernel, the whole
// learned NDCN right-hand side in one pass, with A·H kept on chip between the
// two products (there jnp.dot at Precision.HIGHEST on the matrix unit).
//
// What bounds it on this card: from a few thousand nodes the n² · 4 bytes of
// A over the memory rate against 3 · 2n²k tensor-core operations (the split
// TF32 product of mma_split.cuh), which cross near k = 100; at the NDCN
// widths (n = 400, k = 20) the launch latency. A CUDA-core fp32 loop reaches
// a tenth of either. So one CTA owns a panel of 16 or 32 rows of A for ALL of
// k and reads its rows from device memory once, in chunks through a cp.async
// ring while the tensor cores work on the chunk before; H's chunks and W
// come from L2. The panel's A·H stays in shared memory and runs through the
// same tile product against W, then + b, relu, store: mma_split.cuh's
// fused_panel, which K4 shares. The panel height, the warps' split of
// columns and depth, and the chunk depth are the host's plan
// (kernels/fused_rhs.py::panel_plan): 16-row panels where n gives fewer than
// a hundred 32-row ones (the other way to fill the card at small n, A·H's
// depth cut across the CTAs of a cluster and folded through distributed
// shared memory, is not taken), the depth of a chunk split over the warps
// where k is narrow, and chunks as deep as shared memory allows.
//
// What holds it back where it still loses to cuBLAS (n · k beyond ~100,000):
// a chunk costs ~400 issue slots a warp (the copies' addresses, the
// fragment loads, three cvt / sub a value, the fold of the fragment) for 24
// to 48 mma, issued by 8 or 16 warps an SM in dependent chains; the tensor
// pipe idles about half of the compute phase and all of the copy phase.
// Copies by TMA and a producer warp, and wgmma for the products, are the
// next steps.
//
// Replicas (the batched entry): R states H (R, n, k) with their own W (R, k,
// k) and b (R, k) against the one shared A, in one launch. gridDim.y is the
// replica; a CTA offsets H, W, b and the output by its replica's strides and
// does exactly the work of a one-replica launch on that slice (the same
// plan, the same sums), so each replica is bit-equal to its own launch.
// A's panel is read once per replica, from L2 after the first.
//
// The ragged edges of n and k are zero-filled in the staging copies and
// masked in the store; nothing is padded in device memory. Sums have a fixed
// order, no atomics: two calls agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_split.cuh"

namespace {

using namespace ndcn;

// Chunk c of a row panel: columns [c·bk, c·bk + bk) of A's rows and the same
// rows of H.
struct DenseSource {
  const float* a;   // the panel's first row
  const float* h;
  int n, k, bk, rows;
  __device__ __forceinline__ int depth(int c) const {
    return min(bk, n - c * bk);
  }
  __device__ __forceinline__ Chunk chunk(int c) const {
    const int k0 = c * bk;
    return Chunk{a + k0, n, rows, depth(c), h + (int64_t)k0 * k, k, depth(c)};
  }
};

template <int MT, int NT>
__global__ void __launch_bounds__(kMmaThreads)
fused_rhs_kernel(const float* __restrict__ a, const float* __restrict__ h,
                 const float* __restrict__ w, const float* __restrict__ b,
                 float* __restrict__ out, int n, Layout L, int64_t w_rs,
                 int64_t w_cs, bool a_vec, bool h_vec, bool w_vec,
                 int64_t w_bs) {
  extern __shared__ __align__(16) float smem[];
  const int64_t rep = blockIdx.y;  // the replica: its H, W, b and output
  h += rep * n * L.width;
  w += rep * w_bs;
  b += rep * L.width;
  out += rep * n * L.width;
  constexpr int BM = 16 * MT;
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  const int rows = (int)min((int64_t)BM, n - row0);
  const DenseSource src{a + row0 * n, h, n, L.width, L.bk, rows};
  fused_panel<MT, NT>(smem, L, src, (n + L.bk - 1) / L.bk, a_vec, h_vec, w,
                      w_rs, w_cs, w_vec, b, out + row0 * L.width, rows);
}

template <int MT, int NT>
int launch(const float* a, const float* h, const float* w, const float* b,
           float* out, int n, const Layout& L, size_t smem, int64_t w_rs,
           int64_t w_cs, int replicas, int64_t w_bs, cudaStream_t stream) {
  auto kernel = fused_rhs_kernel<MT, NT>;
  if (smem > 48 * 1024) {  // beyond the default only after opt-in
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int k = L.width;
  const dim3 blocks((n + 16 * MT - 1) / (16 * MT), replicas);
  kernel<<<blocks, kMmaThreads, smem, stream>>>(
      a, h, w, b, out, n, L, w_rs, w_cs, n % 4 == 0 && aligned16(a),
      k % 4 == 0 && aligned16(h),
      w_vec(w, w_rs, w_cs) && (replicas == 1 || w_bs % 4 == 0), w_bs);
  return (int)cudaGetLastError();
}

}  // namespace

namespace {

int launch_plan(const void* a, const void* h, const void* w, const void* b,
                void* out, int n, int k, long long w_rs, long long w_cs,
                int rows, int nt, int wn, int bk, long long smem_bytes,
                int replicas, long long w_bs, void* stream) {
  if (n <= 0 || k <= 0 || replicas <= 0) return (int)cudaGetLastError();
  Layout L;
  size_t smem = 0;
  if (replicas > 65535 || !make_layout(&L, &smem, rows, nt, wn, bk, k) ||
      (long long)smem != smem_bytes) {
    return (int)cudaErrorInvalidValue;
  }
#define NDCN_K2_CASE(MT, NT)                                                 \
  if (rows == 16 * MT && nt == NT)                                           \
    return launch<MT, NT>((const float*)a, (const float*)h, (const float*)w, \
                          (const float*)b, (float*)out, n, L, smem,          \
                          (int64_t)w_rs, (int64_t)w_cs, replicas,            \
                          (int64_t)w_bs, (cudaStream_t)stream)
  NDCN_K2_CASE(1, 4);
  NDCN_K2_CASE(2, 4);
  NDCN_K2_CASE(1, 8);
  NDCN_K2_CASE(2, 8);
  NDCN_K2_CASE(1, 16);
#undef NDCN_K2_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream`, allocates nothing and does not synchronise. Returns
// cudaGetLastError() (0 when the launch was accepted), or
// cudaErrorInvalidValue for a plan the kernel does not take.
// w may be strided (nn.Linear's weight transposed is a view): element
// (i, j) of W is w[i * w_rs + j * w_cs]. rows, nt, wn, bk and smem_bytes
// are the host's plan (panel height, n8 tiles a warp, warps across the
// columns, chunk depth, dynamic shared memory).
extern "C" int ndcn_fused_rhs_f32(const void* a, const void* h, const void* w,
                                  const void* b, void* out, int n, int k,
                                  long long w_rs, long long w_cs, int rows,
                                  int nt, int wn, int bk,
                                  long long smem_bytes, void* stream) {
  return launch_plan(a, h, w, b, out, n, k, w_rs, w_cs, rows, nt, wn, bk,
                     smem_bytes, 1, 0, stream);
}

// The batched form: h and out are `replicas` contiguous (n, k) states one
// after another, b `replicas` rows of k, and replica r's W starts w_bs
// floats after replica r - 1's (the same strides within).
extern "C" int ndcn_fused_rhs_batched_f32(
    const void* a, const void* h, const void* w, const void* b, void* out,
    int n, int k, long long w_rs, long long w_cs, int rows, int nt, int wn,
    int bk, long long smem_bytes, int replicas, long long w_bs,
    void* stream) {
  return launch_plan(a, h, w, b, out, n, k, w_rs, w_cs, rows, nt, wn, bk,
                     smem_bytes, replicas, w_bs, stream);
}
