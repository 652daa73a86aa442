// K1-w: the mutualistic interaction over a CSR matrix A, forward and
// backward, fp32.
//
//   forward   y[r]  = sum over edges (r, c, v) of v · p(x[r], x[c])
//             p(a, b) = a b / D,  D = dd + e a + h b
//   backward  dx[j] = sum over A's row j of
//                       v · g[j] · x[c] (dd + h x[c]) / D²      (row side)
//                   + sum over Aᵀ's row j, i.e. A's edges (i, j), of
//                       v · g[i] · x[i] (dd + e x[i]) / D'²     (column side)
//                     with D' = dd + e x[i] + h x[j]
//
// per feature m, with a zero denominator divided as 1 (the padding slots
// of the TPU's tiles made that guard necessary; the JAX package keeps it).
//
// Replaces the TPU kernel ndcn_tpu/kernels/coo_spmv.py::_make_kernel
// (seg_kernel, pl.pallas_call at :314) as ndcn_tpu/dynamics/rhs.py:109
// (_tiled_weighted_reduce) drives it for the mutualistic COO interaction:
// there the pair term is evaluated per tile slot into a feature-major
// (d, S·E) array in device memory and the Pallas kernel reduces it with a
// one-hot matmul. Here the term is evaluated in registers as the edges are
// walked, and nothing of size nnz · d touches device memory.
//
// Two forms, which the host picks by width (kernels/coo_mutual.py,
// mutual_plan): the edge form (coo_mutual_edges.cu) up to d = 8, the warp
// form (coo_mutual.cu) above. In either form the backward is two calls:
// the row side over A's CSR writes dx, the column side over the transpose
// CSR (whose columns are A's rows, so the cotangent is gathered there)
// adds to it, row by row. No atomics: the order of every sum follows from
// (operator, d), so two calls agree bit for bit. fp32 only: the JAX
// package runs this physics on the CPU backend, where its tiled bf16
// splits never engage.

#pragma once

namespace ndcn {
namespace mutual {

// the three sums the kernels compute
enum Side { kForward = 0, kRowSide = 1, kColumnSide = 2 };

struct Coef {
  float d, e, h;
};

__device__ __forceinline__ float safe_div(float num, float den) {
  return num / (den == 0.0f ? 1.0f : den);
}

}  // namespace mutual
}  // namespace ndcn
