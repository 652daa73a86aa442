// Shared by the CSR SpMV kernels (K1 row-major, K1-fm, K5): how one edge's
// value and one gathered state value are read in fp32 and bf16 modes.
#pragma once

#include <cuda_bf16.h>

namespace ndcn {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The value of A for an edge. In bf16 mode the TPU kernel folds vals into
// its bf16 one-hot, so the value is rounded to bf16 (nearest even, as
// torch's .to(torch.bfloat16)); the product with a bf16 state value is then
// exact in fp32.
template <typename T>
__device__ __forceinline__ float edge_val(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float edge_val<__nv_bfloat16>(const float* p) {
  return __bfloat162float(__float2bfloat16_rn(__ldg(p)));
}

}  // namespace ndcn
