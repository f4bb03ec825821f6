// One element of the GSPN scan and of its adjoint, shared by every kernel
// of gspn_pair.cu so that each computes an element by the same
// instructions.
//
// The chains are written with explicit round-to-nearest intrinsics, which
// nvcc never contracts or reorders: the result does not depend on how the
// compiler would have fused a plain `a*b + c*d + ...` in each kernel's own
// context, so the single, pair and quad kernels agree bit for bit on shared
// directions, and the pair adjoint agrees with the single adjoint, banded
// or not.

#pragma once

#include <cuda_bf16.h>

namespace gspn {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// h[i,j] = wl*h[p,j-1] + wc*h[p,j] + wr*h[p,j+1] + lam*x[i,j], evaluated left
// to right with each later product fused into the running sum.
__device__ __forceinline__ float scan_cell(float wl, float left, float wc, float hp, float wr,
                                           float right, float lam, float x) {
  return __fmaf_rn(lam, x, __fmaf_rn(wr, right, __fmaf_rn(wc, hp, __fmul_rn(wl, left))));
}

// g[i,j] = dy[i,j] + Pl[j+1] + Pc[j] + Pr[j-1], left to right.
__device__ __forceinline__ float adjoint_cell(float dy, float pl_right, float pc, float pr_left) {
  return __fadd_rn(__fadd_rn(__fadd_rn(dy, pl_right), pc), pr_left);
}

}  // namespace gspn
