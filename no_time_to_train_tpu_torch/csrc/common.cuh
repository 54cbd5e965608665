// Shared helpers for the hand-written Hopper kernels of the port.
//
// Every kernel is templated on its storage type T (float or __nv_bfloat16)
// and computes in float. `Num<T>::round` rounds a float to T's precision and
// back: the kernels call it exactly where the JAX package casts to the
// compute dtype, so the bf16 kernels reproduce the reference's cast points
// and the float kernels reduce to plain float32 arithmetic.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

template <typename T> struct Num;

template <> struct Num<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static constexpr bool is_bf16 = false;
};

template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static constexpr bool is_bf16 = true;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm affine step with the cast points of the JAX package's
// `_layer_norm` compute-dtype branch: (x - mu.T) * inv.T, then * w + b,
// rounding to T after every operation. `x`, `w`, `b` already hold T values.
template <typename T>
__device__ __forceinline__ float ln_affine(float x, float mu, float inv,
                                           float w, float b) {
  float t = Num<T>::round(x - Num<T>::round(mu));
  t = Num<T>::round(t * Num<T>::round(inv));
  t = Num<T>::round(t * w);
  return Num<T>::round(t + b);
}

// GELU as the fused decoder kernels apply it: the tanh form in bf16, the
// exact erf form in float32.
template <typename T>
__device__ __forceinline__ float gelu_act(float x) {
  if (Num<T>::is_bf16) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * (x * x * x))));
  }
  return x * 0.5f * (1.0f + erff(x * 0.7071067811865476f));
}

// One warp: C[16, 16*NT] = A[16, K] @ B[K, 16*NT] on the tensor cores
// (bf16 operands in shared memory, float32 accumulation), K a multiple of
// 16. A, B and C point at the strip's first element; lda, ldb, ldc are row
// strides in elements (multiples of 8, 8 and 4; pointers 32-byte aligned).
template <int NT>
__device__ __forceinline__ void warp_gemm_bf16(const __nv_bfloat16* A,
                                               int lda,
                                               const __nv_bfloat16* B,
                                               int ldb, int K, float* C,
                                               int ldc) {
  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) wmma::fill_fragment(acc[t], 0.0f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
  for (int k = 0; k < K; k += 16) {
    wmma::load_matrix_sync(a, A + k, lda);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      wmma::load_matrix_sync(b, B + (size_t)k * ldb + 16 * t, ldb);
      wmma::mma_sync(acc[t], a, b, acc[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
    wmma::store_matrix_sync(C + 16 * t, acc[t], ldc, wmma::mem_row_major);
}

// Copy n bf16 values (n a multiple of 8, both pointers 16-byte aligned) in
// 16-byte pieces, all threads of the block taking part; values from `valid`
// on (a multiple of 8) are not read and written as zeros.
__device__ __forceinline__ void copy_bf16(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int n,
                                          int valid) {
  const uint4* s = (const uint4*)src;
  uint4* d = (uint4*)dst;
  for (int i = threadIdx.x; i < n / 8; i += blockDim.x)
    d[i] = i < valid / 8 ? s[i] : make_uint4(0u, 0u, 0u, 0u);
}

#define NTTT_DTYPE_F32 0
#define NTTT_DTYPE_BF16 1
