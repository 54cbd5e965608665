// Row LayerNorm over the last axis.
//
// Replaces the Pallas kernel `layer_norm_pallas` / `_ln_kernel`
// (no_time_to_train_tpu/ops/fused_ln.py). Gate, applied by the caller
// (models/sam2/common.py `_layer_norm`): bf16 compute, at least 1024 rows,
// 16 <= C, and not inside `no_fusion()`; this kernel takes C <= 2048 and
// float32 or bf16. The TPU's rows % 8 sublane rule does not apply here.
//
// Numerics: float32 mean and two-pass variance, then the compute-dtype
// normalize and affine with the reference's cast points (`ln_affine`).
//
// Bound: device-memory bandwidth. One warp owns one row and keeps it in
// registers (at most 64 values a lane), so each element is read once and
// written once; the float32 intermediates never reach device memory.
#include "common.cuh"

namespace {

constexpr int kMaxPerLane = 64;  // C <= 32 * 64 = 2048

template <typename T>
__global__ void __launch_bounds__(256)
ln_rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ b, T* __restrict__ y, int rows, int cols,
               float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * cols;
  T* yr = y + (size_t)row * cols;
  float v[kMaxPerLane];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int c = lane + 32 * k;
    v[k] = c < cols ? Num<T>::to_f(xr[c]) : 0.f;
    s += v[k];
  }
  const float mu = warp_sum(s) / cols;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int c = lane + 32 * k;
    const float d = v[k] - mu;
    q += c < cols ? d * d : 0.f;
  }
  const float inv = rsqrtf(warp_sum(q) / cols + eps);
#pragma unroll
  for (int k = 0; k < kMaxPerLane; ++k) {
    const int c = lane + 32 * k;
    if (c < cols)
      yr[c] = Num<T>::from_f(ln_affine<T>(v[k], mu, inv, Num<T>::to_f(w[c]),
                                          Num<T>::to_f(b[c])));
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int rows,
           int cols, float eps, cudaStream_t stream) {
  const int threads = 256;  // 8 rows a block
  const int blocks = (rows + 7) / 8;
  ln_rows_kernel<T><<<blocks, threads, 0, stream>>>(
      (const T*)x, (const T*)w, (const T*)b, (T*)y, rows, cols, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nttt_layer_norm(const void* x, const void* w, const void* b,
                               void* y, int rows, int cols, float eps,
                               int dtype, void* stream) {
  if (cols > 32 * kMaxPerLane || cols < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == NTTT_DTYPE_BF16)
    return launch<__nv_bfloat16>(x, w, b, y, rows, cols, eps, s);
  return launch<float>(x, w, b, y, rows, cols, eps, s);
}
