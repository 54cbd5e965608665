// Row LayerNorm over the last axis.
//
// Replaces the Pallas kernel `layer_norm_pallas` / `_ln_kernel`
// (no_time_to_train_tpu/ops/fused_ln.py). Gate, applied by the caller
// (models/sam2/common.py `_layer_norm`): bf16 compute, at least 1024 rows,
// 16 <= C <= 8192, and not inside `no_fusion()`; this kernel takes C <= 2048
// in float32 and C <= 8192 in bf16. The TPU's rows % 8 sublane rule does not
// apply here.
//
// Numerics: float32 mean and two-pass variance, then the compute-dtype
// normalize and affine with the reference's cast points (`ln_affine`).
//
// Bound on this card: device-memory bandwidth, each element read once and
// written once (C on the path: 144 / 288 / 576 / 1152 for Hiera-L's stages,
// 1024 for DINO-L, 4096 for DINOv3-7B, 256 for the decoder tokens and memory
// attention).
//
// bf16: `ln_slab_kernel`. Rows are contiguous, so a block owns a slab of R
// consecutive rows (at most 16 KB; fewer rows where that leaves under four
// blocks an SM) and moves it with 16-byte `cp.async` loads and 16-byte
// stores, coalesced whatever C is; weight and bias are staged beside it once
// a block. A group of G lanes (4 to 32, so that a lane takes 2 to 4 pieces of
// 8 values) takes a row: two-pass statistics from shared memory with
// shuffles inside the group, then the normalized row goes back into the slab
// before the block stores it. Where C % 8 != 0 or a pointer is not 16-byte
// aligned the same kernel moves single elements.
//
// bf16 rows wider than 2048 (DINOv3-7B's 4096), up to 8192: `ln_wide_kernel`,
// one block of 128 threads a row, the row held in registers as packed bf16
// (P pieces of 8 values a thread, P = 4 up to C 4096, else 8) and moved with
// 16-byte loads and stores; one block a row puts every row of a 1374-row call
// in flight in one wave, where the slab kernel would stage them through 16 KB
// of shared memory two at a time. Where C % 8 != 0 or a pointer is not
// 16-byte aligned, the slab kernel's single-element path with one row a
// block. Rows of C <= 2048 take the slab kernel as before.
//
// float32, and the `nttt_layer_norm_warp` check route for either dtype:
// `ln_rows_kernel`, the first port's body (one warp a row, the row in
// registers, 2-byte loads at a lane stride).
#include "common.cuh"
#include "mma_tile.cuh"

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


using mma::bf16;
constexpr int kSlabBytes = 16384;
constexpr int kSlabThreads = 256;

__device__ __forceinline__ float group_sum(float v, int g) {
  for (int o = g >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 8 values of a 16-byte piece
__device__ __forceinline__ void unpack8(const bf16* p, float (&v)[8]) {
  const uint4 u = *(const uint4*)p;
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// Block b owns rows [b R, b R + R); a group of G lanes a row, the block's
// groups over its rows in turns (the turns are the same for every lane, so
// the group shuffles see the whole warp). kVec: 16-byte pieces, else single
// elements.
template <bool kVec>
__global__ void __launch_bounds__(kSlabThreads)
ln_slab_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const bf16* __restrict__ b, bf16* __restrict__ y, int rows,
               int cols, int R, int G, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* slab = (bf16*)smem_raw;     // [R, cols]
  bf16* w_s = slab + R * cols;
  bf16* b_s = w_s + cols;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int row0 = blockIdx.x * R;
  const int nr = min(R, rows - row0);
  const long long base = (long long)row0 * cols;
  const int count = nr * cols;
  if (kVec) {
    for (int i = 8 * tid; i < count; i += 8 * nt)
      mma::cp_async16(slab + i, x + base + i, true);
    for (int i = 8 * tid; i < cols; i += 8 * nt) {
      mma::cp_async16(w_s + i, w + i, true);
      mma::cp_async16(b_s + i, b + i, true);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
  } else {
    for (int i = tid; i < count; i += nt) slab[i] = x[base + i];
    for (int i = tid; i < cols; i += nt) {
      w_s[i] = w[i];
      b_s[i] = b[i];
    }
  }
  __syncthreads();

  const int lig = tid % G, ngrp = nt / G;
  const int per = kVec ? cols / 8 : cols;   // pieces of a row
  const int turns = (nr + ngrp - 1) / ngrp;
  for (int it = 0; it < turns; ++it) {
    const int r = tid / G + it * ngrp;
    const bool live = r < nr;
    bf16* row = slab + (live ? r : 0) * cols;
    float s = 0.f;
    if (live)
      for (int u = lig; u < per; u += G) {
        if (kVec) {
          float v[8];
          unpack8(row + 8 * u, v);
#pragma unroll
          for (int k = 0; k < 8; ++k) s += v[k];
        } else {
          s += __bfloat162float(row[u]);
        }
      }
    const float mu = group_sum(s, G) / cols;
    float q = 0.f;
    if (live)
      for (int u = lig; u < per; u += G) {
        if (kVec) {
          float v[8];
          unpack8(row + 8 * u, v);
#pragma unroll
          for (int k = 0; k < 8; ++k) q += (v[k] - mu) * (v[k] - mu);
        } else {
          const float d = __bfloat162float(row[u]) - mu;
          q += d * d;
        }
      }
    const float inv = rsqrtf(group_sum(q, G) / cols + eps);
    if (live)
      for (int u = lig; u < per; u += G) {
        if (kVec) {
          float v[8], wv[8], bv[8];
          unpack8(row + 8 * u, v);
          unpack8(w_s + 8 * u, wv);
          unpack8(b_s + 8 * u, bv);
          uint4 o;
          uint32_t* op = (uint32_t*)&o;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            op[k] = mma::pack_bf16(
                ln_affine<bf16>(v[2 * k], mu, inv, wv[2 * k], bv[2 * k]),
                ln_affine<bf16>(v[2 * k + 1], mu, inv, wv[2 * k + 1],
                                bv[2 * k + 1]));
          *(uint4*)(row + 8 * u) = o;
        } else {
          row[u] = __float2bfloat16_rn(ln_affine<bf16>(
              __bfloat162float(row[u]), mu, inv, __bfloat162float(w_s[u]),
              __bfloat162float(b_s[u])));
        }
      }
  }
  __syncthreads();
  if (kVec) {
    for (int i = 8 * tid; i < count; i += 8 * nt)
      *(uint4*)(y + base + i) = *(const uint4*)(slab + i);
  } else {
    for (int i = tid; i < count; i += nt) y[base + i] = slab[i];
  }
}

int launch_slab(const void* x, const void* w, const void* b, void* y,
                int rows, int cols, float eps, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const bool vec = cols % 8 == 0 &&
                   (((uintptr_t)x | (uintptr_t)w | (uintptr_t)b |
                     (uintptr_t)y) & 15) == 0;
  const int per = vec ? cols / 8 : cols;
  int G = 4;
  while (G < 32 && per >= 4 * G) G *= 2;
  const int max_r = kSlabBytes / (2 * cols) > 1 ? kSlabBytes / (2 * cols) : 1;
  const int want = (rows + 4 * sms - 1) / (4 * sms);
  const int R = want < 1 ? 1 : (want < max_r ? want : max_r);
  int threads = (R * G + 31) / 32 * 32;
  if (threads > kSlabThreads) threads = kSlabThreads;
  const size_t smem = sizeof(bf16) * ((size_t)R * cols + 2 * cols);
  const int blocks = (rows + R - 1) / R;
  if (vec)
    ln_slab_kernel<true><<<blocks, threads, smem, stream>>>(
        (const bf16*)x, (const bf16*)w, (const bf16*)b, (bf16*)y, rows, cols,
        R, G, eps);
  else
    ln_slab_kernel<false><<<blocks, threads, smem, stream>>>(
        (const bf16*)x, (const bf16*)w, (const bf16*)b, (bf16*)y, rows, cols,
        R, G, eps);
  return (int)cudaGetLastError();
}

constexpr int kWideThreads = 128;
constexpr int kMaxWideCols = 8192;  // 128 threads x 8 pieces of 8 values
static_assert(kMaxWideCols == kWideThreads * 8 * 8, "ln_wide_kernel<8>");

// The sum over the block's threads, returned to every thread; `red` holds
// one partial a warp.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kWideThreads / 32; ++i) t += red[i];
  __syncthreads();  // every thread has read red before it is written again
  return t;
}

// 8 values of a piece held in registers
__device__ __forceinline__ void unpack8(const uint4 u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// Row blockIdx.x; thread t holds pieces t, t + 128, ... (P of them, those
// below cols / 8 live) as packed bf16 and unpacks them in each pass.
template <int P>
__global__ void __launch_bounds__(kWideThreads)
ln_wide_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const bf16* __restrict__ b, bf16* __restrict__ y, int cols,
               float eps) {
  __shared__ float red[kWideThreads / 32];
  const long long base = (long long)blockIdx.x * cols;
  const int per = cols / 8;
  uint4 raw[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int u = threadIdx.x + k * kWideThreads;
    if (u < per) raw[k] = *(const uint4*)(x + base + 8 * u);
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (threadIdx.x + k * kWideThreads < per) {
      float v[8];
      unpack8(raw[k], v);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += v[j];
    }
  }
  const float mu = block_sum(s, red) / cols;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (threadIdx.x + k * kWideThreads < per) {
      float v[8];
      unpack8(raw[k], v);
#pragma unroll
      for (int j = 0; j < 8; ++j) q += (v[j] - mu) * (v[j] - mu);
    }
  }
  const float inv = rsqrtf(block_sum(q, red) / cols + eps);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int u = threadIdx.x + k * kWideThreads;
    if (u < per) {
      float v[8], wv[8], bv[8];
      unpack8(raw[k], v);
      unpack8(w + 8 * u, wv);
      unpack8(b + 8 * u, bv);
      uint4 o;
      uint32_t* op = (uint32_t*)&o;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        op[j] = mma::pack_bf16(
            ln_affine<bf16>(v[2 * j], mu, inv, wv[2 * j], bv[2 * j]),
            ln_affine<bf16>(v[2 * j + 1], mu, inv, wv[2 * j + 1],
                            bv[2 * j + 1]));
      *(uint4*)(y + base + 8 * u) = o;
    }
  }
}

int launch_wide(const void* x, const void* w, const void* b, void* y,
                int rows, int cols, float eps, cudaStream_t stream) {
  const bool vec = cols % 8 == 0 &&
                   (((uintptr_t)x | (uintptr_t)w | (uintptr_t)b |
                     (uintptr_t)y) & 15) == 0;
  if (!vec) {
    // one row a block through shared memory: 2 (C + 2 C) bytes <= 48 KB
    const size_t smem = sizeof(bf16) * 3 * (size_t)cols;
    ln_slab_kernel<false><<<rows, 32, smem, stream>>>(
        (const bf16*)x, (const bf16*)w, (const bf16*)b, (bf16*)y, rows, cols,
        1, 32, eps);
  } else if (cols <= kWideThreads * 8 * 4) {
    ln_wide_kernel<4><<<rows, kWideThreads, 0, stream>>>(
        (const bf16*)x, (const bf16*)w, (const bf16*)b, (bf16*)y, cols, eps);
  } else {
    ln_wide_kernel<8><<<rows, kWideThreads, 0, stream>>>(
        (const bf16*)x, (const bf16*)w, (const bf16*)b, (bf16*)y, cols, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: [rows, cols] contiguous; w, b: [cols]; 1 <= cols <= 2048, and in
// bf16 up to 8192. bf16 takes the row-slab kernel up to 2048 and the
// wide-row kernel above, float32 the first port's body.
extern "C" int nttt_layer_norm(const void* x, const void* w, const void* b,
                               void* y, int rows, int cols, float eps,
                               int dtype, void* stream) {
  const int max_cols =
      dtype == NTTT_DTYPE_BF16 ? kMaxWideCols : 32 * kMaxPerLane;
  if (cols > max_cols || cols < 1 || rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == NTTT_DTYPE_BF16)
    return cols > 32 * kMaxPerLane
               ? launch_wide(x, w, b, y, rows, cols, eps, s)
               : launch_slab(x, w, b, y, rows, cols, eps, s);
  return launch<float>(x, w, b, y, rows, cols, eps, s);
}

// The first port's body for either dtype: the parent the bf16 kernel is
// checked and timed against.
extern "C" int nttt_layer_norm_warp(const void* x, const void* w,
                                    const void* b, void* y, int rows,
                                    int cols, float eps, int dtype,
                                    void* stream) {
  if (cols > 32 * kMaxPerLane || cols < 1 || rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == NTTT_DTYPE_BF16)
    return launch<__nv_bfloat16>(x, w, b, y, rows, cols, eps, s);
  return launch<float>(x, w, b, y, rows, cols, eps, s);
}
