// SAM2 mask-decoder upscale chain fused with the hypernetwork product.
//
// Replaces the Pallas kernels `_from_src_kernel` (k1mat given) and
// `_post_t1_kernel` (k1mat=None: the chain from the raw first-deconv output
// on) reached from `fused_post_t1` (out_16pt) in
// no_time_to_train_tpu/ops/upscale_product.py.
//
// Per prompt b and image position (d = 256, c1 = 64, c2 = 32):
//   t1 = src @ K1 + s1p                     [4 * c1], cols (dy1, dx1, c1)
//   u  = GELU(LayerNorm_c1(t1) * w + b).T   per 64-wide segment, eps given
//   t2 = u_q @ K2 + s0p                     four K = c1 products, [16 * c2]
//   g  = GELU(t2).T
//   out[b, k, pos] = sum_c hyper[b, c].T * g[k * c2 + c]    k = 0..15
// s1p and s0p are the skip features with the deconv biases already added,
// one set per image: prompt b reads image b / ppi. With kFromT1 the first
// product is left out and `src` holds t1 [B, hw, 4 * c1] in the storage
// type (the Pallas body adds s1p to it in float32 likewise).
// GELU is the tanh form in bf16 and the erf form in float32, as the Pallas
// kernel applies it. LayerNorm statistics are float32 two-pass.
//
// A block owns 16 positions and a run of prompts; K1 (128 KB in bf16), K2
// and the s1p tile stay in shared memory across the prompts. Only the
// [B, 16, hw] mask phases leave the block: the [B, hw, 256] t1 and the
// [B, hw, 512] t2 never reach device memory. A block reloads the s1p tile
// only where its run of prompts crosses into the next image.
//
// Bound: the first product (137 GFLOP a call at the slice's shapes) and the
// second (69 GFLOP): on the tensor cores in bf16 (WMMA, float32
// accumulation), on the CUDA cores in float32. From t1 the first product is
// gone and the [B, hw, 256] read of t1 (537 MB in bf16) bounds the call.
#include "common.cuh"

namespace {

constexpr int kD = 256;      // transformer width
constexpr int kM1 = 256;     // 4 * c1
constexpr int kC1 = 64;
constexpr int kM2 = 128;     // 4 * c2
constexpr int kC2 = 32;
constexpr int kS0 = 512;     // 16 * c2
constexpr int kPT = 16;      // positions a block
constexpr int kThreads = 256;

template <typename T, bool kWSmem, bool kFromT1>
__global__ void __launch_bounds__(kThreads)
upscale_kernel(const T* __restrict__ src, const T* __restrict__ k1,
               const float* __restrict__ s1p, const float* __restrict__ lnw,
               const float* __restrict__ lnb, const T* __restrict__ k2,
               const float* __restrict__ s0p, const float* __restrict__ hyper,
               T* __restrict__ out, int B, int hw, int prompts_per_block,
               int ppi, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s1_s = (float*)smem_raw;          // [kPT][kM1]
  float* x_s = s1_s + kPT * kM1;           // [kPT][kD] src tile
  float* u_s = x_s + kPT * kD;             // [kPT][kM1]
  float* hy_s = u_s + kPT * kM1;           // [kC2]
  float* t2_s = hy_s + kC2;                // [kPT][kM2] one quarter, bf16 path
  T* ub_s = (T*)(t2_s + kPT * kM2);        // [kPT][kM1] u in T, bf16 path
  T* k2_s = ub_s + kPT * kM1;              // [kC1][kM2]
  T* k1_s = k2_s + kC1 * kM2;              // [kD][kM1] when kWSmem
  T* xb_s = (T*)x_s;                       // src tile in T, bf16 path

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int pos0 = blockIdx.x * kPT;
  const int b0 = blockIdx.y * prompts_per_block;
  const int b1 = min(B, b0 + prompts_per_block);

  const T* k1p = k1;
  if (kWSmem) {
    for (int i = tid; i < kD * kM1; i += kThreads) k1_s[i] = k1[i];
    k1p = k1_s;
  }
  for (int i = tid; i < kC1 * kM2; i += kThreads) k2_s[i] = k2[i];

  int img = -1;
  for (int b = b0; b < b1; ++b) {
    if (b / ppi != img) {
      // the skips of this prompt's image (the last prompt's reads of s1_s
      // ended at the barrier that closes its iteration)
      img = b / ppi;
      for (int i = tid; i < kPT * kM1; i += kThreads)
        s1_s[i] = s1p[((long long)img * hw + pos0) * kM1 + i];
    }
    const float* s0_i = s0p + (long long)img * hw * kS0;
    const T* src_b = src + ((long long)b * hw + pos0) * kD;
    if constexpr (kFromT1) {
      __syncthreads();
      // t1 arrives in T: u = t1 + s1p in float32 (kD == kM1)
      for (int i = tid; i < kPT * kM1; i += kThreads)
        u_s[i] = Num<T>::to_f(src_b[i]) + s1_s[i];
    } else if constexpr (Num<T>::is_bf16) {
      copy_bf16(xb_s, src_b, kPT * kD);
    } else {
      for (int i = tid; i < kPT * kD; i += kThreads)
        x_s[i] = Num<T>::to_f(src_b[i]);
    }
    if (tid < kC2) hy_s[tid] = Num<T>::round(hyper[(long long)b * kC2 + tid]);
    __syncthreads();

    if constexpr (kFromT1) {
      // the first product is the caller's
    } else if constexpr (Num<T>::is_bf16) {
      // t1 on the tensor cores: warp w owns column tiles 2w, 2w + 1
      warp_gemm_bf16<2>(xb_s, kD, k1p + warp * 32, kM1, kD, u_s + warp * 32,
                        kM1);
      __syncthreads();
      for (int i = tid; i < kPT * kM1; i += kThreads) u_s[i] += s1_s[i];
    } else {
      // t1 = src @ K1 + s1p: 4 rows x 4 columns a thread
      const int r0 = (tid >> 6) * 4;
      const int j0 = (tid & 63) * 4;
      float a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) a[i][jj] = 0.f;
      for (int k = 0; k < kD; ++k) {
        float wv[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) wv[jj] = Num<T>::to_f(k1p[k * kM1 + j0 + jj]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = x_s[(r0 + i) * kD + k];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) a[i][jj] = fmaf(xv, wv[jj], a[i][jj]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int idx = (r0 + i) * kM1 + j0 + jj;
          u_s[idx] = a[i][jj] + s1_s[idx];
        }
    }
    __syncthreads();

    // LayerNorm over each 64-wide segment, then GELU: one warp a segment
    for (int pair = warp; pair < kPT * 4; pair += kThreads / 32) {
      float* z = u_s + (pair >> 2) * kM1 + (pair & 3) * kC1;
      const float va = z[lane], vb = z[lane + 32];
      const float mu = warp_sum(va + vb) / kC1;
      const float da = va - mu, db = vb - mu;
      const float inv = rsqrtf(warp_sum(da * da + db * db) / kC1 + eps);
      const float ga = gelu_act<T>(da * inv * lnw[lane] + lnb[lane]);
      const float gb = gelu_act<T>(db * inv * lnw[lane + 32] + lnb[lane + 32]);
      z[lane] = Num<T>::round(ga);
      z[lane + 32] = Num<T>::round(gb);
      T* zb = ub_s + (z - u_s);
      zb[lane] = Num<T>::from_f(ga);
      zb[lane + 32] = Num<T>::from_f(gb);
    }
    __syncthreads();

    // t2 quarter q = u[:, q*c1:(q+1)*c1] @ K2 + s0p, GELU, and the product
    // with hyper: 2 rows x 4 columns a thread; the 8 lanes that share a
    // 32-wide phase group reduce the product with shuffles.
    {
      const int r0 = (tid >> 5) * 2;
      const int j0 = lane * 4;
      const int jg = lane >> 3;
      for (int q = 0; q < 4; ++q) {
        float a[2][4];
        if constexpr (Num<T>::is_bf16) {
          // warp w owns column tile w of this quarter
          warp_gemm_bf16<1>(ub_s + q * kC1, kM1, k2_s + warp * 16, kM2, kC1,
                            t2_s + warp * 16, kM2);
          __syncthreads();
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              a[i][jj] = t2_s[(r0 + i) * kM2 + j0 + jj];
          __syncthreads();
        } else {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) a[i][jj] = 0.f;
          for (int c = 0; c < kC1; ++c) {
            float wv[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              wv[jj] = Num<T>::to_f(k2_s[c * kM2 + j0 + jj]);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float uv = u_s[(r0 + i) * kM1 + q * kC1 + c];
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) a[i][jj] = fmaf(uv, wv[jj], a[i][jj]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int pos = pos0 + r0 + i;
          float part = 0.f;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = j0 + jj;
            const float z2 = a[i][jj] + s0_i[(long long)pos * kS0 + q * kM2 + j];
            const float g = Num<T>::round(gelu_act<T>(z2));
            part = fmaf(hy_s[j & (kC2 - 1)], g, part);
          }
          part += __shfl_xor_sync(0xffffffffu, part, 1);
          part += __shfl_xor_sync(0xffffffffu, part, 2);
          part += __shfl_xor_sync(0xffffffffu, part, 4);
          if ((lane & 7) == 0)
            out[((long long)b * 16 + q * 4 + jg) * hw + pos] = Num<T>::from_f(part);
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, bool kWSmem, bool kFromT1>
int launch(const void* src, const void* k1, const float* s1p,
           const float* lnw, const float* lnb, const void* k2,
           const float* s0p, const float* hyper, void* out, int B, int hw,
           int prompts_per_block, int ppi, float eps, cudaStream_t stream) {
  size_t smem =
      sizeof(float) * (kPT * kM1 + kPT * kD + kPT * kM1 + kC2 + kPT * kM2) +
      sizeof(T) * (kPT * kM1 + kC1 * kM2);
  if (kWSmem) smem += sizeof(T) * kD * kM1;
  auto kern = upscale_kernel<T, kWSmem, kFromT1>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(hw / kPT, (B + prompts_per_block - 1) / prompts_per_block);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)src, (const T*)k1, s1p, lnw, lnb, (const T*)k2, s0p, hyper,
      (T*)out, B, hw, prompts_per_block, ppi, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// src: [B, hw, 256]; k1: [256, 256]; s1p: float [images, hw, 256]; lnw, lnb:
// float [64]; k2: [64, 128]; s0p: float [images, hw, 512]; hyper: float
// [B, 32]; out: [B, 16, hw]. Prompt b reads the skips of image b / ppi.
// from_t1 != 0: src holds t1 [B, hw, 256] and k1 is not read.
extern "C" int nttt_upscale_product(const void* src, const void* k1,
                                    const float* s1p, const float* lnw,
                                    const float* lnb, const void* k2,
                                    const float* s0p, const float* hyper,
                                    void* out, int B, int hw,
                                    int prompts_per_block, int ppi,
                                    int from_t1, float eps, int dtype,
                                    void* stream) {
  if (hw % kPT || prompts_per_block < 1 || ppi < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == NTTT_DTYPE_BF16) {
    if (from_t1)
      return launch<__nv_bfloat16, false, true>(
          src, k1, s1p, lnw, lnb, k2, s0p, hyper, out, B, hw,
          prompts_per_block, ppi, eps, s);
    return launch<__nv_bfloat16, true, false>(
        src, k1, s1p, lnw, lnb, k2, s0p, hyper, out, B, hw,
        prompts_per_block, ppi, eps, s);
  }
  if (from_t1)
    return launch<float, false, true>(src, k1, s1p, lnw, lnb, k2, s0p, hyper,
                                      out, B, hw, prompts_per_block, ppi, eps,
                                      s);
  return launch<float, false, false>(src, k1, s1p, lnw, lnb, k2, s0p, hyper,
                                     out, B, hw, prompts_per_block, ppi, eps,
                                     s);
}
