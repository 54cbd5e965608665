// Token -> image cross-attention of the SAM2 two-way decoder, with the key
// and value projections computed on chip.
//
// Replaces the Pallas kernels `_t2i_kernel` (per-prompt keys) and
// `_t2i_pre_kernel` (layer 0, keys shared by every prompt) reached from
// `fused_t2i_attn` in no_time_to_train_tpu/ops/decoder_attention.py.
//
// For one prompt p, with keys [n, C] (C = 256), internal width I = 128,
// H = 8 heads of dh = 16 and T <= 16 tokens:
//   kk = (keys @ Wk + pe_k + bk).T     vv = (keys @ Wv + bv).T
//   out[t, h] = softmax_n(q[t, h] . kk[:, h] / sqrt(dh)) @ vv[:, h]
// One block per prompt walks the n keys in tiles of 32 rows: it projects the
// tile against Wk|Wv held in shared memory (2 x 64 KB in bf16), adds pe_k and
// the biases, and carries the online-softmax max, sum and the
// [H*T, dh] accumulator on chip. The [P, n, I] kk / vv and the [P, H, T, n]
// logits never reach device memory; what is read is the keys (once), pe_k
// and the weights.
//
// Layer 0 (pre != 0): kk and vv are the same for every prompt of an image,
// so the caller projects them once per image with a matrix product and the
// kernel reads them from device memory instead of projecting; prompt q reads
// image q / ppi.
//
// The pair variant (kNP == 2) replaces `_t2i_p2_kernel` (two prompts a grid
// step, per-prompt keys). The TPU body pairs two chains so that one chain's
// vector work overlaps the other's matrix work; here a block serves prompts
// 2b and 2b + 1, stages Wk|Wv once for both and keeps two online-softmax
// states (q, max, sum, rescale factor in shared memory, the accumulators in
// registers) apart.
//
// Bound: at the slice's shapes the per-prompt projection is 137 GFLOP a
// call. In bf16 it runs on the tensor cores (WMMA 16x16x16, float32
// accumulation); the float32 variant uses FMAs on the CUDA cores.
//
// Cast points follow the Pallas kernel: kk, vv and the scaled q round to the
// storage type; the softmax weights round to it before the value product;
// the running sum uses the unrounded weights.
#include "common.cuh"

namespace {

constexpr int kC = 256;
constexpr int kI = 128;
constexpr int kDh = 16;
constexpr int kBK = 32;      // key rows a tile
constexpr int kThreads = 256;

template <typename T, bool kWSmem, int kNP>
__global__ void __launch_bounds__(kThreads)
t2i_kernel(const T* __restrict__ keys, const T* __restrict__ pe,
           const T* __restrict__ tok_q, const T* __restrict__ wkv,
           const float* __restrict__ bk, const float* __restrict__ bv,
           T* __restrict__ out, int n, int heads, int ntok, float scale,
           int pre, long long key_stride, long long img_stride, int ppi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xt_s = (T*)smem_raw;                   // [kBK][kC] key tile
  float* x_s = (float*)smem_raw;            // the same, float32 path
  float* kk_s = (float*)(xt_s + kBK * kC);  // [kBK][kI]
  float* vv_s = kk_s + kBK * kI;            // [kBK][kI]
  float* s_s = vv_s + kBK * kI;             // [kBK][128] logits / weights
  float* q_all = s_s + kBK * 128;           // [kNP][128][kDh]
  float* m_all = q_all + kNP * 128 * kDh;   // [kNP][128]
  float* l_all = m_all + kNP * 128;         // [kNP][128]
  float* a_s = l_all + kNP * 128;           // [128] rescale factors
  T* w_s = (T*)(a_s + 128);                 // [kC][2*kI] when kWSmem

  const int tid = threadIdx.x;
  const int ht = heads * ntok;              // live (head, token) columns

  const T* w = wkv;
  if (kWSmem && !pre) {
    for (int i = tid; i < kC * 2 * kI; i += kThreads) w_s[i] = wkv[i];
    w = w_s;
  }
  for (int c = tid; c < kNP * 128; c += kThreads) {
    m_all[c] = -1e30f;
    l_all[c] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kNP; ++j)
    for (int i = tid; i < 128 * kDh; i += kThreads) {
      const int col = i / kDh, d = i % kDh;
      const long long p = (long long)blockIdx.x * kNP + j;
      float v = 0.f;
      if (col < ht) {
        const int h = col / ntok, t = col % ntok;
        v = Num<T>::round(
            Num<T>::to_f(tok_q[(p * ntok + t) * kI + h * kDh + d]) * scale);
      }
      q_all[j * 128 * kDh + i] = v;
    }
  float acc_all[kNP][8];
#pragma unroll
  for (int j = 0; j < kNP; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc_all[j][k] = 0.f;
  __syncthreads();

  for (int n0 = 0; n0 < n; n0 += kBK) {
#pragma unroll
  for (int j = 0; j < kNP; ++j) {
    const long long p = (long long)blockIdx.x * kNP + j;
    // per-prompt keys, or under pre the kk / vv of the prompt's image
    const T* kp = keys + p * key_stride + (p / ppi) * img_stride;
    const T* vp = pe + (p / ppi) * img_stride;
    float* q_s = q_all + j * 128 * kDh;
    float* m_s = m_all + j * 128;
    float* l_s = l_all + j * 128;
    float* acc = acc_all[j];
    if constexpr (Num<T>::is_bf16) {
      if (!pre) {
        // [kBK, kC] @ [kC, 2*kI] on the tensor cores: warp w owns row tile
        // w & 1 and column tiles 4 (w >> 1) .. +3, all in kk or all in vv
        __nv_bfloat16* xb_s = (__nv_bfloat16*)xt_s;
        copy_bf16(xb_s, kp + (long long)n0 * kC, kBK * kC);
        __syncthreads();
        const int warp = tid >> 5;
        const int rt = warp & 1, ct0 = (warp >> 1) * 4;
        float* dst = ct0 < 8 ? kk_s + rt * 16 * kI + ct0 * 16
                             : vv_s + rt * 16 * kI + (ct0 - 8) * 16;
        warp_gemm_bf16<4>(xb_s + rt * 16 * kC, kC, w + ct0 * 16, 2 * kI, kC,
                          dst, kI);
        __syncthreads();
        for (int i = tid; i < kBK * kI; i += kThreads) {
          const int r = i / kI, j = i % kI;
          const float pv = Num<T>::to_f(pe[(long long)(n0 + r) * kI + j]);
          kk_s[i] = Num<T>::round(kk_s[i] + pv + bk[j]);
          vv_s[i] = Num<T>::round(vv_s[i] + bv[j]);
        }
      }
    }
    if (!pre && !Num<T>::is_bf16) {
      for (int i = tid; i < kBK * kC; i += kThreads)
        x_s[i] = Num<T>::to_f(kp[(long long)n0 * kC + i]);
      __syncthreads();
      // [kBK, kC] @ [kC, 2*kI]: each thread owns 4 rows x 8 columns
      const int j0 = (tid & 31) * 8;
      const int r0 = (tid >> 5) * 4;
      float a[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) a[i][jj] = 0.f;
      for (int k = 0; k < kC; ++k) {
        float wv[8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          wv[jj] = Num<T>::to_f(w[k * 2 * kI + j0 + jj]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = x_s[(r0 + i) * kC + k];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) a[i][jj] = fmaf(xv, wv[jj], a[i][jj]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + i;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = j0 + jj;
          if (j < kI) {
            const float pv = Num<T>::to_f(pe[(long long)(n0 + r) * kI + j]);
            kk_s[r * kI + j] = Num<T>::round(a[i][jj] + pv + bk[j]);
          } else {
            vv_s[r * kI + j - kI] = Num<T>::round(a[i][jj] + bv[j - kI]);
          }
        }
      }
    } else if (pre) {
      // layer 0: kk in `keys`, vv in `pe`, both [images, n, kI]
      for (int i = tid; i < kBK * kI; i += kThreads) {
        kk_s[i] = Num<T>::to_f(kp[(long long)n0 * kI + i]);
        vv_s[i] = Num<T>::to_f(vp[(long long)n0 * kI + i]);
      }
    }
    __syncthreads();

    // logits: column (h, t), rows split in two halves
    {
      const int col = tid & 127;
      const int rh = (tid >> 7) * (kBK / 2);
      if (col < ht) {
        const int h = col / ntok;
        float q[kDh];
#pragma unroll
        for (int d = 0; d < kDh; ++d) q[d] = q_s[col * kDh + d];
        for (int r = rh; r < rh + kBK / 2; ++r) {
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < kDh; ++d)
            s = fmaf(kk_s[r * kI + h * kDh + d], q[d], s);
          s_s[r * 128 + col] = s;
        }
      }
    }
    __syncthreads();

    // online-softmax update, one thread a column
    if (tid < ht) {
      const int col = tid;
      const float m_old = m_s[col];
      float m_cur = -1e30f;
      for (int r = 0; r < kBK; ++r) m_cur = fmaxf(m_cur, s_s[r * 128 + col]);
      const float m_new = fmaxf(m_old, m_cur);
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
      for (int r = 0; r < kBK; ++r) {
        const float e = expf(s_s[r * 128 + col] - m_new);
        sum += e;
        s_s[r * 128 + col] = Num<T>::round(e);
      }
      l_s[col] = l_s[col] * alpha + sum;
      m_s[col] = m_new;
      a_s[col] = alpha;
    }
    __syncthreads();

    // acc[(h, t), d] = acc * alpha + sum_r e[r, (h, t)] * vv[r, h*dh + d]
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int col = (tid >> 4) + 16 * k;
      const int d = tid & 15;
      if (col < ht) {
        const int h = col / ntok;
        float u = 0.f;
        for (int r = 0; r < kBK; ++r)
          u = fmaf(s_s[r * 128 + col], vv_s[r * kI + h * kDh + d], u);
        acc[k] = acc[k] * a_s[col] + u;
      }
    }
    __syncthreads();
  }
  }

#pragma unroll
  for (int j = 0; j < kNP; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int col = (tid >> 4) + 16 * k;
      const int d = tid & 15;
      if (col < ht) {
        const int h = col / ntok, t = col % ntok;
        const long long p = (long long)blockIdx.x * kNP + j;
        out[(p * ntok + t) * kI + h * kDh + d] = Num<T>::from_f(
            acc_all[j][k] * (1.0f / l_all[j * 128 + col]));
      }
    }
}

template <typename T, bool kWSmem, int kNP>
int launch(const void* keys, const void* pe, const void* tok_q,
           const void* wkv, const float* bk, const float* bv, void* out,
           int P, int n, int heads, int ntok, float scale, int pre,
           long long key_stride, long long img_stride, int ppi,
           cudaStream_t stream) {
  size_t smem = sizeof(T) * kBK * kC +
                sizeof(float) * (2 * kBK * kI + kBK * 128 +
                                 kNP * (128 * kDh + 2 * 128) + 128);
  if (kWSmem) smem += sizeof(T) * kC * 2 * kI;
  auto kern = t2i_kernel<T, kWSmem, kNP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<P / kNP, kThreads, smem, stream>>>(
      (const T*)keys, (const T*)pe, (const T*)tok_q, (const T*)wkv, bk, bv,
      (T*)out, n, heads, ntok, scale, pre, key_stride, img_stride, ppi);
  return (int)cudaGetLastError();
}

}  // namespace

// tok_q: [P, T, 128]; wkv: [256, 256] = Wk | Wv; bk, bv: float [128]; out:
// [P, T, 128]. Per-prompt keys (pre == 0): keys [P, n, 256], key_stride =
// n * 256, pe [n, 128], img_stride 0. Shared keys (pre != 0): `keys` holds
// kk and `pe` holds vv, both [images, n, 128] with img_stride = n * 128 and
// key_stride 0; prompt q reads image q / ppi. pair != 0 (per-prompt keys
// only, P even): two prompts a block.
extern "C" int nttt_t2i_attn(const void* keys, const void* pe,
                             const void* tok_q, const void* wkv,
                             const float* bk, const float* bv, void* out,
                             int P, int n, int heads, int ntok, float scale,
                             int pre, long long key_stride,
                             long long img_stride, int ppi, int pair,
                             int dtype, void* stream) {
  if (heads * kDh != kI || ntok < 1 || ntok > 16 || n % kBK || ppi < 1 ||
      (pair && (pre || P % 2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == NTTT_DTYPE_BF16) {
    if (pre)
      return launch<__nv_bfloat16, false, 1>(keys, pe, tok_q, wkv, bk, bv,
                                             out, P, n, heads, ntok, scale,
                                             pre, key_stride, img_stride,
                                             ppi, s);
    if (pair)
      return launch<__nv_bfloat16, true, 2>(keys, pe, tok_q, wkv, bk, bv,
                                            out, P, n, heads, ntok, scale,
                                            pre, key_stride, img_stride, ppi,
                                            s);
    return launch<__nv_bfloat16, true, 1>(keys, pe, tok_q, wkv, bk, bv, out,
                                          P, n, heads, ntok, scale, pre,
                                          key_stride, img_stride, ppi, s);
  }
  if (pair)
    return launch<float, false, 2>(keys, pe, tok_q, wkv, bk, bv, out, P, n,
                                   heads, ntok, scale, pre, key_stride,
                                   img_stride, ppi, s);
  return launch<float, false, 1>(keys, pe, tok_q, wkv, bk, bv, out, P, n,
                                 heads, ntok, scale, pre, key_stride,
                                 img_stride, ppi, s);
}
