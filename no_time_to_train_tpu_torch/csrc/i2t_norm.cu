// Image <- token cross-attention of the SAM2 two-way decoder, fused with the
// out-projection, the residual and LayerNorm (norm4).
//
// Replaces the Pallas kernels `_i2t_kernel` (per-prompt keys) and
// `_i2t_pre_kernel` (layer 0, q projected once) reached from
// `fused_i2t_norm` in no_time_to_train_tpu/ops/decoder_attention.py.
//
// Per image row of prompt p (C = 256, I = 128, H = 8 heads of dh = 16,
// T <= 16 tokens):
//   qi   = ((keys @ Wq + pe_q + bq) / sqrt(dh)).T
//   attn = (softmax_T(qi_h . tok_k_h) .T @ tok_v_h).T        per head
//   out  = LayerNorm((keys + (attn @ Wout + bout).T).T)
// Every key row is read once and written once; qi, the attention and the
// pre-norm residual stay in shared memory. A block owns one prompt and 256
// rows; the prompt is the fastest grid index, so the blocks in flight share
// a row range and, for layer 0's shared keys, read it through L2.
//
// Layer 0 (pre != 0): qi is the same for every prompt of an image, so the
// caller projects it once per image (already scaled and rounded) and passes
// it in `peq`. Prompt q then reads the keys and the qi of image q / ppi.
//
// Pair variants (kNP == 2) replace `_i2t_pre_p2_kernel`, `_i2t_p2_kernel`
// (two prompts a grid step) and `_i2t_pre_pair_kernel` (two images a grid
// step, reached from `fused_i2t_norm_pair`). The TPU bodies pair two chains
// so that one chain's vector work overlaps the other's matrix work; here a
// block serves two chains (prompts 2b and 2b + 1, or prompt b of image 0
// and of image 1) and stages what they share once: Wq and Wout (128 KB in
// bf16) and, where both chains read the same image, the key and qi tiles.
// The two chains' token K / V then stay in the storage type so that the
// block still fits under 227 KB.
//
// Softmax: per head, with the per-head maximum (the Pallas kernel shifts by
// the maximum over all heads, which is the same function). LayerNorm
// statistics: float32 mean and two-pass variance for both storage types,
// then the compute-dtype normalize and affine (`ln_affine`).
//
// Bound: the q and out projections, 137 GFLOP a call at the slice's shapes,
// on the tensor cores in bf16 (WMMA, float32 accumulation) and on the CUDA
// cores in float32; device-memory traffic is the keys read once and the
// output written once.
#include "common.cuh"

namespace {

constexpr int kC = 256;
constexpr int kI = 128;
constexpr int kDh = 16;
constexpr int kH = 8;
constexpr int kBR = 32;          // rows a tile
constexpr int kRowsPerBlock = 256;
constexpr int kThreads = 256;

__device__ __forceinline__ float tok_f(float v) { return v; }
__device__ __forceinline__ float tok_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void tok_set(float& d, float v) { d = v; }
__device__ __forceinline__ void tok_set(__nv_bfloat16& d, float v) {
  d = __float2bfloat16_rn(v);
}

// Token K / V in shared memory: float for one chain a block, the storage
// type for two (exact: the tokens arrive in that type).
template <typename T, int kNP> struct TokStore { using type = T; };
template <typename T> struct TokStore<T, 1> { using type = float; };

// Chain j of block b is prompt b * chain_a + j * chain_b.
template <typename T, bool kWSmem, int kNP>
__global__ void __launch_bounds__(kThreads)
i2t_kernel(const T* __restrict__ keys, const T* __restrict__ peq,
           const T* __restrict__ tok_k, const T* __restrict__ tok_v,
           const T* __restrict__ wq, const float* __restrict__ bq,
           const T* __restrict__ wout, const float* __restrict__ bout,
           const T* __restrict__ nw, const T* __restrict__ nb,
           T* __restrict__ out, int n, int ntok, float scale, float eps,
           int pre, long long key_stride, long long key_img_stride,
           long long peq_img_stride, int ppi, int chain_a, int chain_b) {
  using Tok = typename TokStore<T, kNP>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* x_s = (float*)smem_raw;           // [kBR][kC] keys, then residual
  float* q_s = x_s + kBR * kC;             // [kBR][kI]
  float* at_s = q_s + kBR * kI;            // [kBR][kI]
  Tok* tk_all = (Tok*)(at_s + kBR * kI);   // [kNP][16][kI]
  Tok* tv_all = tk_all + kNP * 16 * kI;    // [kNP][16][kI]
  T* xb_s = (T*)(tv_all + kNP * 16 * kI);  // [kBR][kC] keys, bf16 path
  T* wq_s = xb_s + kBR * kC;               // [kC][kI] when kWSmem
  T* wo_s = wq_s + kC * kI;                // [kI][kC] when kWSmem
  T* atb_s = (T*)at_s;                     // attention output in T

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.y * kRowsPerBlock;
  // per chain: its prompt, its keys and its positional term (pre: its qi)
  long long chain_q[kNP];
  const T* chain_keys[kNP];
  const T* chain_peq[kNP];
#pragma unroll
  for (int j = 0; j < kNP; ++j) {
    const long long q = (long long)blockIdx.x * chain_a + (long long)j * chain_b;
    const long long img = q / ppi;
    chain_q[j] = q;
    chain_keys[j] = keys + q * key_stride + img * key_img_stride;
    chain_peq[j] = peq + img * peq_img_stride;
  }

  const T* wqp = wq;
  const T* wop = wout;
  if (kWSmem) {
    if (!pre) {
      for (int i = tid; i < kC * kI; i += kThreads) wq_s[i] = wq[i];
      wqp = wq_s;
    }
    for (int i = tid; i < kI * kC; i += kThreads) wo_s[i] = wout[i];
    wop = wo_s;
  }
#pragma unroll
  for (int j = 0; j < kNP; ++j)
    for (int i = tid; i < 16 * kI; i += kThreads) {
      const int t = i / kI;
      const long long g = (chain_q[j] * ntok + t) * kI + (i % kI);
      tok_set(tk_all[j * 16 * kI + i],
              t < ntok ? Num<T>::to_f(tok_k[g]) : 0.f);
      tok_set(tv_all[j * 16 * kI + i],
              t < ntok ? Num<T>::to_f(tok_v[g]) : 0.f);
    }
  // this lane's LayerNorm weights: columns lane + 32 k
  float lw[8], lb[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    lw[k] = Num<T>::to_f(nw[lane + 32 * k]);
    lb[k] = Num<T>::to_f(nb[lane + 32 * k]);
  }
  __syncthreads();

  for (int n0 = row0; n0 < min(row0 + kRowsPerBlock, n); n0 += kBR) {
#pragma unroll
  for (int j = 0; j < kNP; ++j) {
    const T* kp = chain_keys[j];
    const T* peq = chain_peq[j];
    const Tok* tk_s = tk_all + j * 16 * kI;
    const Tok* tv_s = tv_all + j * 16 * kI;
    const long long p = chain_q[j];
    // a second chain on the same image finds the bf16 key tile and, under
    // pre, the qi tile already in shared memory
    const bool staged = j > 0 && kp == chain_keys[0] && peq == chain_peq[0];
    if constexpr (Num<T>::is_bf16) {
      if (!staged) copy_bf16(xb_s, kp + (long long)n0 * kC, kBR * kC);
    } else {
      for (int i = tid; i < kBR * kC; i += kThreads)
        x_s[i] = Num<T>::to_f(kp[(long long)n0 * kC + i]);
    }
    if (pre && !staged) {
      for (int i = tid; i < kBR * kI; i += kThreads)
        q_s[i] = Num<T>::to_f(peq[(long long)n0 * kI + i]);
    }
    __syncthreads();

    if constexpr (Num<T>::is_bf16) {
      if (!pre) {
        // qi on the tensor cores: warp w owns row tile w & 1 and column
        // tiles 2 (w >> 1), +1
        const int rt = warp & 1, ct0 = (warp >> 1) * 2;
        warp_gemm_bf16<2>(xb_s + rt * 16 * kC, kC, wqp + ct0 * 16, kI, kC,
                          q_s + rt * 16 * kI + ct0 * 16, kI);
        __syncthreads();
        for (int i = tid; i < kBR * kI; i += kThreads) {
          const int r = i / kI, j = i % kI;
          const float pv = Num<T>::to_f(peq[(long long)(n0 + r) * kI + j]);
          q_s[i] = Num<T>::round((q_s[i] + pv + bq[j]) * scale);
        }
        __syncthreads();
      }
    }
    if (!pre && !Num<T>::is_bf16) {
      // qi = [kBR, kC] @ [kC, kI]: 4 rows x 4 columns a thread
      const int j0 = (tid & 31) * 4;
      const int r0 = (tid >> 5) * 4;
      float a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) a[i][jj] = 0.f;
      for (int k = 0; k < kC; ++k) {
        float wv[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) wv[jj] = Num<T>::to_f(wqp[k * kI + j0 + jj]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = x_s[(r0 + i) * kC + k];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) a[i][jj] = fmaf(xv, wv[jj], a[i][jj]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + i;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j0 + jj;
          const float pv = Num<T>::to_f(peq[(long long)(n0 + r) * kI + j]);
          q_s[r * kI + j] = Num<T>::round((a[i][jj] + pv + bq[j]) * scale);
        }
      }
      __syncthreads();
    }

    // attention: one thread per (row, head)
    {
      const int r = tid >> 3, h = tid & 7;
      float q[kDh];
#pragma unroll
      for (int d = 0; d < kDh; ++d) q[d] = q_s[r * kI + h * kDh + d];
      float s[16];
      float m = -1e30f;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        float v = 0.f;
#pragma unroll
        for (int d = 0; d < kDh; ++d)
          v = fmaf(q[d], tok_f(tk_s[t * kI + h * kDh + d]), v);
        s[t] = v;
        if (t < ntok) m = fmaxf(m, v);
      }
      float l = 0.f;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        s[t] = t < ntok ? expf(s[t] - m) : 0.f;
        l += s[t];
      }
      const float linv = 1.0f / l;
      float o[kDh];
#pragma unroll
      for (int d = 0; d < kDh; ++d) o[d] = 0.f;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const float pt = Num<T>::round(s[t] * linv);
#pragma unroll
        for (int d = 0; d < kDh; ++d)
          o[d] = fmaf(pt, tok_f(tv_s[t * kI + h * kDh + d]), o[d]);
      }
#pragma unroll
      for (int d = 0; d < kDh; ++d) atb_s[r * kI + h * kDh + d] = Num<T>::from_f(o[d]);
    }
    __syncthreads();

    if constexpr (Num<T>::is_bf16) {
      // attn @ Wout on the tensor cores: warp w owns row tile w & 1 and
      // column tiles 4 (w >> 1) .. +3; then residual = keys + (. + bout)
      const int rt = warp & 1, ct0 = (warp >> 1) * 4;
      warp_gemm_bf16<4>(atb_s + rt * 16 * kI, kI, wop + ct0 * 16, kC, kI,
                        x_s + rt * 16 * kC + ct0 * 16, kC);
      __syncthreads();
      for (int i = tid; i < kBR * kC; i += kThreads) {
        const float y = Num<T>::round(x_s[i] + bout[i % kC]);
        x_s[i] = Num<T>::round(Num<T>::to_f(xb_s[i]) + y);
      }
    } else {
      // residual = keys + (attn @ Wout + bout): 4 rows x 8 columns a thread
      const int j0 = (tid & 31) * 8;
      const int r0 = (tid >> 5) * 4;
      float a[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) a[i][jj] = 0.f;
      for (int k = 0; k < kI; ++k) {
        float wv[8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) wv[jj] = Num<T>::to_f(wop[k * kC + j0 + jj]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = at_s[(r0 + i) * kI + k];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) a[i][jj] = fmaf(av, wv[jj], a[i][jj]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int idx = (r0 + i) * kC + j0 + jj;
          const float y = Num<T>::round(a[i][jj] + bout[j0 + jj]);
          x_s[idx] = Num<T>::round(x_s[idx] + y);
        }
    }
    __syncthreads();

    // LayerNorm: one warp a row
    for (int r = warp; r < kBR; r += kThreads / 32) {
      float v[8];
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[k] = x_s[r * kC + lane + 32 * k];
        s += v[k];
      }
      const float mu = warp_sum(s) / kC;
      float q = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) q += (v[k] - mu) * (v[k] - mu);
      const float inv = rsqrtf(warp_sum(q) / kC + eps);
      T* orow = out + (p * n + n0 + r) * kC;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        orow[lane + 32 * k] =
            Num<T>::from_f(ln_affine<T>(v[k], mu, inv, lw[k], lb[k]));
    }
    __syncthreads();
  }
  }
}

template <typename T, bool kWSmem, int kNP>
int launch(const void* keys, const void* peq, const void* tok_k,
           const void* tok_v, const void* wq, const float* bq,
           const void* wout, const float* bout, const void* nw,
           const void* nb, void* out, int P, int n, int ntok, float scale,
           float eps, int pre, long long key_stride,
           long long key_img_stride, long long peq_img_stride, int ppi,
           int chain_a, int chain_b, cudaStream_t stream) {
  using Tok = typename TokStore<T, kNP>::type;
  size_t smem = sizeof(float) * (kBR * kC + 2 * kBR * kI) +
                sizeof(Tok) * kNP * 2 * 16 * kI + sizeof(T) * kBR * kC;
  if (kWSmem) smem += sizeof(T) * 2 * kC * kI;
  auto kern = i2t_kernel<T, kWSmem, kNP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(P / kNP, (n + kRowsPerBlock - 1) / kRowsPerBlock);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)keys, (const T*)peq, (const T*)tok_k, (const T*)tok_v,
      (const T*)wq, bq, (const T*)wout, bout, (const T*)nw, (const T*)nb,
      (T*)out, n, ntok, scale, eps, pre, key_stride, key_img_stride,
      peq_img_stride, ppi, chain_a, chain_b);
  return (int)cudaGetLastError();
}

template <typename T, bool kWSmem, typename... A>
int launch_np(int pair, A... a) {
  return pair ? launch<T, kWSmem, 2>(a...) : launch<T, kWSmem, 1>(a...);
}

}  // namespace

// keys: [Pk, n, 256]; tok_k, tok_v: [P, T, 128]; wq: [256, 128]; bq: float
// [128]; wout: [128, 256]; bout: float [256]; nw, nb: [256]; out:
// [P, n, 256]. Per-prompt keys (pre == 0): Pk == P, key_stride = n * 256,
// peq: [n, 128] the pre-projected positional term, the image strides 0.
// Shared keys (pre != 0): Pk images of ppi prompts each, key_stride = 0,
// key_img_stride = n * 256, peq: [Pk, n, 128] the scaled, rounded qi with
// peq_img_stride = n * 128. pair: 0 for one prompt a block; 1 for two
// prompts a block (2b, 2b + 1; P even); 2 for an image pair (prompt b of
// image 0 and of image 1; P = 2 * ppi).
extern "C" int nttt_i2t_norm(const void* keys, const void* peq,
                             const void* tok_k, const void* tok_v,
                             const void* wq, const float* bq,
                             const void* wout, const float* bout,
                             const void* nw, const void* nb, void* out,
                             int P, int n, int heads, int ntok, float scale,
                             float eps, int pre, long long key_stride,
                             long long key_img_stride,
                             long long peq_img_stride, int ppi, int pair,
                             int dtype, void* stream) {
  if (heads != kH || ntok < 1 || ntok > 16 || n % kBR || ppi < 1 ||
      pair < 0 || pair > 2 || (pair && P % 2) || (pair == 2 && P != 2 * ppi))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int chain_a = pair == 1 ? 2 : 1;
  const int chain_b = pair == 2 ? ppi : 1;
  if (dtype == NTTT_DTYPE_BF16)
    return launch_np<__nv_bfloat16, true>(
        pair, keys, peq, tok_k, tok_v, wq, bq, wout, bout, nw, nb, out, P, n,
        ntok, scale, eps, pre, key_stride, key_img_stride, peq_img_stride,
        ppi, chain_a, chain_b, s);
  return launch_np<float, false>(
      pair, keys, peq, tok_k, tok_v, wq, bq, wout, bout, nw, nb, out, P, n,
      ntok, scale, eps, pre, key_stride, key_img_stride, peq_img_stride, ppi,
      chain_a, chain_b, s);
}
