// Image <- token cross-attention of the SAM2 two-way decoder, fused with the
// out-projection, the residual and LayerNorm (norm4).
//
// Replaces the Pallas kernels `_i2t_kernel` (per-prompt keys) and
// `_i2t_pre_kernel` (layer 0, q projected once) reached from
// `fused_i2t_norm` in no_time_to_train_tpu/ops/decoder_attention.py, and the
// pair bodies `_i2t_pre_p2_kernel`, `_i2t_p2_kernel` (two prompts a grid
// step) and `_i2t_pre_pair_kernel` (two images a grid step, reached from
// `fused_i2t_norm_pair`).
//
// Per image row of prompt p (C = 256, I = 128, H = 8 heads of dh = 16,
// T <= 16 tokens):
//   qi   = round((keys @ Wq + pe_q + bq) * scale)
//   p_h  = round(softmax_T(qi_h . tok_k_h))      tokens >= ntok masked
//   attn = round(sum_T p_h tok_v_h)
//   r    = round(keys + round(attn @ Wout + bout))
//   out  = LayerNorm(r): float32 mean and two-pass variance, then the
//          compute-dtype normalize and affine (`ln_affine`)
// Layer 0 (pre != 0): qi is the same for every prompt of an image, so the
// caller projects it once per image (already scaled and rounded) and passes
// it in `peq`; prompt q then reads the keys and the qi of image q / ppi.
// Softmax per head with the per-head maximum (the Pallas kernel shifts by
// the maximum over all heads, which is the same function).
//
// Bound on this card: every key row is read once and every output row
// written once (1.07 GB at the slice's 256 prompts x 4096 rows, 0.32 ms at
// 3.35 TB/s); the q and out projections are 137 GFLOP, 0.14 ms at the bf16
// tensor-core peak. So a kernel that keeps the products on the tensor cores
// and every intermediate out of shared memory is held by the bytes. The one
// below is not there yet: at up to 255 registers a thread only 8 warps fit
// an SM, and their dependent chains of softmax and norm arithmetic, not the
// bytes, set its pace (PERF.md has its times).
//
// bf16: `i2t_mma_kernel`. Persistent blocks of 8 warps, one an SM, walk a
// contiguous range of work items (a chain and 64 rows). Wq and Wout (128 KB)
// are loaded into swizzled shared memory once a block. The warps form two
// teams of 4 with a slot each: a team loads an item's key tile (64 x 256,
// plus the qi tile under pre) by `cp.async`, a prompt's token K / V (8 KB)
// only when the prompt changes, and asks L2 for its next tile (a bulk
// prefetch), then computes while the other team loads. A team is a
// warpgroup and a warp owns 16 of its 64 rows. The q and out projections are
// warpgroup products (`wgmma`, csrc/wgmma_tile.cuh) with A, the warp's keys
// or attention rows, in registers and B, the weights, read from shared
// memory once for the 64 rows; their float32 accumulators have the layout of
// `mma.sync.m16n8k16` (csrc/mma_tile.cuh), on which the attention runs: the
// rounded q accumulator is the A fragment of the logits; the logits [16, 16
// tokens] and P V per head are one m16n8k16 pair each, the softmax a quad
// reduction; the rounded attention is the A operand of the out-projection,
// which runs in two halves of 128 columns; the rounded residual replaces the
// warp's key rows in the slot, the norm's statistics are quad sums, and the
// normalized rows leave from the slot as 16-byte stores. The cast-point
// operations on two bf16 values (residual, normalize, affine) are single
// bf16x2 instructions with one rounding, which give the same values as the
// float32 operation rounded to bf16. Neither the keys in float32 nor the q
// or attention tiles reach shared memory. Pair variants (kNP == 2) are the
// same kernel with a work item over two chains (prompts 2b and 2b + 1, or
// prompt b of image 0 and of image 1): each row is computed by the same
// instructions as in the single-prompt kernel, so the variants equal it bit
// for bit; both chains' tokens are staged together and each chain's key tile
// comes through the slot (where both read the same image, from L2).
//
// float32, and the `nttt_i2t_norm_wmma` check route for either dtype:
// `i2t_kernel`, the first port's body (a block owns one prompt and 256
// rows; WMMA products in bf16 with float32 tiles in shared memory,
// attention on the CUDA cores; FMAs in float32).
#include "common.cuh"
#include "mma_tile.cuh"
#include "wgmma_tile.cuh"

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
  const int nv = min(kBR, n - n0);   // rows of the tile inside n
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
      if (!staged) copy_bf16(xb_s, kp + (long long)n0 * kC, kBR * kC, nv * kC);
    } else {
      for (int i = tid; i < kBR * kC; i += kThreads)
        x_s[i] = i < nv * kC ? Num<T>::to_f(kp[(long long)n0 * kC + i]) : 0.f;
    }
    if (pre && !staged) {
      for (int i = tid; i < kBR * kI; i += kThreads)
        q_s[i] = i < nv * kI ? Num<T>::to_f(peq[(long long)n0 * kI + i]) : 0.f;
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
          const float pv =
              r < nv ? Num<T>::to_f(peq[(long long)(n0 + r) * kI + j]) : 0.f;
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
          const float pv =
              r < nv ? Num<T>::to_f(peq[(long long)(n0 + r) * kI + j]) : 0.f;
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
    for (int r = warp; r < nv; r += kThreads / 32) {
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

// ---------------------------------------------------------------------------
// bf16: persistent warpgroups, register accumulators (wgmma and mma.sync)

using mma::bf16;
constexpr int kItemRows = 64;        // rows of a work item: 4 warps x 16
constexpr int kTeamThreads = 128;    // the 4 warps that share a work item
constexpr int kMmaThreads = 2 * kTeamThreads;
constexpr int kTokElems = 16 * kI;   // one [16 tokens, 128] tile

// Shared memory of the bf16 kernel, in elements from the start: Wout
// [128, 256] and Wq [256, 128] (not under pre) in wgmma's column blocks, one
// slot a team (keys [64, 256] as Tile<256>, then under pre qi [64, 128] as
// Tile<128>), each team's token K and V of its chains (Tile<128> each), then
// bq, bout (float) and the norm's weight and bias.
template <int kNP, bool kPre>
struct MmaSmem {
  static constexpr int kKeyElems = kItemRows * kC;
  static constexpr int kSlot = kKeyElems + (kPre ? kItemRows * kI : 0);
  static constexpr int kWq = kI * kC;
  static constexpr int kSlots = kWq + (kPre ? 0 : kC * kI);
  static constexpr int kTeamTok = kNP * 2 * kTokElems;
  static constexpr int kTok = kSlots + 2 * kSlot;
  static constexpr int kVec = kTok + 2 * kTeamTok;
  static constexpr size_t kBytes =
      sizeof(bf16) * kVec + sizeof(float) * (kI + kC) + sizeof(bf16) * 2 * kC;
};

// Wq [256, 128] and Wout [128, 256] in 128-byte-swizzled column blocks of
// 64 (csrc/wgmma_tile.cuh), the B operands of the warpgroup products
using WqBlocks = wg::Blocks<kI, kC>;
using WoBlocks = wg::Blocks<kC, kI>;

using mma::hi_f;
using mma::lo_f;
using wg::prefetch_l2;
// Two bf16 operations with one rounding each, never contracted into an FMA:
// on bf16 operands the same values as the operation in float32 rounded to
// bf16 (a product of two bf16 is exact in float32; a sum is exact there
// unless one term is below 2^-16 of the other, and then both round to it).
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ void team_sync(int team) {
  wg::bar_sync(1 + team, kTeamThreads);
}

__device__ __forceinline__ uint32_t& at_smem(bf16* tile, int row, int col) {
  return *(uint32_t*)(tile + mma::Tile<kC>::off(row, col >> 3) + (col & 7));
}

// One work item of chain q, rows [r0, r0 + 64): warp w of the team takes
// rows r0 + 16 w .. + 15. `kt` is the team's slot (keys, then qi under
// pre); `tk`, `tv` the chain's token K / V. The residual, then the output,
// overwrite the warp's key rows in the slot, and the output is stored from
// there.
template <bool kPre>
__device__ __forceinline__ void i2t_item(
    bf16* kt, const bf16* tk, const bf16* tv, const bf16* wq_s,
    const bf16* wo_s, const float* bq_s, const float* bo_s,
    const bf16* nw_s, const bf16* nb_s, const bf16* __restrict__ peq,
    bf16* __restrict__ out, long long q, int r0, int n, int ntok,
    float scale, float eps) {
  const int lane = threadIdx.x & 31;
  const int rw = 16 * ((threadIdx.x >> 5) & 3);
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = rw + g, rh = rg + 8;     // the thread's two rows

  // the q projection (without pre) as the A fragments of the logits, one
  // [16, 16] block a head
  uint32_t qa[kH][4];
  if constexpr (!kPre) {
    // one warpgroup product [64, 128] per 16 columns of depth: A, the keys,
    // from registers, Wq from shared memory
    uint32_t kf[kC / 16][4];
    float acc[16][4];
#pragma unroll
    for (int jn = 0; jn < 16; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk)
      mma::load_a<kC>(kf[kk], kt, rw, kk, lane);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk)
      wg::mma_rs<kI>(acc, kf[kk],
                     wg::desc(wq_s + kk * 16 * 64, WqBlocks::kBlock * 2, 1024));
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(acc);
    // + the projected positional term (every prompt reads the same [n,
    // 128] from L2) + bq, scaled and rounded
    const int ra = r0 + rg, rb = r0 + rh;
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      const int col = 8 * jn + 2 * t4;
      const unsigned int* pr = (const unsigned int*)(peq + col);
      const uint32_t pa = ra < n ? __ldg(pr + (long long)ra * kI / 2) : 0u;
      const uint32_t pb = rb < n ? __ldg(pr + (long long)rb * kI / 2) : 0u;
      const float b0 = bq_s[col], b1 = bq_s[col + 1];
      const int h = jn >> 1, s = (jn & 1) * 2;
      qa[h][s] = mma::pack_bf16((acc[jn][0] + lo_f(pa) + b0) * scale,
                                (acc[jn][1] + hi_f(pa) + b1) * scale);
      qa[h][s + 1] = mma::pack_bf16((acc[jn][2] + lo_f(pb) + b0) * scale,
                                    (acc[jn][3] + hi_f(pb) + b1) * scale);
    }
  }

  // attention per head: logits [16 rows, 16 tokens], softmax over the quad
  // (base 2), P V [16, 16]; the rounded result is the A fragment of the
  // out-projection
  uint32_t at[kH][4];
  const int ta = 2 * t4, tb = 8 + 2 * t4;
  const float ninf = __int_as_float(0xff800000);   // -inf: a masked token
  const float log2e = 1.4426950408889634f;
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    if constexpr (kPre)
      mma::load_a<kI>(qa[h], kt + MmaSmem<1, true>::kKeyElems, rw, h, lane);
    uint32_t bk[4], bv[4];
    mma::load_b_nk<kI>(bk, tk, 0, h, lane);
    mma::load_b_kn<kI>(bv, tv, 0, h, lane);
    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
    mma::mma_16816(s0, qa[h], bk[0], bk[1]);   // tokens 0..7
    mma::mma_16816(s1, qa[h], bk[2], bk[3]);   // tokens 8..15
    if (ta >= ntok) s0[0] = s0[2] = ninf;
    if (ta + 1 >= ntok) s0[1] = s0[3] = ninf;
    if (tb >= ntok) s1[0] = s1[2] = ninf;
    if (tb + 1 >= ntok) s1[1] = s1[3] = ninf;
    const float mg = log2e * mma::quad_max(
        fmaxf(fmaxf(s0[0], s0[1]), fmaxf(s1[0], s1[1])));
    const float mh = log2e * mma::quad_max(
        fmaxf(fmaxf(s0[2], s0[3]), fmaxf(s1[2], s1[3])));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float m = e < 2 ? mg : mh;
      s0[e] = mma::fast_exp2(fmaf(s0[e], log2e, -m));
      s1[e] = mma::fast_exp2(fmaf(s1[e], log2e, -m));
    }
    const float ig = __frcp_rn(mma::quad_sum(s0[0] + s0[1] + s1[0] + s1[1]));
    const float ih = __frcp_rn(mma::quad_sum(s0[2] + s0[3] + s1[2] + s1[3]));
    uint32_t pa[4];
    pa[0] = mma::pack_bf16(s0[0] * ig, s0[1] * ig);
    pa[1] = mma::pack_bf16(s0[2] * ih, s0[3] * ih);
    pa[2] = mma::pack_bf16(s1[0] * ig, s1[1] * ig);
    pa[3] = mma::pack_bf16(s1[2] * ih, s1[3] * ih);
    float o0[4] = {0.f, 0.f, 0.f, 0.f}, o1[4] = {0.f, 0.f, 0.f, 0.f};
    mma::mma_16816(o0, pa, bv[0], bv[1]);      // dh 0..7
    mma::mma_16816(o1, pa, bv[2], bv[3]);      // dh 8..15
    at[h][0] = mma::pack_bf16(o0[0], o0[1]);
    at[h][1] = mma::pack_bf16(o0[2], o0[3]);
    at[h][2] = mma::pack_bf16(o1[0], o1[1]);
    at[h][3] = mma::pack_bf16(o1[2], o1[3]);
  }

  // out-projection in two halves of 128 columns, each one warpgroup
  // product [64, 128] per 16 columns of depth (A, the attention, from
  // registers; Wout from shared memory); the residual r = round(keys +
  // round(y + bout)) replaces the keys in the slot (the q projection is done
  // with them)
  float sg = 0.f, sh = 0.f;
#pragma unroll 1
  for (int hf = 0; hf < 2; ++hf) {
    float acc[16][4];
#pragma unroll
    for (int jn = 0; jn < 16; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jn][e] = 0.f;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kI / 16; ++kk)
      wg::mma_rs<kC / 2>(acc, at[kk],
                         wg::desc(wo_s + 2 * hf * WoBlocks::kBlock +
                                      kk * 16 * 64,
                                  WoBlocks::kBlock * 2, 1024));
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(acc);
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      const int col = 128 * hf + 8 * jn + 2 * t4;
      const float b0 = bo_s[col], b1 = bo_s[col + 1];
      uint32_t& kg = at_smem(kt, rg, col);
      uint32_t& kh = at_smem(kt, rh, col);
      const uint32_t vg =
          add_bf16x2(kg, mma::pack_bf16(acc[jn][0] + b0, acc[jn][1] + b1));
      const uint32_t vh =
          add_bf16x2(kh, mma::pack_bf16(acc[jn][2] + b0, acc[jn][3] + b1));
      kg = vg;
      kh = vh;
      sg += lo_f(vg) + hi_f(vg);
      sh += lo_f(vh) + hi_f(vh);
    }
  }

  // LayerNorm of rows g and g + 8: a quad holds a whole row
  const float mug = mma::quad_sum(sg) / kC, muh = mma::quad_sum(sh) / kC;
  float qg = 0.f, qh = 0.f;
#pragma unroll 4
  for (int jn = 0; jn < 32; ++jn) {
    const int col = 8 * jn + 2 * t4;
    const uint32_t a = at_smem(kt, rg, col), b = at_smem(kt, rh, col);
    qg += (lo_f(a) - mug) * (lo_f(a) - mug) + (hi_f(a) - mug) * (hi_f(a) - mug);
    qh += (lo_f(b) - muh) * (lo_f(b) - muh) + (hi_f(b) - muh) * (hi_f(b) - muh);
  }
  const float invg = rsqrtf(mma::quad_sum(qg) / kC + eps);
  const float invh = rsqrtf(mma::quad_sum(qh) / kC + eps);
  // `ln_affine`'s cast points on pairs: (r - mu) * inv, * w, + b
  const uint32_t mu2g = mma::pack_bf16(mug, mug);
  const uint32_t mu2h = mma::pack_bf16(muh, muh);
  const uint32_t in2g = mma::pack_bf16(invg, invg);
  const uint32_t in2h = mma::pack_bf16(invh, invh);
#pragma unroll 4
  for (int jn = 0; jn < 32; ++jn) {
    const int col = 8 * jn + 2 * t4;
    const uint32_t w2 = *(const uint32_t*)(nw_s + col);
    const uint32_t b2 = *(const uint32_t*)(nb_s + col);
    uint32_t& a = at_smem(kt, rg, col);
    uint32_t& b = at_smem(kt, rh, col);
    a = add_bf16x2(mul_bf16x2(mul_bf16x2(sub_bf16x2(a, mu2g), in2g), w2), b2);
    b = add_bf16x2(mul_bf16x2(mul_bf16x2(sub_bf16x2(b, mu2h), in2h), w2), b2);
  }
  __syncwarp();
  // 16-byte stores: a row of 512 bytes a warp instruction
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int row = r0 + rw + i;
    if (row < n)
      *(uint4*)(out + (q * n + row) * kC + 8 * lane) =
          *(const uint4*)(kt + mma::Tile<kC>::off(rw + i, lane));
  }
}

// Block b owns work items [items * b / grid, items * (b + 1) / grid), its
// two teams of 4 warps one half each; item i is row tile i % tiles of chain
// group i / tiles, and its chain j is prompt (i / tiles) * chain_a + j *
// chain_b. A team loads an item's tile (and its tokens when the chain group
// changes) into its own slot, then computes it, while the other team does
// the same: the load of one overlaps the products of the other.
template <int kNP, bool kPre>
__global__ void __launch_bounds__(kMmaThreads, 1)
i2t_mma_kernel(const bf16* __restrict__ keys, const bf16* __restrict__ peq,
               const bf16* __restrict__ tok_k, const bf16* __restrict__ tok_v,
               const bf16* __restrict__ wq, const float* __restrict__ bq,
               const bf16* __restrict__ wout, const float* __restrict__ bout,
               const bf16* __restrict__ nw, const bf16* __restrict__ nb,
               bf16* __restrict__ out, int n, int ntok, float scale,
               float eps, long long key_stride, long long key_img_stride,
               long long peq_img_stride, int ppi, int chain_a, int chain_b,
               int groups) {
  using L = MmaSmem<kNP, kPre>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sm = (bf16*)smem_raw;
  bf16* wo_s = sm;
  bf16* wq_s = sm + L::kWq;
  float* bq_s = (float*)(sm + L::kVec);
  float* bo_s = bq_s + kI;
  bf16* nw_s = (bf16*)(bo_s + kC);
  bf16* nb_s = nw_s + kC;

  const int tid = threadIdx.x;
  const int team = tid / kTeamThreads, tt = tid % kTeamThreads;
  bf16* slot = sm + L::kSlots + team * L::kSlot;
  bf16* tok_s = sm + L::kTok + team * L::kTeamTok;
  const int tiles = (n + kItemRows - 1) / kItemRows;
  const int items = groups * tiles;
  const int i0 = (int)((long long)items * blockIdx.x / gridDim.x);
  const int i1 = (int)((long long)items * (blockIdx.x + 1) / gridDim.x);
  const int mid = (i0 + i1 + 1) / 2;

  // weights once a block, in the column blocks the warpgroup products read
  wg::load_rows<kC, kI, kMmaThreads>(wo_s, wout, kC, 0, kI, kC);
  if (!kPre) wg::load_rows<kI, kC, kMmaThreads>(wq_s, wq, kI, 0, kC, kI);
  mma::cp_async_commit();
  for (int i = tid; i < kI; i += kMmaThreads) bq_s[i] = bq[i];
  for (int i = tid; i < kC; i += kMmaThreads) {
    bo_s[i] = bout[i];
    nw_s[i] = nw[i];
    nb_s[i] = nb[i];
  }
  mma::cp_async_wait<0>();
  wg::proxy_fence();
  __syncthreads();

  int staged = -1;   // the chain group whose tokens the team holds
  const int s_end = (team ? i1 : mid) * kNP;
  for (int s = (team ? mid : i0) * kNP; s < s_end; ++s) {
    const int item = s / kNP;
    const int grp = item / tiles;
    const int j = s % kNP;
    const int q = grp * chain_a + j * chain_b;
    const int img = q / ppi;
    const int r0 = (item % tiles) * kItemRows;
    if (grp != staged) {
#pragma unroll
      for (int c = 0; c < kNP; ++c) {
        const int qc = grp * chain_a + c * chain_b;
        bf16* dst = tok_s + c * 2 * kTokElems;
        mma::load_rows<kI, 16, kTeamThreads>(
            dst, tok_k + (long long)qc * ntok * kI, kI, 0, ntok, kI, tt);
        mma::load_rows<kI, 16, kTeamThreads>(dst + kTokElems,
                                             tok_v + (long long)qc * ntok * kI,
                                             kI, 0, ntok, kI, tt);
      }
      staged = grp;
    }
    mma::load_rows<kC, kItemRows, kTeamThreads>(
        slot, keys + q * key_stride + img * key_img_stride, kC, r0, n, kC,
        tt);
    if (kPre)
      mma::load_rows<kI, kItemRows, kTeamThreads>(
          slot + L::kKeyElems, peq + img * peq_img_stride, kI, r0, n, kI,
          tt);
    mma::cp_async_commit();
    // the team's next key tile on its way to L2 while this one is computed
    if (tt == 0 && s + 1 < s_end) {
      const int nitem = (s + 1) / kNP;
      const int nq = nitem / tiles * chain_a + (s + 1) % kNP * chain_b;
      const int nr0 = nitem % tiles * kItemRows;
      prefetch_l2(keys + nq * key_stride + nq / ppi * key_img_stride +
                      (long long)nr0 * kC,
                  min(kItemRows, n - nr0) * kC * (int)sizeof(bf16));
    }
    mma::cp_async_wait<0>();
    team_sync(team);   // the tile and the tokens have landed
    const bf16* tk = tok_s + j * 2 * kTokElems;
    i2t_item<kPre>(slot, tk, tk + kTokElems, wq_s, wo_s, bq_s, bo_s, nw_s,
                   nb_s, peq, out, q, r0, n, ntok, scale, eps);
    team_sync(team);   // every warp is done with the slot and the tokens
  }
}

template <int kNP, bool kPre>
int launch_mma(const void* keys, const void* peq, const void* tok_k,
               const void* tok_v, const void* wq, const float* bq,
               const void* wout, const float* bout, const void* nw,
               const void* nb, void* out, int P, int n, int ntok,
               float scale, float eps, long long key_stride,
               long long key_img_stride, long long peq_img_stride, int ppi,
               int chain_a, int chain_b, cudaStream_t stream) {
  const size_t smem = MmaSmem<kNP, kPre>::kBytes;
  auto kern = i2t_mma_kernel<kNP, kPre>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int groups = P / kNP;
  const long long items =
      (long long)groups * ((n + kItemRows - 1) / kItemRows);
  // two teams a block: at most one block an SM, and no idle team
  const long long want = (items + 1) / 2;
  const int grid = (int)(want < sms ? want : sms);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      (const bf16*)keys, (const bf16*)peq, (const bf16*)tok_k,
      (const bf16*)tok_v, (const bf16*)wq, bq, (const bf16*)wout, bout,
      (const bf16*)nw, (const bf16*)nb, (bf16*)out, n, ntok, scale, eps,
      key_stride, key_img_stride, peq_img_stride, ppi, chain_a, chain_b,
      groups);
  return (int)cudaGetLastError();
}

template <int kNP, typename... A>
int launch_mma_pre(int pre, A... a) {
  return pre ? launch_mma<kNP, true>(a...) : launch_mma<kNP, false>(a...);
}

// Shapes both bodies take; the chains of block / work item b: prompt
// b * chain_a + j * chain_b, j < kNP.
bool bad_shape(int P, int n, int heads, int ntok, int ppi, int pair) {
  return heads != kH || ntok < 1 || ntok > 16 || n < 1 || ppi < 1 ||
         pair < 0 || pair > 2 || (pair && P % 2) ||
         (pair == 2 && P != 2 * ppi);
}

}  // namespace

// keys: [Pk, n, 256]; tok_k, tok_v: [P, T, 128]; wq: [256, 128]; bq: float
// [128]; wout: [128, 256]; bout: float [256]; nw, nb: [256]; out:
// [P, n, 256]. Per-prompt keys (pre == 0): Pk == P, key_stride = n * 256,
// peq: [n, 128] the pre-projected positional term, the image strides 0.
// Shared keys (pre != 0): Pk images of ppi prompts each, key_stride = 0,
// key_img_stride = n * 256, peq: [Pk, n, 128] the scaled, rounded qi with
// peq_img_stride = n * 128. pair: 0 for one prompt an item; 1 for two
// prompts an item (2b, 2b + 1; P even); 2 for an image pair (prompt b of
// image 0 and of image 1; P = 2 * ppi). bf16 takes the register-tile
// kernel (any n >= 1), float32 the first port's body (n % 8 == 0; its last
// 32-row tile may be part full).
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
  if (bad_shape(P, n, heads, ntok, ppi, pair) ||
      (dtype != NTTT_DTYPE_BF16 && n % 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int chain_a = pair == 1 ? 2 : 1;
  const int chain_b = pair == 2 ? ppi : 1;
  if (dtype == NTTT_DTYPE_BF16) {
    if (pair)
      return launch_mma_pre<2>(pre, keys, peq, tok_k, tok_v, wq, bq, wout,
                               bout, nw, nb, out, P, n, ntok, scale, eps,
                               key_stride, key_img_stride, peq_img_stride,
                               ppi, chain_a, chain_b, s);
    return launch_mma_pre<1>(pre, keys, peq, tok_k, tok_v, wq, bq, wout,
                             bout, nw, nb, out, P, n, ntok, scale, eps,
                             key_stride, key_img_stride, peq_img_stride, ppi,
                             chain_a, chain_b, s);
  }
  return launch_np<float, false>(
      pair, keys, peq, tok_k, tok_v, wq, bq, wout, bout, nw, nb, out, P, n,
      ntok, scale, eps, pre, key_stride, key_img_stride, peq_img_stride, ppi,
      chain_a, chain_b, s);
}

// The first port's body for either dtype, arguments as `nttt_i2t_norm`
// (n % 8 == 0): the parent the bf16 kernel is checked and timed against.
extern "C" int nttt_i2t_norm_wmma(const void* keys, const void* peq,
                                  const void* tok_k, const void* tok_v,
                                  const void* wq, const float* bq,
                                  const void* wout, const float* bout,
                                  const void* nw, const void* nb, void* out,
                                  int P, int n, int heads, int ntok,
                                  float scale, float eps, int pre,
                                  long long key_stride,
                                  long long key_img_stride,
                                  long long peq_img_stride, int ppi,
                                  int pair, int dtype, void* stream) {
  if (bad_shape(P, n, heads, ntok, ppi, pair) || n % 8)
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
